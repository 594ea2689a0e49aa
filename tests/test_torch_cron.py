"""Twins of ``tests/test_cron.py`` on the port: the cron schedule parser and a job deadline
across a controller restart.

Each case runs the JAX test through both packages (``tests/torch_twin``):
both pass its assertions and leave equal stores."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_cron"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)
