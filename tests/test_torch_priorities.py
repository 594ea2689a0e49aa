"""Twins of ``tests/test_priorities.py``.

Each JAX test runs through both packages (``tests/torch_twin``): both
pass its assertions and leave equal stores."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_priorities"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)
