"""Twins of ``tests/test_tunneler.py`` on the port: the authenticated byte
relay, its health cache, HTTP over the tunnel and the apiserver's node
proxy riding it.

Each case runs the JAX test through both packages (``tests/torch_twin``):
both pass its assertions and leave equal stores."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_tunneler"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)
