"""Twins of ``tests/test_taint_manager.py`` on the port: the NoExecute taint manager and the node
lifecycle controller's failure taints.

Each case runs the JAX test through both packages (``tests/torch_twin``),
with lazy informer decode on and off:
both pass its assertions and leave equal stores."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_taint_manager"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, lazy, tmp_path):
    twin(NAME, test, tmp_path, lazy=lazy)
