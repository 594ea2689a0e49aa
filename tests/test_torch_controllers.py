"""Twins of ``tests/test_controllers.py`` on the port's controllers:
ReplicaSets, Deployments (rolling and recreate), the garbage collector,
the node lifecycle controller and the full control-plane lifecycle.

Each case runs the JAX test through both packages (``tests/torch_twin``)
with lazy informer decode on and off: both pass its assertions and leave
equal stores (ReplicaSet names are template hashes, pod names the
controllers' counters; both must equal the JAX package's)."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_controllers"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, lazy, tmp_path):
    twin(NAME, test, tmp_path, lazy=lazy)
