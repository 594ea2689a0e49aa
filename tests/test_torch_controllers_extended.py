"""Twins of ``tests/test_controllers_extended.py`` on the port: jobs, cronjobs, DaemonSets, StatefulSets,
endpoints, namespaces, quota, pod GC, TTL, disruption budgets, the HPA,
service accounts, certificates and the controller manager's extended set.

Each case runs the JAX test through both packages (``tests/torch_twin``),
with lazy informer decode on and off:
both pass its assertions and leave equal stores."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_controllers_extended"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, lazy, tmp_path):
    twin(NAME, test, tmp_path, lazy=lazy)
