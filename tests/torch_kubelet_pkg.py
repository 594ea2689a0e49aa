"""The kubelet modules of one package, for the kubelet twins
(``tests/test_torch_kubelet_*.py``, ``test_torch_cri.py``,
``test_torch_network.py``, ``test_torch_hollow.py``).

``pkg("jax")`` and ``pkg("port")`` hold the same names; ``both(scenario)``
runs one scenario on each and asserts that the outcomes are equal."""

from __future__ import annotations

import importlib
import types

_MODULES = {
    "api": "api",
    "types": "api.types",
    "clientset": "client.clientset",
    "store_mod": "store.store",
    "cm": "kubelet.cm",
    "runtime": "kubelet.runtime",
    "network": "kubelet.network",
    "cri": "kubelet.cri",
    "containers": "kubelet.containers",
    "volumehost": "kubelet.volumehost",
    "hollow": "kubelet.hollow",
    "kubelet_main": "kubelet.__main__",
    "hyperkube": "__main__",
    "authn": "auth.authn",
    "features": "utils.features",
    "testutil": "testutil",
}


def pkg(which: str) -> types.SimpleNamespace:
    root = "kubernetes_tpu" if which == "jax" else "kubernetes_tpu_torch"
    ns = types.SimpleNamespace(name=which, root=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.Clientset = ns.clientset.Clientset
    ns.Store = ns.store_mod.Store
    ns.HollowKubelet = ns.hollow.HollowKubelet
    ns.HollowFleet = ns.hollow.HollowFleet
    ns.make_pod = ns.testutil.make_pod
    ns.make_node = ns.testutil.make_node
    return ns


def both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` on the JAX package, then on the port; the
    two outcomes must be equal.  Returns the port's."""
    jax_out = scenario(pkg("jax"), *args, **kw)
    port_out = scenario(pkg("port"), *args, **kw)
    assert port_out == jax_out
    return port_out


class FakeClock:
    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt
