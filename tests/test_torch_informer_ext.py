"""Twins of the JAX tests of the informer's cache mutation detector
(``test_client.py::test_mutation_detector``,
``test_lazy.py::test_mutation_detector_still_works_with_lazy_objects``),
of ``compact_on_resync``
(``test_watch_frames.py::test_compact_on_resync_flag_sweeps_after_relist``)
and of ``PodOwnerIndex`` on the port's informer.  Each scenario runs
through both packages (``both``) and the outcomes must be equal; the
detector's runs go with lazy decode on and off.  (Those JAX modules also
import parts the port does not have, so they are not run whole.)"""

from __future__ import annotations

import importlib

import pytest

from tests.torch_kubelet_pkg import both
from tests.torch_twin import ROOTS, _lazy


def _informer(P):
    return importlib.import_module(f"{ROOTS[P.name]}.client.informer")


def _rich_pod(P, name, owner=None):
    api = P.api
    pod = P.make_pod(name, cpu="100m", memory="64Mi", labels={"app": "web", "tier": "x"},
                     owner_refs=owner)
    pod.meta.annotations = {"note": "n"}
    pod.spec.tolerations = [api.Toleration(key="k", operator="Exists")]
    return pod


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
@pytest.mark.parametrize("tamper", [True, False], ids=["tampered", "untouched"])
def test_mutation_detector_fails_on_a_mutated_cache_object(lazy, tamper):
    def scenario(P):
        inf_mod = _informer(P)
        cs = P.Clientset(P.Store())
        cs.pods.create(_rich_pod(P, "p1"))
        inf = inf_mod.SharedInformer(cs.pods, mutation_detector=True)
        inf.start_manual()
        if tamper:
            inf.get("default/p1").spec.node_name = "EVIL"
        cs.pods.create(_rich_pod(P, "p2"))
        cs.pods.bind(P.api.Binding(pod_namespace="default", pod_name="p1", node_name="n1"))
        try:
            n = inf.pump()
        except inf_mod.CacheMutationError as e:
            return "raised", str(e)
        return "applied", n, inf.get("default/p1").spec.node_name

    with _lazy(lazy):
        out = both(scenario)
    assert out[0] == ("raised" if tamper else "applied")


def test_mutation_detector_through_the_factory_and_a_relist():
    def scenario(P):
        inf_mod = _informer(P)
        cs = P.Clientset(P.Store())
        cs.pods.create(_rich_pod(P, "p1"))
        factory = inf_mod.InformerFactory(cs, mutation_detector=True)
        inf = factory.informer("Pod")
        factory.start_all_manual()
        inf.relist()  # the snapshots follow the relisted cache
        inf.get("default/p1").meta.labels["app"] = "tampered"
        cs.pods.delete("p1", "default")
        with pytest.raises(inf_mod.CacheMutationError):
            factory.pump_all()
        return "raised"

    both(scenario)


def test_compact_on_resync_sweeps_after_each_relist():
    def scenario(P):
        inf_mod = _informer(P)
        cs = P.Clientset(P.Store())
        cs.pods.create_many([P.make_pod(f"p{i}", cpu="100m") for i in range(4)])
        inf = inf_mod.SharedInformer(P.Clientset(cs.store).pods, compact_on_resync=True)
        inf.start_manual()
        before = all(inf.get(k).raw is not None for k in inf.keys())
        c0 = inf.metrics.informer_compactions.value
        inf.relist()
        first = (all(inf.get(k).raw is None for k in inf.keys()), inf.stats["compactions"],
                 inf.metrics.informer_compactions.value - c0)
        inf.resync()  # the reference's resyncPeriod: the same relist
        second = inf.metrics.informer_compactions.value - c0
        off = inf_mod.SharedInformer(P.Clientset(cs.store).pods)
        off.start_manual()
        off.relist()
        return before, first, second, all(off.get(k).raw is not None for k in off.keys())

    with _lazy(True):
        assert both(scenario) == (True, (True, 4, 4), 8, True)


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_pod_owner_index_tracks_owners_and_orphans(lazy):
    def scenario(P):
        inf_mod = _informer(P)
        api = P.api
        cs = P.Clientset(P.Store())
        inf = inf_mod.SharedInformer(cs.pods)
        index = inf_mod.PodOwnerIndex(inf)
        ref = [api.OwnerReference(kind="ReplicaSet", name="rs", uid="u1", controller=True)]
        for i in range(3):
            cs.pods.create(_rich_pod(P, f"own{i}", owner=ref))
        cs.pods.create(_rich_pod(P, "orphan"))
        inf.start_manual()
        seen = [sorted(p.meta.name for p in index.owned_by("u1")),
                sorted(p.meta.name for p in index.orphans_in("default"))]

        def _adopt(p):
            p.meta.owner_references = [api.OwnerReference(kind="ReplicaSet", name="rs",
                                                          uid="u1", controller=True)]
            return p

        cs.pods.guaranteed_update("orphan", _adopt, "default")
        for i in range(3):
            cs.pods.delete(f"own{i}", "default")
        inf.pump()
        seen += [sorted(p.meta.name for p in index.owned_by("u1")),
                 sorted(p.meta.name for p in index.orphans_in("default")),
                 sorted(index._by_owner), sorted(index._orphans)]
        return seen

    with _lazy(lazy):
        assert both(scenario) == [["own0", "own1", "own2"], ["orphan"], ["orphan"], [],
                                  ["u1"], []]
