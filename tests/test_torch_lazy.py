"""Lazy decode (``kubernetes_tpu_torch/api/lazy.py``) and its raw readers,
held against the port's own typed path and against the JAX package's
``kubernetes_tpu.api.lazy`` on the same objects and seeded batches.

The contract: a lazy view over a wire dict is indistinguishable from
``cls.from_dict`` of that dict, after promotion and after mutation of a
promoted section, and every raw reader (signature and content keys,
request vectors, host ports, affinity probes, ``pod_brief``) equals its
typed twin, in both packages alike.

Tolerance: exact equality.
"""

from __future__ import annotations

import copy
import importlib
import random
import threading

import pytest

from kubernetes_tpu_torch.api import lazy as lazy_mod
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.client.informer import Handler, SharedInformer
from kubernetes_tpu_torch.scheduler.units import pod_request_vec
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testutil import make_pod
from tests import torch_port_cases as cases

PKGS = (cases.JAX, cases.PORT)


def _m(pkg: str, mod: str):
    return importlib.import_module(f"{pkg}.{mod}")


def rich_pod(pkg: str, i: int = 0):
    """Every costly ``from_dict`` branch: affinity, tolerations, disk and
    PVC volumes, host ports, requests, an owner reference."""
    A = _m(pkg, "api")
    aff = A.Affinity(
        pod_affinity_preferred=[A.WeightedPodAffinityTerm(
            weight=7, term=A.PodAffinityTerm(
                selector=A.LabelSelector.from_match_labels({"app": "web"}), topology_key="zone"))],
        pod_anti_affinity_required=[A.PodAffinityTerm(
            selector=A.LabelSelector.from_match_labels({"app": "db"}),
            topology_key="kubernetes.io/hostname")])
    pod = _m(pkg, "testutil").make_pod(
        f"rich-{i}", cpu="250m", memory="512Mi", labels={"app": "web", "tier": str(i)},
        node_selector={"disk": "ssd"},
        tolerations=[A.Toleration(key="dedicated", operator="Exists")],
        host_ports=[8000 + i], affinity=aff,
        volumes=[A.Volume(name="d", disk_id=f"pd-{i}", disk_kind="gce-pd"),
                 A.Volume(name="c", pvc_name="claim-0")],
        owner_refs=[A.OwnerReference(kind="ReplicaSet", name="rs", uid="uid-rs",
                                     controller=True)])
    pod.spec.priority = 3
    return pod


def sample_objects(pkg: str) -> list:
    """One object of each kind the port's informers carry."""
    A, tu = _m(pkg, "api"), _m(pkg, "testutil")
    return [
        rich_pod(pkg), tu.make_pod("plain", cpu="100m", memory="128Mi"),
        tu.make_node("n0", cpu="8", memory="16Gi", pods=110,
                     labels={"kubernetes.io/hostname": "n0", "zone": "z1"}),
        A.Service(meta=A.ObjectMeta(name="web"), selector={"app": "web"},
                  ports=[A.ServicePort(name="http", port=80, target_port=8080)]),
        A.ReplicaSet(meta=A.ObjectMeta(name="rs"), replicas=3, status_replicas=7,
                     selector=A.LabelSelector.from_match_labels({"app": "web"})),
        A.PersistentVolume(meta=A.ObjectMeta(name="pv0", namespace="")),
        A.PersistentVolumeClaim(meta=A.ObjectMeta(name="claim-0")),
    ]


def roundtrip(pkg: str, obj) -> dict:
    """The wire form a lazy view sees: through the package's store, so
    uid and resourceVersion are set."""
    A = _m(pkg, "api.types")
    d = obj.to_dict()
    d.setdefault("metadata", {}).setdefault(
        "namespace", "" if obj.KIND in A.CLUSTER_SCOPED_KINDS else "default")
    return _m(pkg, "store").Store().create(obj.KIND, d)


def _strip_uid(d: dict) -> dict:
    d = copy.deepcopy(d)
    d["metadata"].pop("uid", None)
    return d


@pytest.mark.parametrize("idx", range(7), ids=["rich_pod", "pod", "node", "service",
                                                "replicaset", "pv", "pvc"])
def test_promotion_equals_from_dict_in_both_packages(idx):
    wires = {}
    for pkg in PKGS:
        obj = sample_objects(pkg)[idx]
        raw = roundtrip(pkg, obj)
        cls = type(obj)
        eager = cls.from_dict(copy.deepcopy(raw))
        lazy = _m(pkg, "api.lazy").wrap(cls, raw)
        assert isinstance(lazy, cls)
        assert lazy.meta.key == eager.meta.key  # partial access first
        assert lazy.to_dict() == eager.to_dict()
        assert lazy == eager and eager == lazy
        wires[pkg] = _strip_uid(lazy.to_dict())
    assert wires[cases.PORT] == wires[cases.JAX]


def test_from_dict_on_a_lazy_class_builds_eager_objects():
    for obj in (rich_pod(cases.PORT), api.Service(meta=api.ObjectMeta(name="s"))):
        raw = roundtrip(cases.PORT, obj)
        lazy = lazy_mod.wrap(type(obj), raw)
        rebuilt = type(lazy).from_dict(copy.deepcopy(raw))
        assert type(rebuilt) is type(obj) and rebuilt == lazy


def test_generic_wrapper_promotes_on_scalar_default_fields():
    rs = api.ReplicaSet(meta=api.ObjectMeta(name="rs"), replicas=3, status_replicas=7,
                        status_ready_replicas=2)
    lazy = lazy_mod.wrap(api.ReplicaSet, roundtrip(cases.PORT, rs))
    assert lazy.status_replicas == 7  # its dataclass default is 0
    assert lazy.status_ready_replicas == 2 and lazy.replicas == 3


def test_lazy_pod_sections_decode_independently():
    pod = lazy_mod.wrap(api.Pod, roundtrip(cases.PORT, rich_pod(cases.PORT)))
    assert pod.spec.node_name == "" and pod.spec.scheduler_name == "default-scheduler"
    assert "containers" not in pod.spec.__dict__ and "affinity" not in pod.spec.__dict__
    assert lazy_mod.pod_brief(pod) == ("", "default-scheduler", api.PENDING)
    c1 = pod.spec.containers
    assert c1 is pod.spec.containers
    assert pod.spec.affinity.pod_anti_affinity_required[0].topology_key == "kubernetes.io/hostname"


def test_mutation_after_promotion_is_authoritative():
    from kubernetes_tpu_torch.api.quantity import Quantity

    pod = lazy_mod.wrap(api.Pod, roundtrip(cases.PORT, rich_pod(cases.PORT)))
    pod.spec.containers[0].resources.requests["cpu"] = Quantity("500m")
    pod.spec.node_name = "n9"
    assert pod.to_dict()["spec"]["nodeName"] == "n9"
    assert str(pod.to_dict()["spec"]["containers"][0]["resources"]["requests"]["cpu"]) == "500m"
    assert lazy_mod.undecoded_spec(pod) is None  # the raw dict is no longer consulted
    assert lazy_mod.pod_brief(pod)[0] == "n9"
    assert pod_request_vec(pod).units == pod_request_vec(api.Pod.from_dict(pod.to_dict())).units
    svc = lazy_mod.wrap(api.Service, roundtrip(cases.PORT, api.Service(
        meta=api.ObjectMeta(name="s"), selector={"app": "x"})))
    svc.selector["app"] = "y"
    assert svc.to_dict()["spec"]["selector"] == {"app": "y"}


def _raw_readers(pkg: str, pod, raw) -> dict:
    snap = _m(pkg, "models.snapshot")
    units = _m(pkg, "scheduler.units")
    lz = _m(pkg, "api.lazy")
    return {
        "raw_sig": snap.raw_pod_signature_key(raw),
        "sig": snap.pod_signature_key(pod),
        "content": snap._pod_content_key(pod),
        "req": units.pod_request_vec(pod).units,
        "nz": units.pod_nonzero_request_vec(pod).units,
        "ports": pod.host_ports(),
        "affinity": _m(pkg, "scheduler.nodeinfo").pod_has_affinity(pod),
        "terms": snap.count_affinity_terms(pod),
        "disks": snap.pod_disk_vols(pod),
        "brief": lz.pod_brief(pod),
        "labels_ns": lz.labels_ns_of(pod),
        "rv": lz.resource_version_of(pod),
    }


def _seeded_pods(pkg: str, seed: int) -> list:
    """Rich pods plus a seeded ``mixed`` wave (the churn generator)."""
    # the JAX package's generator lives in bench.py, the port's copy in workload
    gen = _m(pkg, "workload") if pkg == cases.PORT else importlib.import_module("bench")
    made = gen.make_pods(40, random.Random(seed), "mixed")
    tu = _m(pkg, "testutil")
    return [rich_pod(pkg, seed), tu.make_pod(f"noreq-{seed}"), *made]


@pytest.mark.parametrize("seed", range(3))
def test_raw_readers_equal_typed_readers_in_both_packages(seed):
    port_pods = _seeded_pods(cases.PORT, seed)
    got = {}
    for pkg, pods in ((cases.PORT, port_pods), (cases.JAX, _seeded_pods(cases.JAX, seed))):
        L = _m(pkg, "api.lazy")
        out = []
        for src in pods:
            raw = roundtrip(pkg, src)
            eager = type(src).from_dict(copy.deepcopy(raw))
            lazy = L.wrap(type(src), raw)
            typed = _raw_readers(pkg, eager, raw)
            fast = _raw_readers(pkg, lazy, raw)
            assert fast == typed, pkg
            assert typed["raw_sig"] == typed["sig"]
            # no reader decoded the costly spec fields
            assert L.undecoded_spec(lazy) is not None
            out.append({k: v for k, v in typed.items() if k != "rv"})
        got[pkg] = out
    assert len(got[cases.PORT]) == len(got[cases.JAX])
    assert got[cases.PORT] == got[cases.JAX]


def test_concurrent_promotion_installs_one_object():
    """Informer threads share cached objects: of readers that race on a
    section, every one gets the same decoded object."""
    pod = lazy_mod.wrap(api.Pod, roundtrip(cases.PORT, rich_pod(cases.PORT)))
    spec = pod.spec
    seen, barrier = [], threading.Barrier(8)

    def read():
        barrier.wait()
        seen.append(spec.containers)

    threads = [threading.Thread(target=read) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 8 and all(c is spec.containers for c in seen)


def _informer_world():
    cs = Clientset(Store())
    cs.pods.create(rich_pod(cases.PORT, 0))
    return cs


def test_informer_delivers_lazy_views_and_isolates_handler_crashes():
    cs = _informer_world()
    inf = SharedInformer(cs.pods)
    peer = []

    def crash(_obj):
        raise RuntimeError("boom on decode-in-handler")

    inf.add_handler(Handler(on_add=crash))
    inf.add_handler(Handler(on_add=peer.append))
    inf.start_manual()
    assert inf.stats["handler_errors"] >= 1
    assert len(peer) == 1 and isinstance(peer[0], api.Pod) and peer[0].raw is not None
    cs.pods.create(rich_pod(cases.PORT, 1))
    inf.pump()
    assert len(peer) == 2 and inf.stats["handler_errors"] >= 2
    assert sorted(p.meta.key for p in inf.list()) == ["default/rich-0", "default/rich-1"]


def test_eager_path_restores_from_dict(monkeypatch):
    monkeypatch.setattr(lazy_mod, "ENABLED", False)
    cs = _informer_world()
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    assert type(inf.list()[0]) is api.Pod
    cs.pods.create(rich_pod(cases.PORT, 1))
    inf.pump()
    assert all(type(o) is api.Pod for o in inf.list())
    assert type(cs.pods.get("rich-1")) is api.Pod


def test_undecodable_payload_marks_a_gap_and_relist_heals():
    cs = _informer_world()
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    # a payload whose spec section is not a dict cannot be wrapped
    bad = roundtrip(cases.PORT, rich_pod(cases.PORT, 5))
    bad["spec"] = "garbage"
    from kubernetes_tpu_torch.store.store import ADDED, WatchEvent

    inf._watch._queue.put(WatchEvent(ADDED, "Pod", "default/rich-5", 10**6, bad))
    inf.pump()
    assert inf.stats["decode_errors"] == 1 and inf._gap_pending
    cs.pods.create(rich_pod(cases.PORT, 2))
    inf.pump()  # the pending gap relists first
    assert inf.stats["relists"] == 1 and not inf._gap_pending
    assert inf.get("default/rich-2") is not None


def test_store_column_batch_matches_list_and_the_reference():
    batches = {}
    for pkg in PKGS:
        cs = _m(pkg, "client").Clientset(_m(pkg, "store").Store())
        for i in range(5):
            cs.pods.create(rich_pod(pkg, i))
        cs.pods.create(_m(pkg, "testutil").make_pod("plain", cpu="100m", memory="128Mi"))
        dicts, rev = cs.store.list("Pod")
        batch = cs.store.list_columns("Pod")
        assert batch.revision == rev
        assert batch.keys == [f"{d['metadata']['namespace']}/{d['metadata']['name']}"
                              for d in dicts]
        cls = type(rich_pod(pkg))
        snap, units = _m(pkg, "models.snapshot"), _m(pkg, "scheduler.units")
        for pod, d in zip(batch.pods(), dicts):
            eager = cls.from_dict(d)
            assert pod == eager
            assert snap.pod_signature_key(pod) == snap.pod_signature_key(eager)
        for i, d in enumerate(dicts):
            eager = cls.from_dict(d)
            assert list(batch.req_units[i]) == units.pod_request_vec(eager).units
            assert list(batch.nonzero_units[i]) == units.pod_nonzero_request_vec(eager).units[:2]
        batches[pkg] = batch
    a, b = batches[cases.PORT], batches[cases.JAX]
    assert a.keys == b.keys and a.sig_keys == b.sig_keys
    assert a.sig_ids.tolist() == b.sig_ids.tolist()
    assert a.req_units.tolist() == b.req_units.tolist()
    assert a.nonzero_units.tolist() == b.nonzero_units.tolist()


def test_store_column_batch_is_isolated_from_later_writes():
    cs = Clientset(Store())
    cs.pods.create(make_pod("a", cpu="100m", memory="128Mi"))
    batch = cs.store.list_columns("Pod")
    assert batch.node_names == [""]
    cs.pods.bind(api.Binding(pod_namespace="default", pod_name="a", node_name="n1"))
    assert batch.raw[0]["spec"].get("nodeName", "") == ""
    assert batch.pods()[0].spec.node_name == ""


def test_seed_and_relist_take_the_column_batch():
    cs = _informer_world()
    calls = []
    real = cs.store.list_columns

    def spy(kind="Pod", namespace=None):
        calls.append(kind)
        return real(kind, namespace)

    cs.store.list_columns = spy
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    inf.relist()
    assert calls == ["Pod", "Pod"]
    assert type(inf.get("default/rich-0")) is lazy_mod.LazyPod
    assert "_sig_key" in inf.get("default/rich-0").__dict__  # pre-seeded by the batch
