"""The port's store, clientset, informer and event recorder
(``kubernetes_tpu_torch.store`` / ``.client``) against the JAX package's.

Twins of the ``tests/test_store.py`` and ``tests/test_record.py`` cases
this slice ports, plus cross-package checks: the same object gives the
same wire dict in both packages (``uid`` and revisions masked, since each
process mints its own), the same writes give the same watch event
sequence, and the same event stream correlates into the same Event
objects.  Tolerance: exact equality."""

from __future__ import annotations

import importlib
import threading
import time

import pytest

from kubernetes_tpu_torch.api import Node, ObjectMeta, Pod
from kubernetes_tpu_torch.client import Clientset, EventBroadcaster, EventCorrelator, Handler
from kubernetes_tpu_torch.client.informer import SharedInformer
from kubernetes_tpu_torch.store import (
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    Store,
)
from tests import torch_port_cases as cases


def make_pod_dict(name, ns="default"):
    return Pod(meta=ObjectMeta(name=name, namespace=ns)).to_dict()


# -- the store (twins of tests/test_store.py) -------------------------------


def test_create_assigns_uid_and_revision():
    s = Store()
    obj = s.create("Pod", make_pod_dict("p1"))
    assert obj["metadata"]["uid"]
    assert obj["metadata"]["resourceVersion"] == 1
    assert s.create("Pod", make_pod_dict("p2"))["metadata"]["resourceVersion"] == 2


def test_create_duplicate_fails():
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    with pytest.raises(AlreadyExistsError):
        s.create("Pod", make_pod_dict("p1"))


def test_get_is_deep_copy():
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    a = s.get("Pod", "default", "p1")
    a["spec"]["nodeName"] = "mutated"
    assert s.get("Pod", "default", "p1")["spec"]["nodeName"] == ""


def test_cas_update_conflict():
    s = Store()
    obj = s.create("Pod", make_pod_dict("p1"))
    obj["spec"]["nodeName"] = "n1"
    s.update("Pod", obj)  # ok at rev 1
    obj["spec"]["nodeName"] = "n2"
    with pytest.raises(ConflictError):
        s.update("Pod", obj)  # still claims rev 1


def test_guaranteed_update_retries(monkeypatch):
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    calls = {"n": 0}
    real_update = s.update

    def flaky_update(kind, obj, expect_rev=None, _trusted=False):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConflictError("simulated concurrent writer")
        return real_update(kind, obj, expect_rev=None)

    monkeypatch.setattr(s, "update", flaky_update)

    def mutate(d):
        d["spec"]["nodeName"] = "n1"
        return d

    out = s.guaranteed_update("Pod", "default", "p1", mutate)
    assert out["spec"]["nodeName"] == "n1"
    assert calls["n"] == 2


@pytest.mark.timeout(60)
def test_guaranteed_update_concurrent_writers_lose_nothing():
    """Eight threads each add 25 to one counter through the CAS loop, with
    a short switch interval: a lost update would leave the sum short."""
    import sys

    s = Store()
    s.create("Pod", {"metadata": {"name": "c"}, "spec": {}, "status": {"n": 0}})

    def bump(d):
        d["status"]["n"] += 1
        return d

    def writer():
        for _ in range(25):
            s.guaranteed_update("Pod", "default", "c", bump)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer, daemon=True) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert s.get("Pod", "default", "c")["status"]["n"] == 200


def test_delete_and_not_found():
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    s.delete("Pod", "default", "p1")
    with pytest.raises(NotFoundError):
        s.get("Pod", "default", "p1")
    with pytest.raises(NotFoundError):
        s.delete("Pod", "default", "p1")


def test_delete_with_finalizers_marks_then_update_finishes():
    s = Store()
    obj = make_pod_dict("guarded")
    obj["metadata"]["finalizers"] = ["test/finalizer"]
    s.create("Pod", obj)
    w = s.watch("Pod")
    marked = s.delete("Pod", "default", "guarded")
    assert marked["metadata"]["deletionRevision"]
    got = s.get("Pod", "default", "guarded")
    got["metadata"]["finalizers"] = []
    s.update("Pod", got)
    with pytest.raises(NotFoundError):
        s.get("Pod", "default", "guarded")
    assert [w.get(timeout=1).type for _ in range(2)] == [MODIFIED, DELETED]
    w.stop()


def test_list_returns_revision_for_watch():
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    objs, rev = s.list("Pod")
    assert len(objs) == 1 and rev == 1
    s.create("Pod", make_pod_dict("p2"))
    objs, rev = s.list("Pod")
    assert len(objs) == 2 and rev == 2


def test_watch_from_revision_replays_backlog():
    s = Store()
    s.create("Pod", make_pod_dict("p1"))
    _, rev = s.list("Pod")
    w = s.watch("Pod", from_revision=rev)
    s.create("Pod", make_pod_dict("p2"))
    obj = s.get("Pod", "default", "p2")
    obj["spec"]["nodeName"] = "n1"
    s.update("Pod", obj)
    s.delete("Pod", "default", "p1")
    evs = [w.get(timeout=1) for _ in range(3)]
    assert [e.type for e in evs] == [ADDED, MODIFIED, DELETED]
    assert evs[0].key == "default/p2"
    assert evs[2].key == "default/p1"
    w.stop()


def test_watch_kind_filtering():
    s = Store()
    w = s.watch("Node", from_revision=0)
    s.create("Pod", make_pod_dict("p1"))
    s.create("Node", Node(meta=ObjectMeta(name="n1", namespace="")).to_dict())
    assert w.get(timeout=1).kind == "Node"
    assert w.get(timeout=0.05) is None
    w.stop()


def test_watch_events_in_revision_order_no_gaps():
    s = Store()
    w = s.watch("Pod", from_revision=0)
    for i in range(10):
        s.create("Pod", make_pod_dict(f"p{i}"))
    revs = [w.get(timeout=1).revision for _ in range(10)]
    assert revs == sorted(revs) and len(set(revs)) == 10
    w.stop()


def test_expired_revision():
    s = Store(event_log_window=2)
    for i in range(5):
        s.create("Pod", make_pod_dict(f"p{i}"))
    with pytest.raises(ExpiredRevisionError):
        s.watch("Pod", from_revision=1)
    # inside the window the replay is exact
    w = s.watch("Pod", from_revision=3)
    assert [w.get(timeout=1).revision for _ in range(2)] == [4, 5]
    w.stop()


def test_create_many_one_txn_semantics():
    s = Store()
    w = s.watch("Pod")
    objs = [{"metadata": {"name": f"p{i}", "namespace": "default"}, "spec": {}}
            for i in range(5)]
    out = s.create_many("Pod", objs)
    assert len(out) == 5 and all(o is not None for o in out)
    revs = [int(o["metadata"]["resourceVersion"]) for o in out]
    assert revs == sorted(revs) and len(set(revs)) == 5
    assert all(o["metadata"]["uid"] for o in out)
    evs = [w.get(timeout=1) for _ in range(5)]
    assert [e.type for e in evs] == [ADDED] * 5
    assert [e.key for e in evs] == [f"default/p{i}" for i in range(5)]
    # a duplicate in the middle: its slot is None, the neighbors commit
    out2 = s.create_many("Pod", [
        {"metadata": {"name": "q0"}, "spec": {}},
        {"metadata": {"name": "p0"}, "spec": {}},
        {"metadata": {"name": "q1"}, "spec": {}},
    ])
    assert out2[0] is not None and out2[1] is None and out2[2] is not None
    assert s.get("Pod", "default", "q1")["metadata"]["name"] == "q1"
    w.stop()


def test_create_many_through_typed_client():
    cs = Clientset(Store())
    created = cs.pods.create_many([cases.mods(cases.PORT).tu.make_pod(f"b{i}", cpu="100m")
                                   for i in range(3)])
    assert [p.meta.name for p in created] == ["b0", "b1", "b2"]
    assert str(created[0].spec.containers[0].resources.requests["cpu"]) == "100m"


def test_bind_many_conflicts_and_not_found():
    """Per-item results: a pod bound elsewhere is a conflict, a rebind to
    the same node succeeds, a missing pod is not found; the rest of the
    batch commits and emits one MODIFIED event per success."""
    s = Store()
    for name in ("a", "b", "c"):
        s.create("Pod", make_pod_dict(name))
    assert s.bind_many([("default", "a", "n1")]) == [None]
    w = s.watch("Pod")
    res = s.bind_many([("default", "a", "n2"), ("default", "a", "n1"),
                       ("default", "zz", "n1"), ("default", "b", "n3"),
                       ("default", "c", "n1")])
    assert res[0] == "conflict: already bound to n1"
    assert res[1] is None and res[2] == "not found"
    assert res[3] is None and res[4] is None
    evs = [w.get(timeout=1) for _ in range(3)]
    assert [(e.type, e.key, e.object["spec"]["nodeName"]) for e in evs] == [
        (MODIFIED, "default/a", "n1"), (MODIFIED, "default/b", "n3"),
        (MODIFIED, "default/c", "n1")]
    assert w.get(timeout=0.05) is None
    # event objects own their spec/metadata: the store's copy is unaffected
    evs[1].object["spec"]["nodeName"] = "mutated"
    assert s.get("Pod", "default", "b")["spec"]["nodeName"] == "n3"
    w.stop()


def test_pod_client_bind_conflict():
    from kubernetes_tpu_torch.api import Binding
    from kubernetes_tpu_torch.client import BindConflictError

    cs = Clientset(Store())
    cs.pods.create(Pod(meta=ObjectMeta(name="p")))
    cs.pods.bind(Binding(pod_name="p", node_name="n1"))
    cs.pods.bind(Binding(pod_name="p", node_name="n1"))  # idempotent
    with pytest.raises(BindConflictError):
        cs.pods.bind(Binding(pod_name="p", node_name="n2"))
    assert cs.pods.get("p").spec.node_name == "n1"


def test_typed_guaranteed_update_and_status():
    cs = Clientset(Store())
    cs.pods.create(Pod(meta=ObjectMeta(name="p", labels={"a": "1"})))

    def relabel(pod):
        pod.meta.labels["b"] = "2"
        return pod

    out = cs.pods.guaranteed_update("p", relabel)
    assert out.meta.labels == {"a": "1", "b": "2"}
    status_only = cs.pods.get("p")
    status_only.status.phase = "Running"
    status_only.meta.labels = {}  # not written: status subresource
    out = cs.pods.update_status(status_only)
    assert out.status.phase == "Running" and out.meta.labels == {"a": "1", "b": "2"}


def test_cluster_scoped_kinds_ignore_namespace():
    cs = Clientset(Store())
    cs.nodes.create(Node(meta=ObjectMeta(name="n1", namespace="default")))
    assert cs.nodes.get("n1").meta.key == "n1"
    assert cs.persistentvolumes.default_namespace == ""
    assert cs.persistentvolumeclaims.default_namespace == "default"


# -- the informer: list/watch, pump, relist --------------------------------


def _recorder():
    seen = []
    return seen, Handler(on_add=lambda o: seen.append(("add", o.meta.key)),
                         on_update=lambda old, new: seen.append(("update", new.meta.key)),
                         on_delete=lambda o: seen.append(("delete", o.meta.key)))


def test_informer_list_watch_pump():
    cs = Clientset(Store())
    cs.pods.create(Pod(meta=ObjectMeta(name="a")))
    inf = SharedInformer(cs.pods)
    seen, h = _recorder()
    inf.add_handler(h)
    inf.start_manual()
    assert seen == [("add", "default/a")] and inf.has_synced()
    cs.pods.create(Pod(meta=ObjectMeta(name="b")))
    cs.pods.bind_many([__import__("kubernetes_tpu_torch.api", fromlist=["Binding"])
                       .Binding(pod_name="a", node_name="n1")])
    cs.pods.delete("b")
    assert inf.pump() == 3
    assert seen[1:] == [("add", "default/b"), ("update", "default/a"), ("delete", "default/b")]
    assert inf.get("default/a").spec.node_name == "n1"
    assert sorted(inf.keys()) == ["default/a"]
    # a handler registered late gets the cache replayed as adds
    late, h2 = _recorder()
    inf.add_handler(h2)
    assert late == [("add", "default/a")]


def test_informer_relist_diffs_missed_deltas():
    """A relist replaces the watch and hands the handlers the difference
    between the old cache and a fresh LIST as adds, updates and deletes;
    the superseded stream's events are dropped, never applied twice."""
    cs = Clientset(Store())
    for name in ("keep", "gone", "moved"):
        cs.pods.create(Pod(meta=ObjectMeta(name=name)))
    inf = SharedInformer(cs.pods)
    seen, h = _recorder()
    inf.add_handler(h)
    inf.start_manual()
    seen.clear()
    cs.pods.delete("gone")
    cs.pods.create(Pod(meta=ObjectMeta(name="new")))
    moved = cs.pods.get("moved")
    moved.meta.labels = {"x": "y"}
    cs.pods.update(moved)
    inf.relist()
    assert sorted(seen) == [("add", "default/new"), ("delete", "default/gone"),
                            ("update", "default/moved")]
    assert inf.pump() == 0  # the old watch's three events are gone
    assert sorted(inf.keys()) == ["default/keep", "default/moved", "default/new"]
    assert inf.stats["relists"] == 1


def test_informer_expired_watch_relists():
    """The window slides past the LIST revision before the WATCH starts
    (``ExpiredRevisionError``): the informer lists again and converges;
    a relist that keeps failing marks the gap and a later pump retries."""
    store = Store(event_log_window=2)
    cs = Clientset(store)
    for i in range(5):
        cs.pods.create(Pod(meta=ObjectMeta(name=f"p{i}")))
    real_watch = store.watch
    calls = {"n": 0}

    def racing_watch(kind=None, from_revision=None, frames=False):
        calls["n"] += 1
        if calls["n"] == 1:
            # a writer lands between LIST and WATCH and slides the window
            for j in range(3):
                store.create("Pod", make_pod_dict(f"late{j}"))
        return real_watch(kind, from_revision, frames=frames)

    store.watch = racing_watch
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    assert calls["n"] == 2  # expired once, listed again
    assert len(inf.keys()) == 8

    def dead_watch(kind=None, from_revision=None, frames=False):
        raise ExpiredRevisionError("window slid")

    store.watch = dead_watch
    assert inf._try_relist() is False
    assert inf._gap_pending and inf.stats["relist_failures"] == 1
    store.watch = real_watch
    cs.pods.create(Pod(meta=ObjectMeta(name="after")))
    inf.pump()  # retries the relist, then drains the new watch
    assert not inf._gap_pending and "default/after" in inf.keys()


def test_informer_isolates_handler_errors():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    seen, good = _recorder()

    def boom(obj):
        raise RuntimeError("handler bug")

    inf.add_handler(Handler(on_add=boom))
    inf.add_handler(good)
    inf.start_manual()
    cs.pods.create(Pod(meta=ObjectMeta(name="a")))
    inf.pump()
    assert seen == [("add", "default/a")]
    assert inf.stats["handler_errors"] == 1


@pytest.mark.timeout(60)
def test_informer_threaded_loop_and_stop():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    got = threading.Event()
    inf.add_handler(Handler(on_add=lambda o: o.meta.name == "last" and got.set()))
    inf.start()
    try:
        assert inf.pump() == 0  # the thread owns the stream
        for i in range(20):
            cs.pods.create(Pod(meta=ObjectMeta(name=f"p{i}")))
        cs.pods.create(Pod(meta=ObjectMeta(name="last")))
        assert got.wait(timeout=10)
        assert len(inf.keys()) == 21
    finally:
        inf.stop()
    assert not inf._thread.is_alive()


# -- wire form: the same object gives the same dict in both packages -------


def _mask(d):
    """Drop what each process mints on its own: uids and revisions."""
    if isinstance(d, dict):
        return {k: _mask(v) for k, v in d.items()
                if k not in ("uid", "resourceVersion", "creationRevision")}
    if isinstance(d, list):
        return [_mask(v) for v in d]
    return d


def _objects(pkg):
    """One object of each kind this slice serializes, built from the same
    fields with each package's own classes."""
    api = types = importlib.import_module(f"{pkg}.api")
    tu = importlib.import_module(f"{pkg}.testutil")
    sel = api.LabelSelector.from_match_labels
    pod = tu.make_pod(
        "web-1", cpu="250m", memory="64Mi", labels={"app": "web"}, host_ports=[8080],
        node_selector={"disk": "ssd"},
        tolerations=[api.Toleration(key="k", operator="Exists", toleration_seconds=30)],
        affinity=api.Affinity(pod_anti_affinity_required=[api.PodAffinityTerm(
            selector=sel({"app": "web"}), topology_key="kubernetes.io/hostname")]),
        volumes=[api.Volume(name="v", disk_id="pd-1", disk_kind="gce-pd"),
                 api.Volume(name="c", pvc_name="claim")],
        owner_refs=[api.OwnerReference(kind="ReplicaSet", name="rs", uid="u1", controller=True)])
    pod.status = types.PodStatus(phase="Running", host_ip="10.0.0.1", pod_ip="10.1.0.2",
                                 conditions=[{"type": "Ready", "status": "True"}],
                                 container_statuses=[types.ContainerStatus(
                                     name="c0", state="running", ready=True)])
    node = tu.make_node("n1", cpu="8", memory="16Gi", labels={"zone": "a"},
                        taints=[api.Taint(key="dedicated", value="x", effect="NoSchedule")],
                        conditions=[api.NodeCondition(type="Ready", status="True"),
                                    api.NodeCondition(type="MemoryPressure", status="False")])
    node.status.images = [{"names": ["img:1"], "sizeBytes": 1000}]
    return {
        "Pod": pod,
        "PodStatus": pod.status,
        "Node": node,
        "Binding": types.Binding(pod_namespace="ns", pod_name="p", node_name="n1"),
        "Service": types.Service(meta=api.ObjectMeta(name="web"), selector={"app": "web"},
                                 ports=[types.ServicePort(name="http", port=80, target_port=8080)]),
        "ReplicaSet": types.ReplicaSet(
            meta=api.ObjectMeta(name="rs"), replicas=3, selector=sel({"app": "web"}),
            template=types.PodTemplateSpec(labels={"app": "web"}, spec=pod.spec)),
        "PersistentVolume": types.PersistentVolume(
            meta=api.ObjectMeta(name="pv1"), capacity={"storage": api.Quantity("10Gi")},
            zone="z1", claim_ref="default/claim", phase="Bound"),
        "PersistentVolumeClaim": types.PersistentVolumeClaim(
            meta=api.ObjectMeta(name="claim"), request_storage=api.Quantity("5Gi"),
            volume_name="pv1", phase="Bound"),
        "Event": types.Event(meta=api.ObjectMeta(name="web-1.1"), involved_kind="Pod",
                             involved_key="default/web-1", reason="Scheduled",
                             message="Successfully assigned", count=2),
    }


KINDS = ["Pod", "PodStatus", "Node", "Binding", "Service", "ReplicaSet",
         "PersistentVolume", "PersistentVolumeClaim", "Event"]


@pytest.mark.parametrize("kind", KINDS)
def test_wire_dict_matches_reference_and_round_trips(kind):
    want = _objects(cases.JAX)[kind].to_dict()
    port_obj = _objects(cases.PORT)[kind]
    got = port_obj.to_dict()
    assert _mask(got) == _mask(want)
    # the dict round-trips, and the reference's dict decodes in the port
    assert type(port_obj).from_dict(got).to_dict() == got
    assert type(port_obj).from_dict(want).to_dict() == got


def test_registry_and_scopes_match_reference():
    jax_types = importlib.import_module("kubernetes_tpu.api.types")
    port_types = importlib.import_module("kubernetes_tpu_torch.api.types")
    # each package's apiserver registers federation's Cluster kind on import
    for root in ("kubernetes_tpu", "kubernetes_tpu_torch"):
        importlib.import_module(f"{root}.federation.types")
    for kind in port_types.KINDS:
        assert port_types.KIND_PLURALS[kind] == jax_types.KIND_PLURALS[kind]
        assert (kind in port_types.CLUSTER_SCOPED_KINDS) == (kind in jax_types.CLUSTER_SCOPED_KINDS)
    # every kind of the JAX registry: the 34 API kinds and federation's
    # Cluster
    assert set(port_types.KINDS) == set(jax_types.KINDS)
    assert len(port_types.KINDS) == 35
    assert {k: port_types.KIND_PLURALS[k] for k in port_types.KINDS} == {
        k: jax_types.KIND_PLURALS[k] for k in port_types.KINDS}
    assert port_types.CLUSTER_SCOPED_KINDS == jax_types.CLUSTER_SCOPED_KINDS


def _store_history(pkg):
    """The same writes through each package's clientset; returns the watch
    sequence (type, key, revision, masked object) and the final list."""
    client = importlib.import_module(f"{pkg}.client")
    store_mod = importlib.import_module(f"{pkg}.store")
    api = importlib.import_module(f"{pkg}.api")
    tu = importlib.import_module(f"{pkg}.testutil")
    store = store_mod.Store()
    cs = client.Clientset(store)
    w = store.watch("Pod")
    cs.nodes.create(tu.make_node("n1"))
    cs.pods.create_many([tu.make_pod(f"p{i}", cpu="100m") for i in range(4)])
    cs.pods.bind_many([api.Binding(pod_name="p0", node_name="n1"),
                       api.Binding(pod_name="p1", node_name="n1")])
    cs.pods.bind(api.Binding(pod_name="p2", node_name="n1"))
    cs.pods.delete("p3")
    evs = []
    while (ev := w.get(timeout=0.05)) is not None:
        evs.append((ev.type, ev.key, ev.revision, _mask(ev.object)))
    w.stop()
    pods, rev = store.list("Pod")
    return evs, [_mask(p) for p in pods], rev


def test_same_writes_give_same_watch_events_as_reference():
    assert _store_history(cases.PORT) == _store_history(cases.JAX)


# -- events (twins of tests/test_record.py) ---------------------------------


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def pod(name, namespace="default"):
    return Pod(meta=ObjectMeta(name=name, namespace=namespace))


def make(clock=None, **kw):
    cs = Clientset(Store())
    return cs, EventBroadcaster(cs, source="test", clock=clock or FakeClock(), **kw)


def test_identical_events_bump_count_instead_of_creating():
    cs, b = make()
    rec = b.recorder()
    for _ in range(5):
        rec.event(pod("p1"), "Warning", "FailedScheduling", "0/3 nodes available")
    b.flush()
    events, _ = cs.events.list()
    assert len(events) == 1 and events[0].count == 5
    assert b.correlator.stats["created"] == 1 and b.correlator.stats["patched"] == 4


def test_distinct_messages_create_distinct_events():
    cs, b = make()
    rec = b.recorder()
    rec.event(pod("p1"), "Normal", "Scheduled", "assigned to n1")
    rec.event(pod("p1"), "Normal", "Scheduled", "assigned to n2")
    b.flush()
    assert len(cs.events.list()[0]) == 2


def test_aggregation_after_max_similar():
    cs, b = make()
    rec = b.recorder()
    for i in range(14):
        rec.event(pod("p1"), "Warning", "FailedMount", f"volume vol-{i} timed out")
    b.flush()
    events, _ = cs.events.list()
    combined = [e for e in events if e.message.startswith("(combined from similar events)")]
    assert len(combined) == 1 and combined[0].count == 4
    assert len(events) == 11
    assert b.correlator.stats["aggregated"] == 4


def test_aggregation_window_resets():
    clock = FakeClock()
    cs, b = make(clock=clock)
    rec = b.recorder()
    for i in range(10):
        rec.event(pod("p1"), "Warning", "FailedMount", f"m{i}")
    clock.now += 601.0  # past similar_window
    rec.event(pod("p1"), "Warning", "FailedMount", "m-new")
    b.flush()
    assert not [e for e in cs.events.list()[0] if "combined" in e.message]


def test_spam_filter_token_bucket():
    clock = FakeClock()
    cs, b = make(clock=clock)
    rec = b.recorder()
    for i in range(40):
        rec.event(pod("noisy"), "Warning", "BackOff", f"try {i}")
    rec.event(pod("quiet"), "Normal", "Scheduled", "ok")
    b.flush()
    assert b.correlator.stats["dropped_spam"] == 40 - 25  # burst=25
    assert any(e.involved_key == "default/quiet" for e in cs.events.list()[0])
    clock.now += 12.5  # one token refills (1 per 12 s)
    rec.event(pod("noisy"), "Warning", "BackOff", "later")
    b.flush()
    assert b.correlator.stats["dropped_spam"] == 15


@pytest.mark.timeout(60)
def test_async_sink_thread_drains():
    cs, b = make(clock=None)
    rec = b.recorder()
    b.start()
    try:
        for i in range(100):
            rec.event(pod(f"p{i}"), "Normal", "Scheduled", f"assigned {i}")
    finally:
        b.stop(drain=True)
    assert len(cs.events.list()[0]) == 100
    assert not b.running


@pytest.mark.timeout(60)
def test_event_batch_through_sink_thread_and_manual_flush():
    """``event_batch`` rides the queue as one unexpanded batch: the sink
    thread expands and writes it; without a sink, ``flush`` does."""
    items = [(pod(f"p{i}"), "Normal", "Scheduled", ("Successfully assigned %s to %s",
                                                     f"default/p{i}", "n1"))
             for i in range(50)]
    cs, b = make()
    b.recorder().event_batch(items)
    assert len(b) == 50
    assert b.flush() == 50 and len(b) == 0
    manual = sorted(e.message for e in cs.events.list()[0])
    assert manual[0] == "Successfully assigned default/p0 to n1"

    cs2, b2 = make()
    b2.start()
    try:
        b2.recorder().event_batch(items)
    finally:
        b2.stop(drain=True)
    assert sorted(e.message for e in cs2.events.list()[0]) == manual


def test_overflow_drops_newest_and_counts():
    cs, b = make(max_queued=10)
    rec = b.recorder()
    for i in range(25):
        rec.event(pod(f"p{i}"), "Normal", "Scheduled", "x")
    assert b.dropped_overflow == 15
    b.flush()
    assert len(cs.events.list()[0]) == 10


def test_dedup_cache_is_lru_not_fifo():
    cs = Clientset(Store())
    b = EventBroadcaster(
        cs, correlator=EventCorrelator(source="test", clock=FakeClock(), cache_size=16))
    rec = b.recorder()
    rec.event(pod("hot"), "Warning", "BackOff", "same msg")
    b.flush()
    for i in range(40):
        rec.event(pod(f"cold-{i}"), "Normal", "Scheduled", "x")
        rec.event(pod("hot"), "Warning", "BackOff", "same msg")
        b.flush()
    hot = [e for e in cs.events.list()[0] if e.involved_key == "default/hot"]
    plain = [e for e in hot if not e.message.startswith("(combined")]
    combined = [e for e in hot if e.message.startswith("(combined")]
    assert len(plain) == 1 and plain[0].count == 10
    assert len(combined) == 1 and combined[0].count == 15


@pytest.mark.timeout(60)
def test_stop_bounded_when_sink_wedges():
    cs, b = make()
    release = threading.Event()
    b._write = lambda decision: release.wait()
    b.start()
    try:
        b.recorder().event(pod("p1"), "Normal", "Scheduled", "assigned to n1")
        t0 = time.monotonic()
        b.stop(drain=True, timeout=0.5)
        assert time.monotonic() - t0 < 5.0
        assert b._thread is not None  # still draining: no double sink
    finally:
        release.set()
    b._thread.join(timeout=5)
    assert not b._thread.is_alive() and not b.running
    b.start()
    assert b.running
    b.stop(drain=False)


def _correlated(pkg):
    """One mixed event stream through each package's broadcaster."""
    client = importlib.import_module(f"{pkg}.client")
    store_mod = importlib.import_module(f"{pkg}.store")
    api = importlib.import_module(f"{pkg}.api")
    clock = FakeClock()
    cs = client.Clientset(store_mod.Store())
    b = client.EventBroadcaster(cs, source="test", clock=clock)
    rec = b.recorder()
    mk = lambda n: api.Pod(meta=api.ObjectMeta(name=n))  # noqa: E731
    for i in range(30):
        rec.event(mk(f"p{i % 3}"), "Warning", "FailedScheduling", f"0/{i % 4} nodes")
        if i % 7 == 0:
            clock.now += 5.0
    rec.event_batch([(mk(f"q{i}"), "Normal", "Scheduled", ("to %s", f"n{i}")) for i in range(5)])
    b.flush()
    events, _ = cs.events.list()
    return sorted((e.meta.name, e.involved_key, e.reason, e.message, e.count)
                  for e in events), dict(b.correlator.stats)


def test_correlation_matches_reference():
    assert _correlated(cases.PORT) == _correlated(cases.JAX)
