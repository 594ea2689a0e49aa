"""Watch frames and columnar lists in the port (``store/frames.py``,
``store/columns.py``, the store's ``watch(frames=True)``, the informer's
batch apply, ``SchedulerCache.confirm_many`` and the scheduler's frame
confirm), held against the per-event path and against the JAX package on
the same writes.

The contract, layer by layer: a ``create_many``/``bind_many`` txn reaches a
frame-aware watcher as one frame whose expansion is the exact per-event
sequence; its wire line is the JAX package's, byte for byte, and decodes
in either package; the informer applies it under one lock hold with
per-event semantics; a bind-confirm frame confirms a wave with the same
end state as the per-pod confirm, and its revision fence sends an entry
with an intervening write down the per-pod path, in both packages alike.

Tolerance: exact equality.
"""

from __future__ import annotations

import copy
import importlib
import json
import threading
import time

import pytest

from kubernetes_tpu_torch.api import Binding, ObjectMeta
from kubernetes_tpu_torch.api import lazy as lazy_mod
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client import Clientset, RemoteStore
from kubernetes_tpu_torch.client.informer import Handler, SharedInformer
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.store import frames as frames_mod
from kubernetes_tpu_torch.store.frames import FRAME, FrameDecodeError, WatchFrame
from kubernetes_tpu_torch.testutil import make_node, make_pod
from tests import torch_port_cases as cases

PKGS = (cases.JAX, cases.PORT)


def _m(pkg: str, mod: str):
    return importlib.import_module(f"{pkg}.{mod}")


def _drain(watch, n_items, timeout=2.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n_items and time.monotonic() < deadline:
        ev = watch.get(timeout=0.05)
        if ev is not None:
            out.append(ev)
    return out


def _flatten(items):
    """(type, key, revision, object) rows of mixed event/frame lists."""
    rows = []
    for ev in items:
        evs = ev.events() if ev.type == FRAME else [ev]
        rows.extend((e.type, e.key, e.revision, e.object) for e in evs)
    return rows


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _pods(pkg: str, n: int, prefix: str = "p"):
    """Pods with fixed uids, so both packages store identical bytes."""
    out = []
    for i in range(n):
        pod = _m(pkg, "testutil").make_pod(f"{prefix}{i}", cpu="100m", memory="64Mi",
                                           labels={"app": "web" if i % 2 else "db"})
        pod.meta.uid = f"uid-{prefix}{i}"
        out.append(pod)
    return out


# ---- the store ---------------------------------------------------------------

def test_frame_expansion_equals_per_event_delivery():
    cs = Clientset(Store())
    framed, plain = cs.store.watch("Pod", frames=True), cs.store.watch("Pod")
    cs.pods.create_many(_pods(cases.PORT, 4))
    cs.pods.bind_many([Binding(pod_namespace="default", pod_name=f"p{i}", node_name="n1")
                       for i in range(3)])
    cs.pods.create(make_pod("solo", cpu="100m"))  # a single write is never framed
    framed_items, plain_items = _drain(framed, 3), _drain(plain, 8)
    assert [it.type for it in framed_items] == [FRAME, FRAME, "ADDED"]
    assert [len(it) for it in framed_items[:2]] == [4, 3]
    assert _flatten(framed_items) == _flatten(plain_items)
    framed.stop()
    plain.stop()


def test_bind_frame_carries_prev_revision_and_node_columns():
    cs = Clientset(Store())
    w = cs.store.watch("Pod", frames=True)
    created = cs.pods.create_many(_pods(cases.PORT, 3))
    pre_revs = [c.meta.resource_version for c in created]
    _drain(w, 1)
    cs.pods.bind_many([Binding(pod_namespace="default", pod_name=f"p{i}", node_name=f"n{i}")
                       for i in range(3)])
    frame = _drain(w, 1)[0]
    assert frame.type == FRAME and frame.types == ["MODIFIED"] * 3
    assert frame.node_names == ["n0", "n1", "n2"]
    assert frame.prev_revisions == pre_revs
    w.stop()


def _write_sequence(pkg: str) -> tuple[list, list]:
    """The same writes in package ``pkg``'s store: (frame-aware items,
    per-event items)."""
    A = _m(pkg, "api")
    cs = _m(pkg, "client").Clientset(_m(pkg, "store").Store())
    framed, plain = cs.store.watch("Pod", frames=True), cs.store.watch("Pod")
    cs.pods.create_many(_pods(pkg, 5))
    cs.pods.bind_many([A.Binding(pod_namespace="default", pod_name=f"p{i}", node_name="n1")
                       for i in range(4)])
    cs.pods.delete("p4")
    out = _drain(framed, 3), _drain(plain, 10)
    framed.stop()
    plain.stop()
    return out


def test_wire_lines_are_the_references_byte_for_byte():
    (p_framed, p_plain), (j_framed, j_plain) = (_write_sequence(cases.PORT),
                                                _write_sequence(cases.JAX))
    ev_mod = {cases.PORT: frames_mod, cases.JAX: _m(cases.JAX, "store.frames")}
    assert [it.type for it in p_framed] == [it.type for it in j_framed] == [FRAME, FRAME, "DELETED"]
    for p, j in zip(p_framed[:2], j_framed[:2]):
        p.txn = j.txn = "txn-1"  # correlation ids are each process's own count
        assert p.wire_bytes() == j.wire_bytes()
    assert (ev_mod[cases.PORT].event_wire_bytes(p_framed[2])
            == ev_mod[cases.JAX].event_wire_bytes(j_framed[2]))
    assert [ev_mod[cases.PORT].event_wire_bytes(e) for e in p_plain] == \
        [ev_mod[cases.JAX].event_wire_bytes(e) for e in j_plain]


def test_frames_decode_in_either_package():
    (p_framed, _), (j_framed, _) = _write_sequence(cases.PORT), _write_sequence(cases.JAX)
    JaxFrame = _m(cases.JAX, "store.frames").WatchFrame
    for ours, theirs in zip(p_framed[:2], j_framed[:2]):
        a = JaxFrame.from_wire(json.loads(ours.wire_bytes()))
        b = WatchFrame.from_wire(json.loads(theirs.wire_bytes()))
        for x, y in ((a, ours), (b, theirs)):
            assert (x.kind, x.types, x.keys, x.revisions, x.prev_revisions, x.objects, x.txn) == \
                (y.kind, y.types, y.keys, y.revisions, y.prev_revisions, y.objects, y.txn)


def test_frame_wire_validation():
    cs = Clientset(Store())
    w = cs.store.watch("Pod", frames=True)
    cs.pods.create_many(_pods(cases.PORT, 3))
    wire = json.loads(_drain(w, 1)[0].wire_bytes())
    w.stop()
    for broken in ({"keys": wire["keys"][:-1]}, {"revisions": wire["revisions"][::-1]},
                   {"objects": ["not-a-dict"] * 3},
                   {"types": [], "keys": [], "revisions": [], "objects": []}):
        with pytest.raises(FrameDecodeError):
            WatchFrame.from_wire({**wire, **broken})


def test_frames_off_restores_per_event_delivery(monkeypatch):
    monkeypatch.setattr(frames_mod, "ENABLED", False)
    cs = Clientset(Store())
    w = cs.store.watch("Pod", frames=True)
    cs.pods.create_many(_pods(cases.PORT, 3))
    assert [it.type for it in _drain(w, 3)] == ["ADDED"] * 3
    w.stop()


@pytest.mark.parametrize("kind", ["Pod", "Node"])
def test_column_batches_equal_the_reference(kind):
    batches = {}
    for pkg in PKGS:
        cs = _m(pkg, "client").Clientset(_m(pkg, "store").Store())
        tu = _m(pkg, "testutil")
        for i in range(6):
            node = tu.make_node(f"n{i}", cpu="8", memory="16Gi",
                                labels={"failure-domain.beta.kubernetes.io/zone": f"z{i % 3}"})
            node.meta.uid = f"uid-n{i}"
            cs.nodes.create(node)
        cs.pods.create_many(_pods(pkg, 6))
        batches[pkg] = cs.store.list_columns(kind)
    a, b = batches[cases.PORT], batches[cases.JAX]
    assert json.dumps(a.to_wire()) == json.dumps(b.to_wire())
    assert a.keys == b.keys and len(a) == len(b) == 6
    if kind == "Pod":
        assert a.sig_keys == b.sig_keys and a.sig_ids.tolist() == b.sig_ids.tolist()
        assert a.req_units.tolist() == b.req_units.tolist()
    else:
        assert a.zones == b.zones == ["z0", "z1", "z2"] * 2


# ---- the informer ------------------------------------------------------------

def _recording_handler(log):
    return Handler(on_add=lambda o: log.append(("add", o.meta.key)),
                   on_update=lambda old, new: log.append(("update", new.meta.key)),
                   on_delete=lambda o: log.append(("del", o.meta.key)))


def _per_event_informer(client):
    inf = SharedInformer(client)
    inf._watch_from = lambda rev: client.watch(from_revision=rev)
    return inf


def test_informer_batch_apply_matches_per_event():
    cs = Clientset(Store())
    framed_log, plain_log = [], []
    framed = SharedInformer(Clientset(cs.store).pods)
    plain = _per_event_informer(Clientset(cs.store).pods)
    framed.add_handler(_recording_handler(framed_log))
    plain.add_handler(_recording_handler(plain_log))
    framed.start_manual()
    plain.start_manual()
    cs.pods.create_many(_pods(cases.PORT, 6))
    cs.pods.bind_many([Binding(pod_namespace="default", pod_name=f"p{i}", node_name="n1")
                       for i in range(6)])
    cs.pods.delete("p5")
    assert framed.pump() == plain.pump() == 13
    assert framed.stats["frames"] == 2 and framed.stats["frame_events"] == 12
    assert plain.stats["frames"] == 0
    assert framed_log == plain_log and framed.keys() == plain.keys()
    assert framed.last_revision == plain.last_revision
    for key in framed.keys():
        assert framed.get(key).to_dict() == plain.get(key).to_dict()


def test_on_batch_handler_receives_the_frame_and_crashes_are_isolated():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    batches, peer = [], []

    def crash(frame, deltas):
        raise RuntimeError("boom in a batch handler")

    inf.add_handler(Handler(on_batch=crash))
    inf.add_handler(Handler(on_batch=lambda f, d: batches.append((f, d))))
    inf.add_handler(_recording_handler(peer))
    inf.start_manual()
    cs.pods.create_many(_pods(cases.PORT, 4))
    inf.pump()
    assert inf.stats["handler_errors"] == 1 and len(batches) == 1
    frame, deltas = batches[0]
    assert frame.type == FRAME and [d[0] for d in deltas] == ["ADDED"] * 4
    assert peer == [("add", f"default/p{i}") for i in range(4)]


def test_frame_revision_fence_drops_stale_frames():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    cs.pods.create_many(_pods(cases.PORT, 2))
    inf.pump()
    fence = inf.last_revision
    stale = WatchFrame("Pod", ["MODIFIED"], ["default/p0"], [fence],
                       [{"metadata": {"name": "p0", "namespace": "default",
                                      "resourceVersion": fence},
                         "spec": {"nodeName": "bogus"}}])
    inf._apply_batch(stale)
    assert inf.get("default/p0").spec.node_name == ""
    assert inf.last_revision == fence and inf.stats["frame_events"] == 2


def test_an_undecodable_entry_loses_that_delta_and_relist_heals():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    objs = [dict(o, spec="garbage") if i == 1 else o
            for i, o in enumerate(cs.store.create_many("Pod", [p.to_dict() for p in _pods(
                cases.PORT, 3)]))]
    inf._watch.get(timeout=1)  # the store's own frame: replaced below
    rev0 = inf.last_revision
    inf._apply_batch(WatchFrame("Pod", ["ADDED"] * 3, [f"default/p{i}" for i in range(3)],
                                [rev0 + 1, rev0 + 2, rev0 + 3], objs))
    assert inf.stats["decode_errors"] == 1 and inf._gap_pending
    assert inf.get("default/p1") is None and inf.get("default/p2") is not None
    inf.pump()
    assert inf.stats["relists"] == 1 and inf.get("default/p1") is not None


def test_batch_apply_under_concurrent_readers():
    cs = Clientset(Store())
    inf = SharedInformer(cs.pods)
    inf.start_manual()
    stop, errors = threading.Event(), []

    def reader():
        while not stop.is_set():
            try:
                for o in inf.list():
                    lazy_mod.pod_brief(o)
                    o.spec.containers  # promote under concurrent applies
                inf.keys()
            except Exception as e:  # noqa: BLE001 - the assertion target
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for w in range(20):
            cs.pods.create_many(_pods(cases.PORT, 25, prefix=f"w{w}-"))
            inf.pump()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(inf.keys()) == 500 and inf.stats["frames"] == 20


# ---- confirm_many and the scheduler's frame confirm --------------------------

def _cache_fingerprint(cache):
    states = {k: (v[1], v[2]) for k, v in cache._pod_states.items()}
    nodes = {name: (sorted(p.meta.key for p in info.pods),
                    sorted(p.meta.key for p in info.pods_with_affinity),
                    tuple(info.requested.units), tuple(info.nonzero_requested.units),
                    sorted(info.used_ports))
             for name, info in cache._nodes.items()}
    return states, nodes


def _confirm_scenario(pkg: str) -> list:
    """Assume three pods, write one of them again, bind all three, and
    feed the bind frame's columns to ``confirm_many``: the keys it hands
    back for the per-pod path."""
    A = _m(pkg, "api")
    cs = _m(pkg, "client").Clientset(_m(pkg, "store").Store())
    cache = _m(pkg, "scheduler.nodeinfo").SchedulerCache()
    cache.add_node(_m(pkg, "testutil").make_node("n0", cpu="8", memory="16Gi"))
    created = cs.pods.create_many(_pods(pkg, 3))
    cache.assume_many([(p, "n0") for p in created])

    def label(d):
        d.setdefault("metadata", {}).setdefault("labels", {})["x"] = "y"
        return d

    w = cs.store.watch("Pod", frames=True)
    cs.store.guaranteed_update("Pod", "default", "p1", label)
    cs.pods.bind_many([A.Binding(pod_namespace="default", pod_name=f"p{i}", node_name="n0")
                       for i in range(3)])
    frame = _drain(w, 2)[1]
    w.stop()
    L = _m(pkg, "api.lazy")
    entries = [(frame.keys[i], frame.node_names[i], frame.prev_revisions[i],
                L.wrap(type(created[0]), frame.objects[i])) for i in range(len(frame))]
    return [e[0] for e in cache.confirm_many(entries)]


def test_confirm_many_accepts_and_rejects_the_same_entries_as_the_reference():
    assert _confirm_scenario(cases.PORT) == _confirm_scenario(cases.JAX) == ["default/p1"]


def _world(n_nodes=8):
    cs = Clientset(Store())
    for i in range(n_nodes):
        cs.nodes.create(make_node(f"n{i}", cpu="16", memory="32Gi", pods=110,
                                  labels={"kubernetes.io/hostname": f"n{i}"}))
    algo = GenericScheduler()
    sched = Scheduler(cs, algorithm=algo, backend=BatchBackend(algorithm=algo, device="cpu"),
                      emit_events=False)
    sched.start()
    return cs, sched


def _wave(cs, sched, n_pods, prefix):
    cs.pods.create_many([make_pod(f"{prefix}-{i:04d}", cpu="100m", memory="128Mi")
                         for i in range(n_pods)])
    sched.pump()
    out = sched.schedule_pending_batch()
    sched.pump()  # digest the bind-confirm frame (or events)
    return out


def test_frame_confirm_equals_per_pod_confirm_on_waves(monkeypatch):
    cs_b, sched_b = _world()
    for w in range(3):
        assert _wave(cs_b, sched_b, 50, f"w{w}") == (50, 0)
    monkeypatch.setattr(frames_mod, "ENABLED", False)
    monkeypatch.setattr(lazy_mod, "ENABLED", False)
    cs_a, sched_a = _world()
    for w in range(3):
        assert _wave(cs_a, sched_a, 50, f"w{w}") == (50, 0)
    monkeypatch.undo()
    bind_b = {p.meta.key: p.spec.node_name for p in cs_b.pods.list()[0]}
    bind_a = {p.meta.key: p.spec.node_name for p in cs_a.pods.list()[0]}
    assert bind_b == bind_a and all(bind_b.values())
    assert _cache_fingerprint(sched_b.cache) == _cache_fingerprint(sched_a.cache)
    assert sched_b.metrics.watch_frames.value > 0
    assert sched_b.metrics.confirm_fallbacks.value == 0
    assert sched_a.metrics.watch_frames.value == 0
    # three arrival frames and three bind-confirm frames of 50
    assert sched_b.metrics.watch_frame_events.value == 300


def test_confirm_falls_back_per_pod_on_an_intervening_write():
    cs, sched = _world(n_nodes=2)
    cs.pods.create(make_pod("a", cpu="100m", memory="128Mi"))
    cs.pods.create(make_pod("b", cpu="100m", memory="128Mi"))
    sched.pump()
    pods = {p.meta.name: p for p in sched.informers.informer("Pod").list()}
    sched.cache.assume_many([(pods["a"], "n0"), (pods["b"], "n0")])

    def label(d):
        d.setdefault("metadata", {}).setdefault("labels", {})["x"] = "y"
        return d

    cs.store.guaranteed_update("Pod", "default", "a", label)
    cs.pods.bind_many([Binding(pod_namespace="default", pod_name=n, node_name="n0")
                       for n in ("a", "b")])
    sched.pump()
    states, _ = _cache_fingerprint(sched.cache)
    assert states == {"default/a": ("n0", "bound"), "default/b": ("n0", "bound")}
    assert sched.metrics.confirm_fallbacks.value == 1
    cached = {p.meta.key: p for p in sched.cache._nodes["n0"].pods}
    assert cached["default/a"].meta.labels.get("x") == "y"


# ---- over the wire -----------------------------------------------------------

@pytest.fixture
def port_server():
    from kubernetes_tpu_torch.apiserver import APIServer

    server = APIServer(Store())
    server.start()
    yield server
    server.stop()


@pytest.mark.timeout(60)
def test_remote_frames_end_to_end(port_server):
    rs = RemoteStore(port_server.url)
    cs = Clientset(port_server.store)
    inf = SharedInformer(Clientset(rs).pods)
    plain = _per_event_informer(Clientset(RemoteStore(port_server.url)).pods)
    try:
        inf.start_manual()
        plain.start_manual()
        assert _wait(lambda: inf._watch._stream is not None and plain._watch._stream is not None)
        cs.pods.create_many(_pods(cases.PORT, 5))
        assert _wait(lambda: (inf.pump(), len(inf.list()))[-1] == 5)
        assert _wait(lambda: (plain.pump(), len(plain.list()))[-1] == 5)
        assert inf.stats["frames"] >= 1 and inf.stats["frame_events"] >= 5
        assert plain.stats["frames"] == 0
        assert sorted(plain.keys()) == sorted(inf.keys())
    finally:
        inf.stop()
        plain.stop()


@pytest.mark.timeout(60)
def test_a_broken_frame_line_gaps_and_relist_heals(port_server, monkeypatch):
    real = WatchFrame.from_wire
    calls = {"n": 0}

    def first_fails(d):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FrameDecodeError("frame column lengths diverge")
        return real(d)

    monkeypatch.setattr(WatchFrame, "from_wire", staticmethod(first_fails))
    rs = RemoteStore(port_server.url)
    inf = SharedInformer(Clientset(rs).pods)
    try:
        inf.start_manual()
        assert _wait(lambda: inf._watch._stream is not None)
        Clientset(port_server.store).pods.create_many(_pods(cases.PORT, 4))
        assert _wait(lambda: (inf.pump(), len(inf.list()))[-1] == 4)
        assert rs.metrics.watch_gaps.value >= 1 and inf.stats["relists"] >= 1
        assert sorted(inf.keys()) == [f"default/p{i}" for i in range(4)]
    finally:
        inf.stop()


@pytest.mark.timeout(60)
def test_remote_columnar_list(port_server):
    cs = Clientset(port_server.store)
    cs.pods.create_many(_pods(cases.PORT, 3))
    cs.nodes.create(make_node("n-0", cpu="4", memory="8Gi"))
    remote = RemoteStore(port_server.url)
    batch, local = remote.list_columns("Pod"), port_server.store.list_columns("Pod")
    assert batch.keys == local.keys and batch.sig_keys == local.sig_keys
    assert [n.meta.name for n in remote.list_columns("Node").objects()] == ["n-0"]
    assert remote.list_columns("Service") is None


# ---- compaction ----------------------------------------------------------------

def test_promote_and_drop_raw_preserves_the_value():
    raw = Store().create("Pod", make_pod("r0", cpu="250m", host_ports=[8000],
                                         labels={"app": "web"}).to_dict())
    eager = api.Pod.from_dict(copy.deepcopy(raw))
    lz = lazy_mod.wrap(api.Pod, copy.deepcopy(raw))
    assert lazy_mod.promote_and_drop_raw(lz) is True and lz.raw is None
    assert lz == eager and lz.to_dict() == eager.to_dict()
    assert lazy_mod.undecoded_spec(lz) is None and lazy_mod.undecoded_meta(lz) is None
    assert lazy_mod.pod_brief(lz) == lazy_mod.pod_brief(eager)
    assert lazy_mod.resource_version_of(lz) == eager.meta.resource_version
    assert lz.host_ports() == eager.host_ports()
    assert lazy_mod.promote_and_drop_raw(lz) is False
    assert lazy_mod.promote_and_drop_raw(eager) is False
    svc = lazy_mod.wrap(api.Service, Store().create("Service", api.Service(
        meta=ObjectMeta(name="s"), selector={"app": "x"}).to_dict()))
    assert lazy_mod.promote_and_drop_raw(svc) is True
    assert svc.selector == {"app": "x"} and svc.raw is None


def test_informer_compact_cache():
    cs = Clientset(Store())
    cs.pods.create_many(_pods(cases.PORT, 4))
    inf = SharedInformer(Clientset(cs.store).pods)
    inf.start_manual()
    before = {k: inf.get(k).to_dict() for k in inf.keys()}
    assert inf.compact_cache() == 4 and inf.stats["compactions"] == 4
    for key, d in before.items():
        assert inf.get(key).raw is None and inf.get(key).to_dict() == d
    assert inf.compact_cache() == 0
    assert inf.metrics.informer_compaction_freed_bytes.value == 0
    cs.pods.bind_many([Binding(pod_namespace="default", pod_name="p0", node_name="n1")])
    inf.pump()
    assert inf.get("default/p0").raw is not None and inf.compact_cache() == 1
