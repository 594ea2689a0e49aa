"""The port's coalescing window (``Store(coalesce_window_s=...)``): twins
of ``tests/test_coalesce.py``.

With a window open at the broadcaster, every consumer converges to
exactly the state a per-event stream produces: folds may supersede
intermediate deliveries, never final state, ordering fences or CAS
semantics.  The cases: coalesced == per-event informer state over
seeded update/delete interleavings (with a mid-window gap and relist);
selector frames == per-event selector streams over the port's wire
(``?frames=1&labelSelector=``); a failing flush degrades that window to
per-event delivery (``store_coalesce_fallbacks_total``); batch txns and
new watches flush the open window first; synthetic frames keep the wire
and CAS contract; one encoding a revision, shared across watchers.
Tolerance: exact equality."""

import json
import random
import threading
import time

import pytest

from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.client.informer import SharedInformer
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.store.frames import WatchFrame, event_wire_bytes
from kubernetes_tpu_torch.store.store import WATCH_GAP, WatchEvent
from kubernetes_tpu_torch.utils.metrics import DEFAULT_STORE_METRICS


def _pod(i, phase="Pending"):
    return {"metadata": {"name": f"cp-{i:03d}", "namespace": "default",
                         "labels": {"tier": "hot" if i % 2 == 0 else "cold"}},
            "spec": {}, "status": {"phase": phase}}


def _apply_script(store, script):
    """Replay one op script; revisions are deterministic given the
    script, so two stores given the same script agree revision-for-
    revision."""
    alive = set()
    for op, i, tag in script:
        if op == "create":
            store.create("Pod", _pod(i))
            alive.add(i)
        elif op == "update":
            obj = store.get("Pod", "default", f"cp-{i:03d}")
            obj["status"] = {"phase": f"run-{tag}"}
            store.update("Pod", obj)
        else:
            store.delete("Pod", "default", f"cp-{i:03d}")
            alive.discard(i)
    return alive


def _script(rng, n_keys=8, n_ops=60):
    """Randomized single-event churn with delete-then-recreate cycles."""
    alive = set()
    out = []
    for t in range(n_ops):
        i = rng.randrange(n_keys)
        if i not in alive:
            out.append(("create", i, t))
            alive.add(i)
        elif rng.random() < 0.25:
            out.append(("delete", i, t))
            alive.discard(i)
        else:
            out.append(("update", i, t))
    return out


def _cache_view(inf):
    with inf._mu:
        return {k: (o.meta.resource_version, o.status.phase)
                for k, o in inf._cache.items()}


def _drain(store, inf, deadline_s=5.0):
    """Flush the window and pump until the informer holds the head."""
    store.flush_coalesced()
    end = time.time() + deadline_s
    while inf.last_revision < store.revision and time.time() < end:
        inf.pump()
        time.sleep(0.002)
    inf.pump()


@pytest.mark.parametrize("seed", range(6))
def test_coalesced_informer_state_equals_per_event(seed):
    """The tentpole property: over a randomized interleaving (creates,
    updates, deletes, recreates), an informer on a coalescing store
    converges to the identical cache a per-event informer builds —
    same keys, same resourceVersions, same decoded payloads."""
    script = _script(random.Random(seed))

    sa = Store()  # per-event baseline (no window, frames off for singles)
    sb = Store(coalesce_window_s=0.02)
    try:
        ia = SharedInformer(Clientset(sa).pods)
        ib = SharedInformer(Clientset(sb).pods)
        ia.start_manual()
        ib.start_manual()
        _apply_script(sa, script)
        _apply_script(sb, script)
        _drain(sa, ia)
        _drain(sb, ib)
        assert sa.revision == sb.revision  # same script, same revisions
        assert _cache_view(ia) == _cache_view(ib)
        assert ib.last_revision == sb.revision
    finally:
        sa.close()
        sb.close()


def test_mid_window_gap_relists_and_reconverges():
    """A WATCH_GAP landing while a window is open (transport lost
    continuity mid-churn) must relist and still converge to per-event
    truth — the synthetic frames after the relist apply over the fresh
    cache exactly like live ones."""
    rng = random.Random(99)
    script = _script(rng, n_ops=40)
    sa = Store()
    sb = Store(coalesce_window_s=0.02)
    try:
        ia = SharedInformer(Clientset(sa).pods)
        ib = SharedInformer(Clientset(sb).pods)
        ia.start_manual()
        ib.start_manual()
        _apply_script(sa, script[:20])
        _apply_script(sb, script[:20])
        # continuity loss mid-window: queue a GAP ahead of the pending
        # flush — the informer relists (LIST sees the buffered commits:
        # durability is per-event) and keeps consuming
        ib._watch._queue.put(WatchEvent(
            type=WATCH_GAP, kind="Pod", key="", revision=0, object={}))
        _apply_script(sa, script[20:])
        _apply_script(sb, script[20:])
        _drain(sa, ia)
        _drain(sb, ib)
        assert ib.stats["relists"] >= 1
        assert _cache_view(ia) == _cache_view(ib)
    finally:
        sa.close()
        sb.close()


def test_selector_frames_equal_per_event_selector_stream():
    """Over the wire: a ``?frames=1&labelSelector=tier=hot`` stream and
    a per-event ``labelSelector=tier=hot`` stream see the same filtered
    deltas — and nothing outside the selector."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.remote import RemoteStore

    store = Store(coalesce_window_s=0.02)
    server = APIServer(store)
    server.start()
    try:
        remote = RemoteStore(server.url)
        wf = remote.watch("Pod", from_revision=0, frames=True,
                          label_selector="tier=hot")
        we = remote.watch("Pod", from_revision=0, frames=False,
                          label_selector="tier=hot")
        script = _script(random.Random(7), n_keys=10, n_ops=50)
        _apply_script(store, script)
        store.flush_coalesced()

        def collect(w, out, bad):
            end = time.time() + 5.0
            last = 0
            while time.time() < end:
                ev = w.get(timeout=0.1)
                if ev is None:
                    if last and time.time() - last > 0.5:
                        break
                    continue
                last = time.time()
                if ev.type == "FRAME":
                    for i in range(len(ev.keys)):
                        o = ev.objects[i]
                        if o is not None and (o["metadata"].get("labels") or
                                              {}).get("tier") != "hot":
                            bad.append(ev.keys[i])
                        if ev.types[i] == "DELETED":
                            out.pop(ev.keys[i], None)
                        else:
                            out[ev.keys[i]] = ev.revisions[i]
                elif ev.type == "DELETED":
                    out.pop(ev.key, None)
                else:
                    if (ev.object["metadata"].get("labels") or
                            {}).get("tier") != "hot":
                        bad.append(ev.key)
                    out[ev.key] = ev.revision

        sf, se = {}, {}
        bad = []
        t1 = threading.Thread(target=collect, args=(wf, sf, bad))
        t2 = threading.Thread(target=collect, args=(we, se, bad))
        t1.start()
        t2.start()
        t1.join(10)
        t2.join(10)
        assert not bad, f"selector leaked non-matching keys: {bad}"
        assert sf == se
        assert sf  # the streams actually carried matching churn
        wf.stop()
        we.stop()
    finally:
        server.stop()
        store.close()


def test_flush_fault_dumps_the_windows_own_span():
    """A ``store.coalesce`` fault fired by the flusher's deadline, on a
    thread with no other span open, dumps the flight recorder with the
    window's own ``store.coalesce`` span live: its txn, its events and
    its folds are the dump's context (a kept divergence: the JAX
    package's flush opens no span, so its dump there is bare)."""
    from kubernetes_tpu_torch.faults import FaultPlan
    from kubernetes_tpu_torch.utils import tracing

    tr = tracing.enable()
    store = Store(coalesce_window_s=10.0)  # manual flushes only
    try:
        store.watch("Pod", frames=True)
        store.create("Pod", _pod(0))
        obj = store.get("Pod", "default", "cp-000")
        obj["status"] = {"phase": "run"}
        store.update("Pod", obj)
        store.create("Pod", _pod(1))
        txn = store._pending.txn
        plan = FaultPlan(seed=1).on("store.coalesce", mode="error", nth=1)
        with plan.armed():
            flusher = threading.Thread(target=store.flush_coalesced)
            flusher.start()
            flusher.join(timeout=10)
        assert plan.fired["store.coalesce"] == 1
        dumps = [d for d in tr.dumps if d["reason"] == "fault:store.coalesce"]
        assert len(dumps) == 1
        live = [s for s in dumps[0]["live"] if s["name"] == "store.coalesce"]
        assert len(live) == 1, dumps[0]["live"]
        assert live[0]["t1"] is None
        assert live[0]["attrs"] == {"txn": txn, "events": 2, "folded": 1}
        # closed after the flush: the span lands in the background record
        assert [s["name"] for s in tr.flight_snapshot()["current"]["live"]] == []
    finally:
        tracing.disable()
        store.close()


def test_flush_fault_degrades_to_per_event_same_state():
    """An armed ``store.coalesce`` fault fails the framed flush: THAT
    window falls back to per-event delivery of the same folded events —
    the framed watcher sees no frame, loses no state, and the fallback
    counter records the degradation."""
    from kubernetes_tpu_torch.faults import FaultPlan

    m = DEFAULT_STORE_METRICS
    f0 = m.coalesce_fallbacks.value
    store = Store(coalesce_window_s=10.0)  # manual flushes only
    try:
        w = store.watch("Pod", frames=True)
        plan = FaultPlan(seed=1).on("store.coalesce", mode="error", nth=1)
        with plan.armed():
            store.create("Pod", _pod(0))
            obj = store.get("Pod", "default", "cp-000")
            obj["status"] = {"phase": "run"}
            store.update("Pod", obj)
            store.create("Pod", _pod(1))
            store.flush_coalesced()
        assert plan.fired["store.coalesce"] == 1
        assert m.coalesce_fallbacks.value == f0 + 1
        got = []
        while True:
            ev = w.get(timeout=0.1)
            if ev is None:
                break
            got.append(ev)
        # per-event delivery of the FOLDED set: cp-000's create was
        # superseded by its update inside the window
        assert [e.type for e in got] == ["MODIFIED", "ADDED"]
        assert [e.key for e in got] == ["default/cp-000", "default/cp-001"]
        assert [e.revision for e in got] == [2, 3]
        # the next window frames again (fallback is per-window, not sticky)
        store.create("Pod", _pod(2))
        store.create("Pod", _pod(3))
        store.flush_coalesced()
        ev = w.get(timeout=0.1)
        assert ev.type == "FRAME" and list(ev.revisions) == [4, 5]
        w.stop()
    finally:
        store.close()


def test_ordering_barriers_keep_revisions_monotone():
    """Buffered singles must flush BEFORE a batch txn fans out and
    BEFORE a new watch replays the log — on every stream, delivered
    revisions are strictly increasing (the informer fence drops nothing
    silently)."""
    store = Store(coalesce_window_s=10.0)
    try:
        w = store.watch("Pod", frames=True)
        store.create("Pod", _pod(0))  # buffered single
        store.create_many("Pod", [_pod(1), _pod(2)])  # batch txn: barrier
        # a new watcher registering mid-window must not see the pending
        # event duplicated or reordered against its log replay
        w2 = store.watch("Pod", from_revision=0, frames=True)
        store.flush_coalesced()

        def revs(watch):
            out = []
            while True:
                ev = watch.get(timeout=0.1)
                if ev is None:
                    return out
                if ev.type == "FRAME":
                    out.extend(ev.revisions)
                else:
                    out.append(ev.revision)

        r1, r2 = revs(w), revs(w2)
        assert r1 == sorted(r1) and len(set(r1)) == len(r1)
        assert r1 and r1[0] == 1  # the single flushed before the batch
        assert r2 == [1, 2, 3]  # replay covers everything exactly once
        w.stop()
        w2.stop()
    finally:
        store.close()


def test_synthetic_frames_honor_wire_and_cas_contract():
    """A coalesced frame is a first-class WatchFrame: strictly
    increasing revisions (the ``from_wire`` invariant round-trips),
    ``prev_revisions=None`` — folds hide intermediates, so prevs are
    HONESTLY unknown and consumers take the per-object fallback compare
    instead of a fabricated CAS chain."""
    store = Store(coalesce_window_s=10.0)
    try:
        w = store.watch("Pod", frames=True)
        for i in range(3):
            store.create("Pod", _pod(i))
        obj = store.get("Pod", "default", "cp-001")
        obj["status"] = {"phase": "run"}
        store.update("Pod", obj)  # folds into cp-001's create
        store.flush_coalesced()
        fr = w.get(timeout=0.1)
        assert fr.type == "FRAME"
        assert fr.prev_revisions is None
        assert list(fr.revisions) == sorted(fr.revisions)
        assert fr.txn.startswith("coalesce-")
        rt = WatchFrame.from_wire(json.loads(fr.wire_bytes()))
        assert list(rt.revisions) == list(fr.revisions)
        assert rt.prev_revisions is None
        w.stop()
    finally:
        store.close()


def test_shared_encode_one_encoding_per_revision():
    """A frame (or event) serializes once and every watcher shares the
    same bytes object; the bytes equal a fresh encoding of the same wire
    form (the port always shares the encoding)."""
    fr = WatchFrame("Pod", ["ADDED"], ["default/x"], [1],
                    [{"metadata": {"name": "x"}}], None, "t-1")
    b1 = fr.wire_bytes()
    assert fr.wire_bytes() is b1  # cached, not re-encoded
    fr2 = WatchFrame("Pod", ["ADDED"], ["default/x"], [1],
                     [{"metadata": {"name": "x"}}], None, "t-1")
    assert fr2.wire_bytes() == b1 == json.dumps(fr2.to_wire()).encode() + b"\n"

    ev = WatchEvent(type="ADDED", kind="Pod", key="default/x",
                    revision=1, object={"metadata": {"name": "x"}})
    e1 = event_wire_bytes(ev)
    assert event_wire_bytes(ev) is e1
    ev2 = WatchEvent(type="ADDED", kind="Pod", key="default/x",
                     revision=1, object={"metadata": {"name": "x"}})
    assert event_wire_bytes(ev2) == e1 and event_wire_bytes(ev2) is not e1


def test_frame_select_column_level():
    """Selector sub-frames: column subset sharing payloads, None on
    empty selection, identity when everything matches."""
    fr = WatchFrame("Pod", ["ADDED", "MODIFIED", "DELETED"],
                    ["default/a", "default/b", "default/c"], [1, 2, 3],
                    [{"m": 1}, {"m": 2}, None], [0, 1, 2], "t-2")
    sub = fr.select([0, 2])
    assert list(sub.keys) == ["default/a", "default/c"]
    assert list(sub.revisions) == [1, 3]
    assert sub.objects[0] is fr.objects[0]  # shared payload, no copy
    assert list(sub.prev_revisions) == [0, 2]
    assert sub.txn == fr.txn
    assert fr.select([]) is None
    assert fr.select([0, 1, 2]) is fr


def test_deadline_flusher_delivers_without_manual_flush():
    """The daemon flusher honors ``coalesce_window_s`` on its own: a
    buffered single arrives framed within a couple of windows with no
    explicit flush call."""
    store = Store(coalesce_window_s=0.02)
    try:
        w = store.watch("Pod", frames=True)
        store.create("Pod", _pod(0))
        store.create("Pod", _pod(1))
        ev = w.get(timeout=2.0)
        assert ev is not None and ev.type == "FRAME"
        assert list(ev.revisions) == [1, 2]
        w.stop()
    finally:
        store.close()
