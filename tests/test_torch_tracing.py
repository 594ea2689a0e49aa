"""Wave tracing and the flight recorder of the port (``utils/tracing.py``):
twin of ``tests/test_tracing.py`` without its breaker and frontier cases
(the port has neither).

1. the span layer: tree nesting, per-thread stacks, leaked spans, the
   ring and dump bounds, the disabled path, the notify hooks;
2. end-to-end: a ``bind_many`` txn id on the store's, the informer's and
   the scheduler's spans of one Chrome export; the wave's phase split
   derived from its spans; the daemon's ``/debug/*`` routes;
3. every fault point of the port's registry dumps the firing wave's trace;
4. parity: on the same seeded in-process churn waves the port's span
   names and nesting equal the JAX package's (attributes aside: the
   JAX spans carry its ladder rung and frontier, the port's its CUDA
   plan and kernel milliseconds);
5. ``utils/trace.py``: ``Trace.log_if_long`` on the shared rendering.
"""

from __future__ import annotations

import importlib
import json
import os
import threading

import pytest

from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan, FaultSpec
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testutil import make_node, make_pod
from kubernetes_tpu_torch.utils import tracing
from kubernetes_tpu_torch.utils.trace import Trace
from tests.test_torch_faults import JAX, MATRIX, PORT, FakeClock, World, _mods


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    yield
    tracing.disable()


# -- 1. the span layer --------------------------------------------------------


def test_disabled_path_is_inert():
    assert tracing.current() is None
    tracing.notify_fault("store.commit", {"op": "x"}, "error")
    tracing.notify_requeue("default/p")
    assert not hasattr(tracing, "notify_breaker")  # no breaker in the port
    a, b = tracing.next_txn("bind_many"), tracing.next_txn("create_many")
    assert a != b and a.startswith("bind_many-")


def test_span_tree_nesting_and_ring():
    clk = FakeClock()
    tr = tracing.enable(clock=clk, ring_waves=2)
    with tr.wave(pods=3) as w:
        clk.advance(1.0)
        with tr.span("tensorize", cat="phase"):
            clk.advance(0.5)
        with tr.span("dispatch", cat="phase", impl="cuda"):
            clk.advance(0.25)
            with tr.span("inner"):
                clk.advance(0.1)
    assert [c.name for c in w.children] == ["tensorize", "dispatch"]
    assert w.children[1].children[0].name == "inner"
    assert w.t1 is not None and w.duration == pytest.approx(1.85)
    assert w.phase_totals() == {"tensorize_s": pytest.approx(0.5),
                                "dispatch_s": pytest.approx(0.35)}
    with tr.wave():
        pass
    with tr.wave():
        pass
    assert [s.attrs["wave"] for s in tr.ring] == [2, 3]
    with tr.span("store.txn", cat="store"):
        pass
    assert tr.background[-1].name == "store.txn"


def test_leaked_open_child_is_unwound():
    clk = FakeClock()
    tr = tracing.enable(clock=clk)
    cm_outer = tr.span("outer")
    outer = cm_outer.__enter__()
    child = tr.span("child").__enter__()
    clk.advance(1.0)
    cm_outer.__exit__(None, None, None)
    assert child.t1 == outer.t1 == 1.0
    with tr.span("after") as sp:
        pass
    assert sp in tr.background


def test_spans_on_other_threads_are_separate_roots():
    tr = tracing.enable()
    with tr.wave() as w:
        def off_thread():
            with tr.span("informer.frame.apply", cat="ingest"):
                pass
        t = threading.Thread(target=off_thread)
        t.start()
        t.join()
    assert w.children == []
    assert tr.background[-1].name == "informer.frame.apply"
    assert tr.background[-1].tid != w.tid


def test_flight_recorder_bounds_and_dump_dir(tmp_path):
    clk = FakeClock()
    tr = tracing.enable(clock=clk, ring_waves=2, max_dumps=2, dump_dir=str(tmp_path))
    with tr.wave():
        clk.advance(1.0)
    tr.instant("marker", frac=0.5)
    for i in range(3):
        tr.dump(f"reason-{i}")
    assert len(tr.dumps) == 2 and tr.dropped_dumps == 1
    assert [d["reason"] for d in tr.dumps] == ["reason-1", "reason-2"]
    assert all(len(d["waves"]) == 1 for d in tr.dumps)
    assert tr.dumps[-1]["instants"][-1]["name"] == "marker"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "flight_0001.json", "flight_0002.json", "flight_0003.json"]
    with open(tmp_path / "flight_0003.json") as f:
        assert json.load(f)["reason"] == "reason-2"
    snap = tr.flight_snapshot()
    assert len(tr.dumps) == 2
    assert snap["dropped_dumps"] == 1 and len(snap["current"]["waves"]) == 1


def test_notify_hooks_never_crash_and_dump_with_reasons():
    tr = tracing.enable()
    tracing.notify_fault("scheduler.bind", {"via": "bind_many"}, "drop")
    tracing.notify_requeue("default/p-0")
    assert [d["reason"] for d in tr.dumps] == ["fault:scheduler.bind", "bind.requeue"]
    assert tr.dumps[0]["attrs"]["mode"] == "drop"
    assert [e["name"] for e in tr.instants] == ["fault.scheduler.bind", "bind.requeue"]

    def boom(*a, **k):
        raise RuntimeError("recorder bug")

    tr.dump = boom
    tracing.notify_fault("store.commit", {"op": "x"}, "error")
    tracing.notify_requeue("default/p")


def test_requeue_dumps_coalesce_per_window():
    clk = FakeClock()
    tr = tracing.enable(clock=clk)
    for i in range(50):
        tracing.notify_requeue(f"default/p-{i}")
    assert len([d for d in tr.dumps if d["reason"] == "bind.requeue"]) == 1
    assert tr.coalesced_dumps == 49
    assert len([e for e in tr.instants if e["name"] == "bind.requeue"]) == 50
    clk.advance(tracing.REQUEUE_DUMP_COALESCE_S + 0.1)
    tracing.notify_requeue("default/p-late")
    assert len([d for d in tr.dumps if d["reason"] == "bind.requeue"]) == 2


# -- 2. end to end ------------------------------------------------------------


def _mini_world(n_nodes=4, clock=None):
    cs = Clientset(Store())
    for i in range(n_nodes):
        cs.nodes.create(make_node(f"n{i}", cpu="8", memory="16Gi"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    sched = Scheduler(cs, algorithm=algo, backend=backend,
                      **({"clock": clock} if clock is not None else {}))
    sched.start()
    return cs, sched, backend


def _txn_spans(doc):
    out: dict[str, set] = {}
    for ev in doc["traceEvents"]:
        txn = (ev.get("args") or {}).get("txn")
        if txn:
            out.setdefault(txn, set()).add(ev["name"])
    return out


def test_end_to_end_txn_correlation():
    tr = tracing.enable()
    cs, sched, _ = _mini_world()
    cs.pods.create_many([make_pod(f"p{i}", cpu="100m") for i in range(12)])
    sched.pump()
    assert sched.schedule_pending_batch() == (12, 0)
    sched.pump()
    txns = _txn_spans(tr.chrome_trace())
    bind_txns = [t for t in txns if t.startswith("bind_many-")]
    assert bind_txns
    for txn in bind_txns:
        assert {"store.txn", "informer.frame.apply", "scheduler.confirm"} <= txns[txn]
    assert any({"store.txn", "informer.frame.apply"} <= txns[t]
               for t in txns if t.startswith("create_many-"))


def test_chrome_export_validates_and_phases_derive_from_trace():
    tr = tracing.enable()
    cs, sched, backend = _mini_world()
    cs.pods.create_many([make_pod(f"p{i}", cpu="100m") for i in range(8)])
    sched.pump()
    sched.schedule_pending_batch()
    wave = tr.ring[-1]
    totals = wave.phase_totals()
    for key in ("tensorize_s", "dispatch_s", "device_wait_s", "commit_s"):
        assert sched.last_batch_phases[key] == totals[key]
    # the stats timers and the spans are the same clock reads
    assert totals["tensorize_s"] == pytest.approx(backend.stats["tensorize_s"])
    assert wave.attrs["pods"] == 8 and wave.attrs["bound"] == 8
    dispatch = [c for c in wave.children if c.name == "dispatch"]
    assert len(dispatch) == 1 and dispatch[0].attrs["impl"] == "cpu"
    doc = tr.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    for ev in events:
        assert ev["ph"] in ("X", "i") and ev["name"] and ev["pid"] == 1
        assert isinstance(ev["ts"], float) and ev["ts"] >= 0.0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    assert len(json.loads(json.dumps(doc))["traceEvents"]) == len(events)
    names = {e["name"] for e in events}
    assert {"store.txn", "tensorize", "dispatch", "device_wait", "commit"} <= names
    assert any(n.startswith("wave-") for n in names)


def test_a_failed_wave_closes_its_root_with_the_error():
    """An injected kernel failure raises out of the wave: the root span
    closes (no leak adopts the next wave) and carries the error."""
    tr = tracing.enable()
    cs, sched, _ = _mini_world()
    cs.pods.create_many([make_pod(f"p{i}", cpu="100m") for i in range(4)])
    sched.pump()
    with FaultPlan().on("backend.pallas.segment", mode="error", first_n=1).armed():
        with pytest.raises(FaultInjected):
            sched.schedule_pending_batch()
    failed = tr.ring[-1]
    assert failed.t1 is not None and "FaultInjected" in failed.attrs["error"]
    assert sched.schedule_pending_batch() == (4, 0)
    assert tr.ring[-1].attrs["wave"] == failed.attrs["wave"] + 1
    assert not tr._open_roots


def test_debug_endpoints_serve_traces_and_flightrecorder():
    import urllib.request

    from kubernetes_tpu_torch.daemon import serve_health

    server = serve_health(0)
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{server.local_port}{path}",
                                        timeout=5) as resp:
                return json.loads(resp.read())

        assert get("/debug/traces") == {"enabled": False}
        assert get("/debug/flightrecorder") == {"enabled": False}
        assert get("/debug/timeseries") == {"enabled": False}
        tr = tracing.enable()
        with tr.wave(pods=1):
            with tr.span("tensorize", cat="phase"):
                pass
        tr.dump("fault:store.commit", mode="error")
        names = {e["name"] for e in get("/debug/traces")["traceEvents"]}
        assert "wave-1" in names and "tensorize" in names
        snap = get("/debug/flightrecorder")
        assert snap["enabled"] is True
        assert [d["reason"] for d in snap["dumps"]] == ["fault:store.commit"]
    finally:
        server.stop()


# -- 3. every fault point dumps the firing wave's trace -----------------------

# points whose site runs inside an open wave: the dump holds the live root
_IN_WAVE = {"scheduler.bind", "backend.pallas.segment", "scheduler.pipeline.prep",
            "store.commit"}


def _has_wave(span_dicts, require_open=False):
    return any(d.get("cat") == "wave" and (not require_open or d["t1"] is None)
               for d in span_dicts)


def _warm(w, realtime=False):
    for i in range(8):
        w.cs.pods.create(make_pod(f"warm-{i:03d}", cpu="200m", memory="256Mi"))
    w.drive(rounds=4, relist_every=0, realtime=realtime)
    assert len(tracing.current().ring) >= 1, "the warm phase completed no wave"


def _fire(point, tmp_path):
    scenario = MATRIX[point]
    M = _mods(PORT)
    server = None
    if scenario["world"] in ("remote", "admit"):
        server = M.APIServer(Store())
        server.start()
    own_store = None
    if scenario["world"] == "wal":
        own_store = Store(data_dir=str(tmp_path / "state"))
    elif scenario["world"] == "coalesce":
        own_store = Store(coalesce_window_s=0.02)
    w = None
    try:
        w = World(PORT, server=server, store=own_store)
        # the coalescing window's deadline runs on the wall clock
        realtime = server is not None or scenario["world"] == "coalesce"
        _warm(w, realtime)
        if scenario["world"] == "telemetry":
            from kubernetes_tpu_torch.utils import telemetry, timeseries

            plan = FaultPlan(seed=3).on(point, mode="error")
            try:
                store = timeseries.enable(w.sched.metrics.registry, interval_s=1.0,
                                          clock=w.clock, start_thread=False)
                shp = telemetry.enable(telemetry.FileSink(os.devnull),
                                       registry=w.sched.metrics.registry, start_thread=False,
                                       retries=1, backoff_s=0.0, sleep=lambda s: None)
                store.add_observer(telemetry.timeseries_observer(shp))
                with plan.armed():
                    store.sample_once()
                    shp.drain_all()
            finally:
                telemetry.disable()
                timeseries.disable()
        elif scenario["world"] == "admit":
            plan = FaultPlan(seed=3).on(point, mode="drop", value=0.05, first_n=1)
            with plan.armed():
                Clientset(w.remote).pods.create(make_pod("admit-marker", cpu="100m"))
        elif scenario["world"] == "wal":
            # the torn append of a write after the warm waves: the crash
            plan = FaultPlan(seed=3).on(point, FaultSpec(**scenario["spec"]))
            with plan.armed():
                with pytest.raises(FaultInjected):
                    w.cs.pods.create(make_pod("marker", cpu="100m"))
        else:
            plan = FaultPlan(seed=42).on(point, FaultSpec(**scenario["spec"]))
            with plan.armed():
                for i in range(16):
                    w.cs.pods.create(make_pod(f"work-{i:03d}", cpu="200m", memory="256Mi"))
                w.drive(rounds=8, relist_every=4, realtime=realtime)
        assert plan.fired.get(point, 0) > 0, f"{point}: the fault never fired"
    finally:
        if own_store is not None:
            own_store.close()
        if server is not None:
            if w is not None:
                w.sched.informers.stop_all()
            server.stop()


@pytest.mark.timeout(180)
@pytest.mark.parametrize("point", sorted(MATRIX))
def test_every_fault_point_dumps_the_firing_waves_trace(point, tmp_path):
    tr = tracing.enable()
    _fire(point, tmp_path)
    dumps = [d for d in tr.dumps if d["reason"] == f"fault:{point}"]
    assert dumps, f"{point}: no dump (saw {[d['reason'] for d in tr.dumps]})"
    d = dumps[0]
    assert _has_wave(d["waves"]) or _has_wave(d["live"]), f"{point}: no wave in the dump"
    if point in _IN_WAVE:
        assert _has_wave(d["live"], require_open=True), f"{point}: no live wave span"
    if point == "scheduler.bind":
        assert any(x["reason"] == "bind.requeue" for x in tr.dumps)


# -- 4. span parity with the JAX package --------------------------------------


def _shape(span: dict):
    """A span's name and its children's shapes, in order (attributes
    aside), a run of same-named leaves counted once: the prep polls the
    informers while the scan runs, as often as the scan's length allows."""
    kids = []
    for c in span.get("children", []):
        k = _shape(c)
        if not (kids and kids[-1] == k and not k[1]):
            kids.append(k)
    return (span["name"], kids)


def _churn_trace(pkg: str) -> list:
    """Two seeded churn waves through package ``pkg``'s scheduler in
    process, tracing on: the wave roots as dicts."""
    M = _mods(pkg)
    tr_mod = importlib.import_module(f"{pkg}.utils.tracing")
    tr = tr_mod.enable()
    try:
        cs = M.Clientset(M.Store())
        for i, (cpu, mem) in enumerate([("8", "16Gi"), ("4", "8Gi"), ("16", "32Gi")]):
            cs.nodes.create(M.make_node(f"n{i}", cpu=cpu, memory=mem))
        algo = M.GenericScheduler()
        backend = M.backend(None) if pkg == PORT else importlib.import_module(
            f"{pkg}.ops").TPUBatchBackend(algorithm=algo)
        backend.algorithm = algo
        sched = M.Scheduler(cs, algorithm=algo, backend=backend)
        sched.start()
        for wave in range(2):
            cs.pods.create_many([M.make_pod(f"w{wave}-{i}", cpu=f"{100 + 50 * (i % 3)}m")
                                 for i in range(10)])
            sched.pump()
            assert sched.schedule_pending_batch() == (10, 0)
        sched.pump()
        return [s.to_dict() for s in tr.ring]
    finally:
        tr_mod.disable()


def test_wave_span_names_and_nesting_equal_the_jax_packages():
    port, jax = _churn_trace(PORT), _churn_trace(JAX)
    assert len(port) == len(jax) == 2
    assert [_shape(w) for w in port] == [_shape(w) for w in jax]
    names = {n for w in port for n in json.dumps(_shape(w)).split('"')}
    assert {"tensorize", "dispatch", "device_wait", "commit", "prep", "ingest.pump"} <= names


# -- 5. utils/trace.py --------------------------------------------------------


def test_log_if_long_over_threshold_logs_step_deltas(caplog):
    clk = FakeClock()
    t = Trace("schedule_one", clock=clk)
    clk.advance(0.120)
    t.step("predicates done")
    clk.advance(0.030)
    t.step("priorities done")
    clk.advance(0.010)
    with caplog.at_level("INFO", logger="kubernetes_tpu_torch.trace"):
        t.log_if_long(0.100)
    assert len(caplog.records) == 1
    msg = caplog.records[0].message
    assert 'Trace "schedule_one" (total 160.0ms):' in msg
    assert "+120.0ms predicates done" in msg and "+30.0ms priorities done" in msg


def test_log_if_long_under_threshold_is_silent(caplog):
    clk = FakeClock()
    t = Trace("schedule_one", clock=clk)
    clk.advance(0.010)
    with caplog.at_level("INFO", logger="kubernetes_tpu_torch.trace"):
        t.log_if_long(0.100)
    assert caplog.records == []


def test_trace_lands_in_active_tracer_with_steps():
    clk = FakeClock()
    tr = tracing.enable(clock=clk)
    t = Trace("schedule_one", clock=clk)
    clk.advance(0.5)
    t.step("scored")
    t.log_if_long(10.0)
    t.log_if_long(10.0)
    recorded = [s for s in tr.background if s.name == "schedule_one"]
    assert len(recorded) == 1 and recorded[0].cat == "trace"
    assert recorded[0].steps == [(0.5, "scored")]


def test_slow_wave_logging_uses_format_slow(caplog):
    clk = FakeClock()
    tr = tracing.enable(clock=clk, slow_wave_s=1.0)
    with caplog.at_level("INFO", logger="kubernetes_tpu_torch.tracing"):
        with tr.wave() as w:
            clk.advance(0.2)
            w.step(clk(), "tensorized")
            clk.advance(1.0)
    assert len(caplog.records) == 1
    assert 'Trace "wave-1" (total 1200.0ms):' in caplog.records[0].message
    assert tracing.format_slow("op", 1.0, [(1.2, "a")], 1.6).splitlines() == [
        'Trace "op" (total 600.0ms):', "  +200.0ms a"]
