"""Continuous telemetry of the port: the time-series rings
(``utils/timeseries.py``), the burn-rate SLOs (``utils/slo.py``), the
per-client fan-out attribution (``utils/fanout.py``), the shipper
(``utils/telemetry.py``) and the daemon's and apiserver's routes.  Twins
of ``tests/test_telemetry.py``; where the outcome is a sequence of events
on an injected clock, the same samples go through both packages and the
breach and recovery events must be equal.

Tolerance: exact equality (events, tracks, counters); burn rates are the
same float arithmetic in both packages and compare equal.
"""

from __future__ import annotations

import importlib
import json
import threading
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.daemon import enable_continuous_telemetry, serve_health, telemetry_sink
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.utils import fanout, slo, telemetry, timeseries, tracing
from kubernetes_tpu_torch.utils.metrics import ClientMetrics, Counter, Gauge, Histogram, Registry
from kubernetes_tpu_torch.utils.slo import SLO, BurnRateEvaluator, QuantileSLI, RatioSLI
from kubernetes_tpu_torch.utils.telemetry import FileSink, HTTPSink, TelemetryShipper
from kubernetes_tpu_torch.utils.timeseries import TimeSeriesStore

PORT, JAX = "kubernetes_tpu_torch", "kubernetes_tpu"


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def advance(self, dt):
        self.now += dt

    def __call__(self):
        return self.now


@pytest.fixture(autouse=True)
def _no_leaked_globals():
    yield
    telemetry.disable()
    timeseries.disable()
    tracing.disable()


def _store(registry, clock):
    return TimeSeriesStore(registry, interval_s=1.0, capacity=600, clock=clock)


# -- 1. the time-series store -------------------------------------------------


def test_scrape_tracks_per_metric_kind():
    clock = FakeClock()
    r = Registry()
    c = r.register(Counter("work_done_total"))
    g = r.register(Gauge("queue_depth"))
    h = r.register(Histogram("op_latency_microseconds"))
    store = _store(r, clock)
    c.inc(3)
    g.set(7)
    h.observe(2000.0)
    clock.advance(1.0)
    out = store.sample_once()
    tracks = store.tracks()
    for suffix in (":p50", ":p90", ":p99", ":count", ":sum"):
        assert f"op_latency_microseconds{suffix}" in tracks
    assert store.last("work_done_total") == 3.0 and store.last("queue_depth") == 7.0
    assert store.last("op_latency_microseconds:count") == 1.0
    assert store.last("op_latency_microseconds:sum") == 2000.0
    assert {s[0] for s in out} == set(tracks)


def test_query_window_delta_rate_and_capacity():
    clock = FakeClock()
    r = Registry()
    c = r.register(Counter("events_total"))
    store = _store(r, clock)
    for _ in range(10):
        clock.advance(1.0)
        c.inc(2)
        store.sample_once()
    assert len(store.query("events_total")) == 10
    assert len(store.query("events_total", window_s=3.0)) == 4
    assert store.delta("events_total", window_s=5.0) == pytest.approx(10.0)
    assert store.rate("events_total", window_s=5.0) == pytest.approx(2.0)
    assert store.delta("events_total", window_s=0.5) == 0.0
    assert store.delta("missing_track", window_s=5.0) == 0.0
    small = TimeSeriesStore(r, capacity=5, clock=clock)
    for _ in range(20):
        clock.advance(1.0)
        c.inc()
        small.sample_once()
    assert len(small.query("events_total")) == 5
    assert small.query("events_total")[-1][1] == c.value


def test_to_dict_serializes_nonfinite_as_none():
    clock = FakeClock()
    r = Registry()
    h = r.register(Histogram("lat_microseconds", buckets=[1.0, 2.0]))
    store = _store(r, clock)
    h.observe(1e9)
    clock.advance(1.0)
    store.sample_once()
    doc = store.to_dict()
    assert doc["enabled"] and doc["scrapes"] == 1
    assert doc["tracks"]["lat_microseconds:p99"][-1][1] is None
    json.dumps(doc)


def test_observer_errors_never_kill_the_scrape():
    clock = FakeClock()
    r = Registry()
    r.register(Counter("events_total"))
    store = _store(r, clock)
    seen = []
    store.add_observer(lambda samples: seen.append(len(samples)))
    store.add_observer(lambda samples: 1 / 0)
    for _ in range(2):
        clock.advance(1.0)
        store.sample_once()
    assert store.scrapes == 2 and store.observer_errors == 2 and len(seen) == 2


def test_scrape_ring_correct_under_concurrent_writers():
    """Writer threads hammer a counter while a scraper samples: the
    scraped cumulative track never decreases and ends at the total."""
    r = Registry()
    c = r.register(Counter("events_total"))
    store = TimeSeriesStore(r, capacity=10_000)
    stop = threading.Event()

    def writer():
        for _ in range(2000):
            c.inc()

    def scraper():
        while not stop.is_set():
            store.sample_once()

    ts = [threading.Thread(target=writer) for _ in range(4)]
    sc = threading.Thread(target=scraper)
    sc.start()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    stop.set()
    sc.join()
    store.sample_once()
    values = [v for _, v in store.query("events_total")]
    assert values == sorted(values) and values[-1] == 8000.0


# -- 2. the burn-rate evaluator against the JAX one ---------------------------


def _ratio_run(pkg, script, recovery=3):
    """Feed ``script`` — (total, bad) increments a tick — through package
    ``pkg``'s store and evaluator on an injected clock; returns the
    events a tick (the burn rates included) and the final state."""
    imp = importlib.import_module
    metrics = imp(f"{pkg}.utils.metrics")
    ts = imp(f"{pkg}.utils.timeseries")
    slo_mod = imp(f"{pkg}.utils.slo")
    clock = FakeClock()
    r = metrics.Registry()
    bad = r.register(metrics.Counter("bad_total"))
    total = r.register(metrics.Counter("all_total"))
    store = ts.TimeSeriesStore(r, interval_s=1.0, capacity=600, clock=clock)
    spec = slo_mod.SLO(name="x", sli=slo_mod.RatioSLI(bad_metric="bad_total",
                                                      total_metric="all_total"),
                       objective=0.99, fast_window_s=10.0, slow_window_s=50.0,
                       fast_burn=14.4, slow_burn=6.0, recovery_evals=recovery)
    ev = slo_mod.BurnRateEvaluator(slos=[spec], store=store)
    out = []
    for t_inc, b_inc in script:
        clock.advance(1.0)
        if t_inc:
            total.inc(t_inc)
        if b_inc:
            bad.inc(b_inc)
        store.sample_once()
        out.append(ev.evaluate())
    return out, ev.state("x")["breached"], ev.breaches_fired


SLO_SCRIPTS = {
    "no_data": [(0, 0)] * 60,
    "fast_window_alone": [(100, 0)] * 50 + [(100, 80)] * 2,
    "sustained_then_clean": [(10, 10)] * 60 + [(10, 0)] * 60,
    "oscillating": [(10, 10)] * 60 + [(10, 10 * (i % 2)) for i in range(20)],
}


@pytest.mark.parametrize("name", sorted(SLO_SCRIPTS))
def test_breach_and_recovery_events_equal_the_jax_evaluators(name):
    port = _ratio_run(PORT, SLO_SCRIPTS[name])
    assert port == _ratio_run(JAX, SLO_SCRIPTS[name])
    events, breached, fired = port
    kinds = [e["type"] for evs in events for e in evs]
    if name in ("no_data", "fast_window_alone"):
        assert kinds == [] and not breached
    elif name == "sustained_then_clean":
        assert kinds == ["breach", "recovered"] and not breached and fired == 1
        first = next(e for evs in events for e in evs)
        assert first["fast_burn"] >= 14.4 and first["slow_burn"] >= 6.0
        cleared = next(i for i, evs in enumerate(events) if evs and evs[0]["type"] == "recovered")
        assert cleared >= 62  # three clean evaluations after the burn cleared
    else:
        assert kinds == ["breach"] and breached and fired == 1


def test_quantile_sli_reads_the_scraped_track():
    clock = FakeClock()
    r = Registry()
    h = r.register(Histogram("lat_microseconds"))
    store = _store(r, clock)
    sli = QuantileSLI(metric="lat_microseconds", threshold=5000.0)
    assert sli.bad_fraction(store, 10.0) is None
    for v in (1000.0, 1000.0, 900000.0, 900000.0):
        h.observe_many(v, 50)
        clock.advance(1.0)
        store.sample_once()
    frac = sli.bad_fraction(store, 10.0)
    assert frac is not None and 0.0 < frac <= 1.0


def test_breach_fires_flight_dump_with_window_attached():
    tracing.enable()
    clock = FakeClock()
    r = Registry()
    bad = r.register(Counter("bad_total"))
    total = r.register(Counter("all_total"))
    store = _store(r, clock)
    ev = BurnRateEvaluator(slos=[SLO(name="x", sli=RatioSLI(bad_metric="bad_total",
                                                            total_metric="all_total"),
                                     fast_window_s=10.0, slow_window_s=50.0)], store=store)
    for _ in range(60):
        clock.advance(1.0)
        total.inc(10)
        bad.inc(10)
        store.sample_once()
        ev.evaluate()
    dumps = [d for d in tracing.current().dumps if d["reason"] == "slo:x"]
    assert len(dumps) == 1
    assert set(dumps[0]["attrs"]["window"]) == {"bad_total", "all_total"}


def test_monitor_attaches_to_the_active_store_and_default_slos_resolve():
    """``slo.monitor`` rides every scrape; the standing SLOs name metrics
    the port's registries register."""
    from kubernetes_tpu_torch.utils.metrics import SchedulerMetrics

    clock = FakeClock()
    r = Registry()
    total = r.register(Counter("scheduler_schedule_attempts_total"))
    store = timeseries.enable(r, clock=clock, start_thread=False)
    ev = slo.monitor(store=store)
    assert ev is not None and ev.store is store
    clock.advance(1.0)
    total.inc()
    store.sample_once()
    assert timeseries.current() is store
    names = {m.name for m in SchedulerMetrics().registry.snapshot()}
    names |= {m.name for m in ClientMetrics().registry.snapshot()}
    for spec in slo.DEFAULT_SLOS + slo.serving_slos():
        assert {t.split(":")[0] for t in spec.sli.tracks()} <= names, spec.name


# -- 3. the per-client fan-out attribution ------------------------------------


def test_fanout_worst_client_and_top_laggards_equal_the_jax_trackers():
    def run(pkg):
        imp = importlib.import_module
        fo = imp(f"{pkg}.utils.fanout")
        metrics = imp(f"{pkg}.utils.metrics").ClientMetrics()
        tr = fo.WatchFanoutTracker(metrics=metrics)
        for i in range(6):
            tr.register(f"c{i}")
        tr.observe_head(100)
        for i in range(6):
            tr.report(f"c{i}", 100 - 7 * i)
        worst = tr.sample()
        return worst, metrics.watch_worst_staleness.value, tr.top_laggards(3)

    port = run(PORT)
    assert port == run(JAX)
    worst, gauge, top = port
    assert worst == 35 and gauge == 35.0
    assert [d["client"] for d in top] == ["c5", "c4", "c3"]


# -- 4. the shipper -----------------------------------------------------------


class _FlakySink:
    def __init__(self, fail_times, exc=None):
        self.fail_times = fail_times
        self.exc = exc or ConnectionResetError("collector hiccup")
        self.batches = []

    def ship(self, batch):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise self.exc
        self.batches.append(list(batch))


def test_shipper_retries_then_delivers_or_dead_letters():
    shp = TelemetryShipper(_FlakySink(fail_times=2), retries=3, backoff_s=0.0,
                           sleep=lambda s: None)
    assert shp.offer({"kind": "x"}) and shp.drain_all() == 1
    s = shp.stats()
    assert s["shipped"] == 1 and s["ship_retries"] == 2 and s["dead"] == 0
    shp = TelemetryShipper(_FlakySink(fail_times=99), retries=2, backoff_s=0.0,
                           sleep=lambda s: None)
    shp.offer({"kind": "x"})
    shp.offer({"kind": "y"})
    assert shp.drain_all() == 0
    s = shp.stats()
    assert s["dead_lettered"] == 2 and s["ship_retries"] == 2
    assert [r["kind"] for r in shp.dead] == ["x", "y"]


def test_shipper_fatal_4xx_skips_retries_and_backoff_doubles_and_caps():
    err = urllib.error.HTTPError("u", 400, "Bad Request", None, None)
    shp = TelemetryShipper(_FlakySink(99, exc=err), retries=5, backoff_s=0.0,
                           sleep=lambda s: None)
    shp.offer({"kind": "x"})
    shp.drain_all()
    assert shp.stats()["dead_lettered"] == 1 and shp.stats()["ship_retries"] == 0
    sleeps = []
    shp = TelemetryShipper(_FlakySink(99), retries=4, backoff_s=0.1, backoff_max_s=0.3,
                           sleep=sleeps.append)
    shp.offer({"kind": "x"})
    shp.drain_all()
    assert sleeps == pytest.approx([0.1, 0.2, 0.3, 0.3])


def test_shipper_bounds_overflow_dead_ring_and_feedback():
    shp = TelemetryShipper(_FlakySink(0), queue_max=2)
    assert shp.offer({"n": 1}) and shp.offer({"n": 2}) and not shp.offer({"n": 3})
    assert shp.stats()["overflow"] == 1 and shp.pending() == 2
    shp = TelemetryShipper(_FlakySink(10 ** 6), retries=0, dead_max=4, batch_max=1,
                           backoff_s=0.0, sleep=lambda s: None)
    for i in range(10):
        shp.offer({"n": i})
    shp.drain_all()
    assert [r["n"] for r in shp.dead] == [6, 7, 8, 9]
    shp = TelemetryShipper(None, retries=0, backoff_s=0.0, sleep=lambda s: None)

    class _ReentrantSink:
        def ship(self, batch):
            assert not shp.offer({"kind": "feedback"})

    shp.sink = _ReentrantSink()
    shp.offer({"kind": "x"})
    assert shp.drain_all() == 1 and shp.stats()["feedback_dropped"] == 1


def test_file_sink_worker_thread_and_timeseries_observer(tmp_path):
    path = str(tmp_path / "telemetry.ndjson")
    shp = telemetry.enable(FileSink(path), flush_interval_s=0.01)
    for i in range(5):
        shp.offer({"n": i})
    for _ in range(200):
        if shp.stats()["shipped"] == 5:
            break
        threading.Event().wait(0.01)
    telemetry.disable()
    assert [json.loads(line)["n"] for line in open(path) if line.strip()] == [0, 1, 2, 3, 4]
    clock = FakeClock()
    r = Registry()
    c = r.register(Counter("events_total"))
    store = _store(r, clock)
    shp = TelemetryShipper(_FlakySink(0))
    store.add_observer(telemetry.timeseries_observer(shp))
    c.inc()
    clock.advance(1.0)
    store.sample_once()
    shp.drain_all()
    [batch] = shp.sink.batches
    [rec] = batch
    assert rec["kind"] == "timeseries" and ["events_total", 1.0, 1.0] in rec["samples"]


# -- 5. the daemons' routes and the off-box path ------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.headers.get("Content-Type", ""), resp.read()


def test_serve_health_exposes_the_shared_route_contract():
    r = Registry()
    r.register(Counter("daemon_things_total")).inc(3)
    srv = serve_health(0, r)
    try:
        base = f"http://127.0.0.1:{srv.local_port}"
        assert json.loads(_get(base + "/healthz")[1]) == {"status": "ok"}
        ctype, body = _get(base + "/metrics")
        assert "text/plain" in ctype and "daemon_things_total 3" in body.decode()
        for route in ("/debug/traces", "/debug/flightrecorder", "/debug/timeseries"):
            assert json.loads(_get(base + route)[1]) == {"enabled": False}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/not-a-route")
        assert ei.value.code == 404
        clock = FakeClock()
        c = r.register(Counter("more_total"))
        tracing.enable()
        store = timeseries.enable(r, clock=clock, start_thread=False)
        c.inc()
        clock.advance(1.0)
        store.sample_once()
        tracing.current().dump("probe")
        doc = json.loads(_get(base + "/debug/timeseries")[1])
        assert doc["enabled"] and "more_total" in doc["tracks"]
        doc = json.loads(_get(base + "/debug/flightrecorder")[1])
        assert [d["reason"] for d in doc["dumps"]] == ["probe"]
    finally:
        srv.stop()


def test_apiserver_serves_the_debug_routes_and_telemetry_ingest():
    server = APIServer(Store())
    server.start()
    try:
        ctype, body = _get(server.url + "/metrics")
        assert "text/plain" in ctype and "apiserver_request_count" in body.decode()
        assert json.loads(_get(server.url + "/debug/timeseries")[1]) == {"enabled": False}
        req = urllib.request.Request(server.url + "/metrics", data=b"x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 405
        req = urllib.request.Request(server.url + "/telemetry", data=b"\xff{not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 400 and server.telemetry_snapshot() == []
        req = urllib.request.Request(server.url + "/telemetry", method="POST",
                                     data=b'{"n": 1}\n{"n": 2}\n',
                                     headers={"Content-Type": "application/x-ndjson"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert json.loads(resp.read())["accepted"] == 2
        doc = json.loads(_get(server.url + "/telemetry")[1])
        assert doc["kind"] == "TelemetryRecordList" and doc["items"] == [{"n": 1}, {"n": 2}]
        assert "apiserver_telemetry_accepted_total 2" in _get(server.url + "/metrics")[1].decode()
    finally:
        server.stop()


def test_e2e_breach_ships_correlated_flight_dump_off_process():
    """Scraped rings, a burn-rate breach, a flight dump carrying the
    txn-correlated wave span, the HTTP sink, the apiserver's /telemetry."""
    server = APIServer(Store())
    server.start()
    clock = FakeClock()
    r = Registry()
    bad = r.register(Counter("scheduler_bind_requeues_total"))
    total = r.register(Counter("scheduler_schedule_attempts_total"))
    try:
        tracer = tracing.enable(clock=clock)
        store = timeseries.enable(r, clock=clock, start_thread=False)
        ev = slo.monitor(slos=[SLO(name="bind_requeue_rate", sli=RatioSLI(
            bad_metric="scheduler_bind_requeues_total",
            total_metric="scheduler_schedule_attempts_total"),
            fast_window_s=10.0, slow_window_s=50.0)], store=store)
        shp = telemetry.enable(HTTPSink(server.url + "/telemetry"), registry=r,
                               start_thread=False)
        store.add_observer(telemetry.timeseries_observer(shp))
        with tracer.wave(txn="txn-breach-042"):
            pass
        for _ in range(60):
            clock.advance(1.0)
            total.inc(10)
            bad.inc(10)
            store.sample_once()
        assert ev.breaches_fired == 1
        shp.drain_all()
        assert shp.stats()["dead_lettered"] == 0
        dumps = [rec for rec in server.telemetry_snapshot() if rec.get("kind") == "flight_dump"]
        assert [d["reason"] for d in dumps] == ["slo:bind_requeue_rate"]
        assert "txn-breach-042" in [w["attrs"].get("txn") for w in dumps[0]["dump"]["waves"]]
    finally:
        server.stop()


def test_enable_continuous_telemetry_wires_the_full_stack_and_sink_specs(tmp_path):
    r = Registry()
    c = r.register(Counter("daemon_things_total"))
    sink_path = str(tmp_path / "out.ndjson")
    store = enable_continuous_telemetry(r, interval_s=999.0, sink_spec=sink_path)
    assert timeseries.current() is store
    assert isinstance(telemetry.current().sink, FileSink)
    c.inc()
    store.sample_once()
    telemetry.disable()
    timeseries.disable()
    lines = [json.loads(line) for line in open(sink_path) if line.strip()]
    assert lines and lines[0]["kind"] == "timeseries"
    assert isinstance(telemetry_sink("http://host:1/telemetry"), HTTPSink)
    assert isinstance(telemetry_sink("https://host/t"), HTTPSink)
    assert isinstance(telemetry_sink("/tmp/x.ndjson"), FileSink)
    assert fanout.WatchFanoutTracker  # the serving SLO's source is part of the port
