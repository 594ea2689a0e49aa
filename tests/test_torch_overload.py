"""Overload control in the port (``utils/overload.py``, the scheduler's
``attach_overload`` and the apiserver's admission gate): twin of
``tests/test_overload.py``.

- the degradation ladder's transitions on an injected clock equal the JAX
  ladder's, event script for event script, and so do the burn-rate
  evaluator's breach and recovery under the same gauge samples;
- at rung 2 the bindings and the round-robin counter of
  ``BatchBackend(device="cpu")`` equal the JAX ``TPUBatchBackend``'s with
  ``shed_score_planes=True``, and at rung 0 both equal the oracle;
- the admission throttle answers 429 with ``Retry-After`` over HTTP, and
  the port's ``RemoteStore`` honours it;
- the batch loop re-reads the ladder: wider accumulation at rung 1, a
  critical pod cuts the widened window, preemption reserved for the
  critical tier at rung 2.

Tolerance: exact equality (rungs, histories, bindings, counters).
"""

from __future__ import annotations

import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.client.remote import (
    RETRYABLE_STATUS,
    RemoteStore,
    RetryExhaustedError,
    _parse_retry_after,
)
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testutil import make_node, make_pod
from kubernetes_tpu_torch.utils import tracing
from kubernetes_tpu_torch.utils.metrics import Counter, Gauge, Registry
from kubernetes_tpu_torch.utils.overload import (
    MAX_RUNG,
    RUNG_NAMES,
    AdmissionThrottle,
    DegradationLadder,
    PriorityTierClassifier,
    overload_slos,
)
from kubernetes_tpu_torch.utils.slo import GaugeSLI
from kubernetes_tpu_torch.utils.timeseries import TimeSeriesStore

PORT, JAX = "kubernetes_tpu_torch", "kubernetes_tpu"


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


BREACH = [{"type": "breach", "slo": "overload_queue_depth"}]
RECOVERED = [{"type": "recovered", "slo": "overload_queue_depth"}]


def _ov(pkg):
    return importlib.import_module(f"{pkg}.utils.overload")


def _ladder(pkg=PORT, **kw):
    ov = _ov(pkg)
    kw.setdefault("slos", ov.overload_slos())
    kw.setdefault("step_hold_s", 4.0)
    kw.setdefault("recover_hold_s", 6.0)
    return ov.DegradationLadder(**kw)


# -- 1. the ladder against the JAX ladder, on an injected clock ---------------

SCRIPTS = {
    "engage_then_step_after_hold": [(BREACH, 0.0), ([], 1.0), ([], 3.9), ([], 4.0),
                                    ([], 7.9), ([], 8.0), ([], 100.0)],
    "recover_one_rung_per_hold": [(BREACH, 0.0), ([], 4.0), ([], 8.0), (RECOVERED, 10.0),
                                  ([], 13.9), ([], 14.0), ([], 14.1), ([], 20.0),
                                  ([], 26.0), ([], 100.0)],
    "re_breach_during_recovery": [(BREACH, 0.0), (RECOVERED, 1.0), ([], 7.0), (BREACH, 8.0)],
    "oscillation": [(BREACH if int(t * 4) % 2 == 0 else RECOVERED, t)
                    for t in (k * 0.25 for k in range(120))],
}


def _play(pkg, script):
    lad = _ladder(pkg)
    rungs = [lad.observe(ev, now=t) for ev, t in script]
    return rungs, lad.history(), lad.transitions, lad.max_rung_seen, lad.state()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ladder_transitions_equal_the_jax_ladders(name):
    port, jax = _play(PORT, SCRIPTS[name]), _play(JAX, SCRIPTS[name])
    assert port == jax
    rungs, history, transitions, max_rung, _ = port
    if name == "engage_then_step_after_hold":
        assert rungs == [1, 1, 1, 2, 2, 3, MAX_RUNG] and transitions == 3
        assert RUNG_NAMES[rungs[-1]] == "throttled"
    elif name == "recover_one_rung_per_hold":
        assert [r for _, r in history] == [1, 2, 3, 2, 1, 0] and rungs[-1] == 0
    elif name == "re_breach_during_recovery":
        assert rungs == [1, 1, 0, 1]
    else:
        assert transitions <= 1 + int(30.0 / 4.0)


def test_ladder_transition_side_effects_fire_outside_lock():
    lad = _ladder()
    lad.gauge = Gauge("scheduler_degradation_rung")
    lad.transition_counter = Counter("scheduler_degradation_transitions_total")
    seen = []
    lad.on_transition = lambda kind, frm, to: seen.append((kind, frm, to))
    lad.observe(BREACH, now=0.0)
    lad.observe([], now=4.0)
    lad.observe(RECOVERED, now=5.0)
    lad.observe([], now=10.0)
    assert lad.gauge.value == 1.0 and lad.transition_counter.value == 3
    assert seen == [("engage", 0, 1), ("step", 1, 2), ("recover", 2, 1)]
    st = lad.state()
    assert st["rung"] == 1 and st["rung_name"] == "widened" and st["max_rung_seen"] == 2


def test_ladder_crashing_callback_never_stalls_the_ladder():
    def boom(kind, frm, to):
        raise RuntimeError("observer bug")

    lad = _ladder(on_transition=boom)
    assert lad.observe(BREACH, now=0.0) == 1
    assert lad.observe([], now=4.0) == 2


def test_ladder_transition_lands_in_flight_recorder_with_slo_window():
    clock = FakeClock()
    reg = Registry()
    pending = reg.register(Gauge("scheduler_pending_pods"))
    store = TimeSeriesStore(reg, interval_s=0.5, clock=clock)
    pending.set(2000.0)
    for _ in range(4):
        store.sample_once()
        clock.advance(0.5)
    tracing.enable(clock=clock)
    try:
        lad = _ladder(slos=overload_slos(pending_threshold=100.0), store=store, clock=clock)
        lad.observe(BREACH, now=clock())
        dumps = [d for d in tracing.current().dumps if d["reason"] == "overload:engage:rung1"]
        assert len(dumps) == 1
        assert len(dumps[0]["attrs"]["window"]["scheduler_pending_pods"]) > 0
    finally:
        tracing.disable()


# -- 2. the evaluator under the same samples as the JAX one -------------------


def _surge_and_drain(pkg):
    """A sustained queue-depth surge then a drain, sampled on an injected
    clock through package ``pkg``'s time series, evaluator and ladder:
    (clock, rung, events) after every poll."""
    imp = importlib.import_module
    metrics = imp(f"{pkg}.utils.metrics")
    ts = imp(f"{pkg}.utils.timeseries")
    ov = _ov(pkg)
    clock = FakeClock()
    reg = metrics.Registry()
    pending = reg.register(metrics.Gauge("scheduler_pending_pods"))
    store = ts.TimeSeriesStore(reg, interval_s=0.5, clock=clock)
    slos = ov.overload_slos(pending_threshold=100.0, fast_window_s=2.0, slow_window_s=6.0,
                            recovery_evals=3)
    lad = ov.DegradationLadder(slos=slos, store=store, clock=clock, step_hold_s=4.0,
                               recover_hold_s=2.0)
    seen = []
    orig = lad.evaluator.evaluate

    def recording():
        events = orig()
        seen.append((clock(), [(e["type"], e["slo"]) for e in events]))
        return events

    lad.evaluator.evaluate = recording
    out = []
    for value, n in ((800.0, 13), (0.0, 40)):
        pending.set(value)
        for _ in range(n):
            store.sample_once()
            out.append((clock(), lad.poll()))
            clock.advance(0.5)
    return out, seen, lad.history()


def test_breach_and_recovery_events_equal_the_jax_evaluators():
    port, jax = _surge_and_drain(PORT), _surge_and_drain(JAX)
    assert port == jax
    rungs = [r for _, r in port[0]]
    assert max(rungs) >= 1 and rungs[-1] == 0
    kinds = [k for _, evs in port[1] for k, _ in evs]
    assert kinds.count("breach") == 1 and kinds.count("recovered") == 1


def test_gauge_sli_grades_by_threshold_excess():
    clock = FakeClock()
    reg = Registry()
    g = reg.register(Gauge("scheduler_pending_pods"))
    store = TimeSeriesStore(reg, clock=clock)
    sli = GaugeSLI(metric="scheduler_pending_pods", threshold=100.0)
    assert sli.bad_fraction(store, 10.0) is None
    for v in (100.0, 130.0, 250.0):
        g.set(v)
        store.sample_once()
        clock.advance(1.0)
    assert sli.bad_fraction(store, 10.0) == pytest.approx(0.6)
    g.set(10_000.0)
    store.sample_once()
    assert sli.bad_fraction(store, 0.5) == 1.0


def test_ladder_attach_polls_on_every_scrape():
    clock = FakeClock()
    reg = Registry()
    pending = reg.register(Gauge("scheduler_pending_pods"))
    store = TimeSeriesStore(reg, interval_s=0.5, clock=clock)
    lad = DegradationLadder(slos=overload_slos(pending_threshold=10.0), clock=clock).attach(store)
    assert lad.evaluator.store is store
    pending.set(500.0)
    for _ in range(13):
        store.sample_once()
        clock.advance(0.5)
    assert lad.rung >= 1


# -- 3. tiers and the throttle ------------------------------------------------


def _body(priority=0):
    return {"kind": "Pod", "spec": {"priority": priority}}


def test_classifier_tiers_admit_floor_and_preempt_floor():
    cls = PriorityTierClassifier(critical_at=8, standard_at=1)
    assert [cls.tier(p) for p in (0, 1, 7, 8)] == [cls.BATCH, cls.STANDARD, cls.STANDARD,
                                                   cls.CRITICAL]
    pod = make_pod("p", cpu="100m")
    assert cls.tier_of(pod) == cls.BATCH
    pod.spec.priority = 9
    assert cls.tier_of(pod) == cls.CRITICAL
    assert cls.tier_of_body({"spec": {"priority": "garbage"}}) == cls.BATCH
    with pytest.raises(ValueError):
        PriorityTierClassifier(critical_at=0, standard_at=1)
    lad = _ladder()
    for rung in range(MAX_RUNG + 1):
        lad.rung = rung
        assert lad.admit_tier_floor <= cls.STANDARD
        assert lad.preempt_tier_floor == (cls.CRITICAL if rung >= 2 else 0)
        assert lad.shed_score_planes == (rung >= 2)


def test_throttle_orders_tiers_batch_first_and_scales_its_hint():
    lad = _ladder()
    th = AdmissionThrottle(lad, retry_after_s=2.0)
    lad.rung = 2
    assert th.admit("pods", [_body(0)]) is None
    lad.rung = MAX_RUNG
    assert th.admit("pods", [_body(0)]) == 2.0
    assert th.admit("pods", [_body(1)]) is None and th.admit("pods", [_body(9)]) is None
    assert th.admit("pods", [_body(0), _body(9)]) is None
    assert th.admit("nodes", [_body(0)]) is None
    assert th.stats() == {"admitted": 3, "throttled": 1,
                          "throttled_by_tier": {PriorityTierClassifier.BATCH: 1}}
    clock = FakeClock()
    reg = Registry()
    pending = reg.register(Gauge("scheduler_pending_pods"))
    store = TimeSeriesStore(reg, interval_s=0.5, clock=clock)
    lad = DegradationLadder(slos=overload_slos(pending_threshold=100.0, fast_window_s=2.0),
                            store=store, clock=clock)
    lad.rung = MAX_RUNG
    th = AdmissionThrottle(lad, retry_after_s=2.0, retry_after_max_s=12.0)
    assert th.admit("pods", [_body(0)]) == 2.0
    pending.set(400.0)
    for _ in range(4):
        store.sample_once()
        clock.advance(0.5)
    assert th.admit("pods", [_body(0)]) == pytest.approx(8.0)
    pending.set(1e6)
    for _ in range(6):
        store.sample_once()
        clock.advance(0.5)
    assert th.admit("pods", [_body(0)]) == 12.0


def test_the_apiserver_answers_429_with_retry_after_and_the_client_honours_it():
    """At rung 3 the create paths throttle the batch tier: 429, a
    ``Retry-After`` in whole seconds, ``apiserver_admission_throttled_total``;
    the port's client retries on the hint and gives up when its budget
    runs out.  Critical pods and the bind path pass."""
    server = APIServer(Store())
    server.start()
    try:
        lad = _ladder()
        lad.rung = MAX_RUNG
        server.admission_throttle = AdmissionThrottle(lad, retry_after_s=0.4)
        req = urllib.request.Request(
            f"{server.url}/api/v1/namespaces/default/pods", method="POST",
            data=json.dumps(make_pod("b0", cpu="10m").to_dict()).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 429 and e.value.headers["Retry-After"] == "1"
        assert json.loads(e.value.read())["reason"] == "TooManyRequests"
        slept = []
        rs = RemoteStore(server.url, max_retries=2, sleep=slept.append, retry_seed=0)
        with pytest.raises(RetryExhaustedError):
            Clientset(rs).pods.create(make_pod("b1", cpu="10m"))
        assert rs.metrics.retry_after_honored.value == 2 and len(slept) == 2
        assert all(0.5 <= s <= 1.5 for s in slept)  # the 1 s hint, jittered
        crit = make_pod("c0", cpu="10m")
        crit.spec.priority = 9
        Clientset(rs).pods.create_many([crit])
        assert server.admission_throttled.value == 4  # 1 + 3 attempts
        with urllib.request.urlopen(f"{server.url}/metrics", timeout=5) as resp:
            assert "apiserver_admission_throttled_total 4" in resp.read().decode()
        lad.rung = 0
        Clientset(rs).pods.create(make_pod("b2", cpu="10m"))
    finally:
        server.stop()


def test_retry_after_parsing_classification_and_delay():
    assert _parse_retry_after({"Retry-After": "3"}) == 3.0
    assert _parse_retry_after({"Retry-After": "-2"}) == 0.0
    assert _parse_retry_after({}) is None and _parse_retry_after(None) is None
    assert _parse_retry_after({"Retry-After": "Thu, 01 Jan"}) is None
    assert {429, 503} <= RETRYABLE_STATUS and not {400, 409} & RETRYABLE_STATUS
    rs = RemoteStore("http://127.0.0.1:1", retry_seed=7)
    assert 1.0 <= rs._retry_delay(0, retry_after=3600.0) <= 3.0  # clamped to 2 s, jittered
    assert 0.05 <= rs._retry_delay(5, retry_after=0.1) <= 0.15


# -- 4. rung 2 on the batch path against the JAX backend ----------------------

ZONE = "failure-domain.beta.kubernetes.io/zone"


def _affinity_world(pkg, backend=True):
    imp = importlib.import_module
    tu = imp(f"{pkg}.testutil")
    sched_mod = imp(f"{pkg}.scheduler")
    cs = imp(f"{pkg}.client").Clientset(imp(f"{pkg}.store").Store())
    for i in range(8):
        cs.nodes.create(tu.make_node(f"node-{i:03d}", cpu="4", memory="8Gi", pods=40, labels={
            "kubernetes.io/hostname": f"node-{i:03d}", ZONE: f"zone-{i % 3}"}))
    algo = sched_mod.GenericScheduler()
    b = None
    if backend:
        b = (BatchBackend(algorithm=algo, device="cpu") if pkg == PORT
             else imp(f"{pkg}.ops").TPUBatchBackend(algorithm=algo))
    sched = sched_mod.Scheduler(cs, algorithm=algo, backend=b, emit_events=False)
    sched.start()
    return cs, sched, algo


def _affinity_pods(pkg, n=30):
    """Pods whose preferred interpod affinity makes the score plane
    matter: web pods attract each other softly per zone."""
    api = importlib.import_module(f"{pkg}.api")
    tu = importlib.import_module(f"{pkg}.testutil")
    soft = api.Affinity(pod_affinity_preferred=[api.WeightedPodAffinityTerm(
        weight=50, term=api.PodAffinityTerm(
            selector=api.LabelSelector.from_match_labels({"app": "web"}), topology_key=ZONE))])
    return [tu.make_pod(f"p{i:03d}", cpu="100m", memory="128Mi",
                        labels={"app": "web" if i % 3 == 0 else "other"},
                        affinity=soft if i % 3 == 0 else None) for i in range(n)]


def _bound(cs):
    return {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}


def _rung_wave(pkg, rung):
    cs, sched, algo = _affinity_world(pkg)
    lad = _ladder(pkg)
    lad.observe(BREACH, now=0.0)
    if rung >= 2:
        lad.observe([], now=10.0)
    lad.rung = rung
    sched.attach_overload(lad)
    for pod in _affinity_pods(pkg):
        cs.pods.create(pod)
    sched.pump()
    assert sched.schedule_pending_batch() == (30, 0)
    return _bound(cs), algo._round_robin, sched


def test_rung2_bindings_and_rr_equal_the_jax_backends():
    got, rr, sched = _rung_wave(PORT, 2)
    want, rr_want, jsched = _rung_wave(JAX, 2)
    assert got == want and rr == rr_want
    assert sched.backend.shed_score_planes and jsched.backend.shed_score_planes
    assert sched.metrics.score_plane_sheds.value == 1
    assert sched.backend.stats["score_plane_sheds"] == 1
    # the shed changed placements: the full-fidelity wave differs
    full, _, _ = _rung_wave(PORT, 0)
    assert full != got and set(full) == set(got)
    per_node = {}
    for node in got.values():
        per_node[node] = per_node.get(node, 0) + 1
    assert all(got.values()) and all(c <= 40 for c in per_node.values())


def test_rung0_full_fidelity_matches_oracle_exactly():
    got, rr, sched = _rung_wave(PORT, 0)
    cs_o, sched_o, algo_o = _affinity_world(PORT, backend=False)
    for pod in _affinity_pods(PORT):
        cs_o.pods.create(pod)
    sched_o.pump()
    sched_o.run_pending()
    assert got == _bound(cs_o) and rr == algo_o._round_robin
    assert sched.metrics.score_plane_sheds.value == 0 and not sched.backend.shed_score_planes


# -- 5. the batch loop and preemption under the ladder ------------------------


class ScriptedEvaluator:
    """Stands in for the burn-rate evaluator: the ladder's poll() drains
    the scripted events."""

    def __init__(self):
        self.pending = []
        self.store = None
        self.slos = []

    def push(self, events):
        self.pending.append(list(events))

    def evaluate(self):
        return self.pending.pop(0) if self.pending else []


def test_run_batch_loop_widens_knobs_mid_run():
    cs, sched, _ = _affinity_world(PORT)
    ev = ScriptedEvaluator()
    lad = DegradationLadder(evaluator=ev, min_batch_scale=4, max_wait_scale=4.0)
    sched.attach_overload(lad)
    for i in range(2):
        cs.pods.create(make_pod(f"w1-{i}", cpu="100m", memory="128Mi"))
    done = []
    t = threading.Thread(target=lambda: done.append(sched.run_batch_loop(
        min_batch=2, max_wait=2.0, max_waves=2, poll_interval=0.002)), daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while sched.metrics.batch_size.count < 1:
        assert time.monotonic() < deadline, "wave 1 never fired"
        time.sleep(0.005)
    ev.push(BREACH)
    for i in range(3):
        cs.pods.create(make_pod(f"w2-{i}", cpu="100m", memory="128Mi"))
    time.sleep(0.05)
    for i in range(3, 8):
        cs.pods.create(make_pod(f"w2-{i}", cpu="100m", memory="128Mi"))
    t.join(timeout=10.0)
    assert not t.is_alive() and done == [10]
    assert sched.metrics.batch_size.count == 2
    assert lad.rung == 1 and sched.metrics.degradation_rung.value == 1.0
    assert sched.metrics.degradation_transitions.value == 1


def test_critical_arrival_cuts_widened_window_short():
    cs, sched, _ = _affinity_world(PORT)
    ev = ScriptedEvaluator()
    ev.push(BREACH)
    lad = DegradationLadder(evaluator=ev, max_wait_scale=50.0)
    sched.attach_overload(lad)
    cs.pods.create(make_pod("batch-0", cpu="100m", memory="128Mi"))
    done = []
    t = threading.Thread(target=lambda: done.append(sched.run_batch_loop(
        min_batch=1000, max_wait=0.2, max_waves=1, poll_interval=0.002)), daemon=True)
    t.start()
    time.sleep(0.1)
    crit = make_pod("crit-0", cpu="100m", memory="128Mi")
    crit.spec.priority = 9
    cs.pods.create(crit)
    t0 = time.monotonic()
    t.join(timeout=8.0)
    assert not t.is_alive() and time.monotonic() - t0 < 5.0
    assert done == [2] and lad.rung == 1


@pytest.mark.parametrize("path", ["per_pod", "batch"])
def test_preemption_shed_blocks_standard_tier_at_rung_two(path):
    cs = Clientset(Store())
    cs.nodes.create(make_node("n0", cpu="1", memory="1Gi", pods=10))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu") if path == "batch" else None
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=False)
    sched.start()
    lad = _ladder()
    lad.observe(BREACH, now=0.0)
    lad.observe([], now=10.0)
    assert lad.rung == 2
    sched.attach_overload(lad)
    drive = sched.run_pending if path == "per_pod" else sched.schedule_pending_batch
    cs.pods.create(make_pod("victim", cpu="900m", memory="128Mi"))
    sched.pump()
    drive()
    assert _bound(cs)["victim"] == "n0"
    contender = make_pod("contender", cpu="900m", memory="128Mi")
    contender.spec.priority = 5  # standard tier: below the rung-2 floor
    cs.pods.create(contender)
    sched.pump()
    drive()
    assert sched.metrics.preemption_sheds.value == 1
    assert sched.metrics.preemption_attempts.value == 0
    assert _bound(cs) == {"victim": "n0", "contender": ""}
