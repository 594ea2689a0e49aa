"""Overload control: the burn-rate SLO engine as actuator.

The burn-rate SLOs (``utils/slo.py``) page; this module acts on them.
A :class:`DegradationLadder` consumes the
``BurnRateEvaluator``'s breach/recovery events — reusing its latch and
clean-streak hysteresis rather than re-deriving burn rates — and sheds
scheduling fidelity one rung at a time:

====  =============================================================
rung  what it sheds (each rung includes the ones below it)
====  =============================================================
0     nothing — full fidelity, bit-parity with the CPU oracle
1     latency for throughput: ``run_batch_loop``'s ``min_batch`` /
      ``max_wait`` widen by a scale factor and the tensorizer's sticky
      shape buckets coarsen (bigger waves, fewer distinct shapes;
      padding up is inert).  Top-tier pods still cut the
      accumulation window short — they never wait the widened window.
2     interpod-affinity SCORE planes: preferred-affinity scoring is
      skipped on the card's kernel path.  Feasibility predicates (including
      REQUIRED affinity) are untouched, so occupancy invariants still
      hold vs the oracle — only preferred-placement quality degrades.
      Preemption is restricted to the critical tier (batched
      preemption protects the top tier; lower tiers take backoff).
3     admission: the apiserver throttles create paths below the
      protected tier floor with 429 + ``Retry-After`` (which
      ``RemoteStore`` already classifies retryable and now honors).
====  =============================================================

Transitions are hold-gated on an injectable clock: the ladder engages
on the first breach, steps UP one rung only after ``step_hold_s`` of
sustained breach, and steps DOWN one rung at a time only after
``recover_hold_s`` with the breached set empty — so a burn oscillating
around the threshold produces a bounded number of transitions, not a
re-fire storm (the evaluator's ``recovery_evals`` latch already gates
the events themselves).  Every transition lands in metrics (the
``scheduler_degradation_rung`` gauge + transitions counter, wired by
the scheduler), the flight recorder (a dump with the offending SLO
window attached, mirroring ``BurnRateEvaluator._fire_breach``), and —
via the scheduler's wave attrs — the wave-root spans.

Who degrades first is decided by :class:`PriorityTierClassifier`
(pod ``spec.priority`` → tiers batch/standard/critical), and the
apiserver-side rung-3 actuator is :class:`AdmissionThrottle`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from . import tracing
from .slo import SLO, BurnRateEvaluator, GaugeSLI
from .timeseries import TimeSeriesStore

logger = logging.getLogger("kubernetes_tpu_torch.overload")

#: rung index -> human name (metrics export the index; logs/dumps both)
RUNG_NAMES = ("full", "widened", "shed_planes", "throttled")
MAX_RUNG = len(RUNG_NAMES) - 1


def overload_slos(pending_threshold: float = 512.0,
                  fast_window_s: float = 2.0,
                  slow_window_s: float = 6.0,
                  recovery_evals: int = 3) -> list[SLO]:
    """Short-window overload SLOs over the scheduler's queue-depth gauge.

    Queue depth is the overload signal of choice because the gauge is
    sampled every scrape whether or not pods are flowing: the windowed
    mean rises while arrivals outpace drain and falls as the backlog
    clears, so the ladder can step back down after the surge without
    waiting for fresh traffic (a cumulative-histogram quantile would
    stay poisoned by the surge forever).  ``GaugeSLI`` grades the burn
    by how far the mean exceeds ``pending_threshold``; with objective
    0.9 and burn thresholds of 3.0 both windows must average >= 1.3x
    the threshold before the ladder engages.
    """
    return [
        SLO(name="overload_queue_depth",
            sli=GaugeSLI(metric="scheduler_pending_pods",
                         threshold=pending_threshold),
            objective=0.9,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            fast_burn=3.0,
            slow_burn=3.0,
            recovery_evals=recovery_evals),
    ]


class PriorityTierClassifier:
    """Pod ``spec.priority`` (plain int, 0 default) → service tier.

    Three tiers: tier 2
    (*critical*) keeps full service at every rung — never throttled,
    still preempts, still cuts accumulation windows short; tier 1
    (*standard*) degrades but is never admission-throttled; tier 0
    (*batch* / best-effort) degrades and throttles first.
    """

    CRITICAL = 2
    STANDARD = 1
    BATCH = 0

    def __init__(self, critical_at: int = 8, standard_at: int = 1):
        if critical_at < standard_at:
            raise ValueError("critical_at must be >= standard_at")
        self.critical_at = critical_at
        self.standard_at = standard_at

    def tier(self, priority: int) -> int:
        if priority >= self.critical_at:
            return self.CRITICAL
        if priority >= self.standard_at:
            return self.STANDARD
        return self.BATCH

    def tier_of(self, pod) -> int:
        return self.tier(getattr(pod.spec, "priority", 0) or 0)

    def tier_of_body(self, body: dict) -> int:
        """Tier from a wire-form pod dict — the apiserver's admission
        gate classifies JSON bodies before any decode."""
        spec = body.get("spec") or {}
        try:
            prio = int(spec.get("priority") or 0)
        except (TypeError, ValueError):
            prio = 0
        return self.tier(prio)


class DegradationLadder:
    """Hold-gated rung controller over burn-rate breach/recovery events.

    Owns (or is handed) a :class:`BurnRateEvaluator`; :meth:`poll` runs
    one evaluation and advances the ladder, :meth:`observe` advances on
    externally produced events (tests drive it directly on a fake
    clock).  ``attach(store)`` hooks :meth:`poll` to run after every
    scrape, same wiring shape as ``slo.monitor``.

    Thread-safe: the scraper thread (via the observer) and the batch
    loop (via per-wave polls) may race; one lock guards evaluator +
    ladder state, and transition side effects (gauge, counter, dump,
    user callback) fire after it is released.
    """

    def __init__(self,
                 evaluator: Optional[BurnRateEvaluator] = None,
                 slos: Optional[list[SLO]] = None,
                 store: Optional[TimeSeriesStore] = None,
                 clock: Optional[Callable[[], float]] = None,
                 step_hold_s: float = 4.0,
                 recover_hold_s: float = 6.0,
                 classifier: Optional[PriorityTierClassifier] = None,
                 min_batch_scale: int = 4,
                 max_wait_scale: float = 4.0,
                 bucket_coarsen: int = 2,
                 on_transition: Optional[Callable[[str, int, int], None]] = None):
        self.evaluator = (evaluator if evaluator is not None
                          else BurnRateEvaluator(slos=slos, store=store))
        self.clock = clock or time.monotonic
        self.step_hold_s = step_hold_s
        self.recover_hold_s = recover_hold_s
        self.classifier = classifier or PriorityTierClassifier()
        self.min_batch_scale = min_batch_scale
        self.max_wait_scale = max_wait_scale
        self.bucket_coarsen = bucket_coarsen
        self.on_transition = on_transition
        # wired by Scheduler.attach_overload (scheduler_degradation_rung
        # gauge + scheduler_degradation_transitions_total counter)
        self.gauge = None
        self.transition_counter = None
        self.rung = 0
        self.max_rung_seen = 0
        self.transitions = 0
        self._mu = threading.Lock()
        self._breached: set[str] = set()
        self._last_transition_at: Optional[float] = None
        # (t, rung) per transition: the rung timeline
        self._history: list[tuple[float, int]] = []

    # -- wiring ------------------------------------------------------------
    def attach(self, store: TimeSeriesStore) -> "DegradationLadder":
        """Hook this ladder to advance after every scrape."""
        self.evaluator.store = store
        store.add_observer(lambda _samples: self.poll())
        return self

    # -- advancing ---------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> int:
        """Run one burn-rate evaluation and advance the ladder; returns
        the current rung.  The evaluator is single-threaded by contract,
        so it runs under the ladder lock (callers race: scraper observer
        vs the batch loop's per-wave poll)."""
        with self._mu:
            events = self.evaluator.evaluate()
            fired = self._advance(events, self.clock() if now is None else now)
        self._emit(fired)
        return self.rung

    def observe(self, events: list, now: Optional[float] = None) -> int:
        """Advance on externally produced evaluator events."""
        with self._mu:
            fired = self._advance(events, self.clock() if now is None else now)
        self._emit(fired)
        return self.rung

    def _advance(self, events: list, now: float) -> list:
        for ev in events:
            kind = ev.get("type")
            if kind == "breach":
                self._breached.add(ev["slo"])
            elif kind == "recovered":
                self._breached.discard(ev["slo"])
        fired = []
        if self._breached:
            if self.rung == 0:
                fired.append(self._shift(+1, "engage", now))
            elif (self.rung < MAX_RUNG
                  and now - self._last_transition_at >= self.step_hold_s):
                fired.append(self._shift(+1, "step", now))
        elif self.rung > 0:
            # recover_hold_s is measured from the LAST transition, so
            # each step-down re-arms the timer: recovery walks down one
            # rung per hold period instead of snapping to 0
            if now - self._last_transition_at >= self.recover_hold_s:
                fired.append(self._shift(-1, "recover", now))
        return fired

    def _shift(self, delta: int, kind: str, now: float) -> tuple:
        frm, to = self.rung, self.rung + delta
        self.rung = to
        self.max_rung_seen = max(self.max_rung_seen, to)
        self.transitions += 1
        self._last_transition_at = now
        # bounded: one entry per hold-gated transition (holds cap the rate)
        self._history.append((now, to))
        return (kind, frm, to, sorted(self._breached))

    def _emit(self, fired: list) -> None:
        for kind, frm, to, slos in fired:
            if self.gauge is not None:
                self.gauge.set(float(to))
            if self.transition_counter is not None:
                self.transition_counter.inc()
            logger.warning(
                "degradation ladder %s: rung %d (%s) -> %d (%s), breached=%s",
                kind, frm, RUNG_NAMES[frm], to, RUNG_NAMES[to], slos)
            self._record(kind, frm, to, slos)
            cb = self.on_transition
            if cb is not None:
                try:
                    cb(kind, frm, to)
                except Exception:  # noqa: BLE001 - callbacks never stall the ladder
                    logger.exception("overload on_transition callback failed")

    def _record(self, kind: str, frm: int, to: int, slos: list) -> None:
        """Flight-record the transition with the offending SLO window
        attached (the same window shape ``_fire_breach`` dumps), plus an
        instant marker on the live span tree."""
        tr = tracing.current()
        if tr is None:
            return
        try:
            tr.instant("overload.transition", kind=kind, frm=frm, to=to,
                       rung=RUNG_NAMES[to], breached=list(slos))
            window: dict = {}
            store = self.evaluator.store
            if store is not None:
                breached = set(slos)
                for slo in self.evaluator.slos:
                    if slo.name in breached:
                        for track in slo.sli.tracks():
                            window[track] = store.query(track, slo.slow_window_s)
            tr.dump(f"overload:{kind}:rung{to}", frm=frm, to=to,
                    breached=list(slos), window=window)
        except Exception:  # noqa: BLE001 - recording never crashes a transition
            logger.exception("overload transition dump failed (rung kept)")

    # -- actuator views ----------------------------------------------------
    def batch_knobs(self, min_batch: int, max_wait: float) -> tuple[int, float]:
        """Effective accumulation knobs for ``run_batch_loop``: rung >= 1
        widens both (bigger waves amortize fixed wave cost under load)."""
        if self.rung >= 1:
            return (max(1, int(min_batch * self.min_batch_scale)),
                    max_wait * self.max_wait_scale)
        return min_batch, max_wait

    @property
    def bucket_scale(self) -> int:
        """Tensorizer sticky-bucket multiplier: rung >= 1 coarsens the shape
        buckets (fewer distinct shapes under churny surges)."""
        return self.bucket_coarsen if self.rung >= 1 else 1

    @property
    def shed_score_planes(self) -> bool:
        """Rung >= 2: drop preferred interpod-affinity scoring planes
        (predicates untouched — feasibility and occupancy invariants hold)."""
        return self.rung >= 2

    @property
    def preempt_tier_floor(self) -> int:
        """Minimum tier still allowed to trigger preemption.  Rung >= 2
        restricts the batched PostFilter pass to the critical tier."""
        return self.classifier.CRITICAL if self.rung >= 2 else 0

    @property
    def admit_tier_floor(self) -> int:
        """Minimum tier admitted at the apiserver.  Rung 3 throttles the
        batch tier only — the floor never rises above STANDARD, so the
        top tier is *structurally* never throttled before lower tiers."""
        return self.classifier.STANDARD if self.rung >= MAX_RUNG else 0

    # -- introspection -----------------------------------------------------
    def history(self) -> list[tuple[float, int]]:
        with self._mu:
            return list(self._history)

    def state(self) -> dict:
        with self._mu:
            return {"rung": self.rung, "rung_name": RUNG_NAMES[self.rung],
                    "max_rung_seen": self.max_rung_seen,
                    "transitions": self.transitions,
                    "breached": sorted(self._breached)}


class AdmissionThrottle:
    """The rung-3 actuator, installed as ``APIServer.admission``.

    :meth:`admit` decides one create request: ``None`` admits, a float
    throttles (the handler answers 429 with that ``Retry-After``).  A
    batch request is judged by its highest-tier member — admitting on
    the max lets mixed batches ride with their most important pod
    rather than punishing it for its cohort.  Counters are guarded by a
    lock (apiserver handler threads race).

    The ``Retry-After`` hint is **load-adaptive**: a fixed hint invites
    every shed client back on the same schedule regardless of how deep
    the backlog actually is, so a 10x backlog gets the same retry storm
    as a 1.1x one.  Instead the hint scales with the live windowed mean
    of the queue-depth gauge (the same track the ladder's breach SLO
    watches, read from the evaluator's time-series store) relative to
    that SLO's threshold, clamped to [``retry_after_s``,
    ``retry_after_max_s``] — the configured value is preserved as the
    floor, and a dead store (no scraper, no samples) degrades to
    exactly the old fixed-hint behavior.
    """

    def __init__(self, ladder: DegradationLadder,
                 retry_after_s: float = 1.0,
                 resources: tuple = ("pods",),
                 retry_after_max_s: float = 30.0):
        self.ladder = ladder
        self.retry_after_s = retry_after_s
        self.retry_after_max_s = max(retry_after_max_s, retry_after_s)
        self.resources = frozenset(resources)
        self._mu = threading.Lock()
        self.admitted = 0
        self.throttled = 0
        self.throttled_by_tier: dict[int, int] = {}

    def _depth_slo(self) -> Optional[SLO]:
        """The ladder's queue-depth SLO (a GaugeSLI), if it has one —
        its metric name and threshold define 'how deep is deep'."""
        for slo in self.ladder.evaluator.slos:
            if isinstance(slo.sli, GaugeSLI):
                return slo
        return None

    def retry_after_hint(self) -> float:
        """Live Retry-After: base x (windowed mean queue depth /
        breach threshold), clamped to [base, max].  Reads the same ring
        the ladder breached on, so the hint and the rung agree about
        the backlog; any missing piece (no store, no samples, no gauge
        SLO) falls back to the configured base."""
        slo = self._depth_slo()
        store = self.ladder.evaluator.store
        if slo is None or store is None or slo.sli.threshold <= 0:
            return self.retry_after_s
        samples = store.query(slo.sli.metric, slo.fast_window_s)
        if not samples:
            return self.retry_after_s
        depth = sum(v for _, v in samples) / len(samples)
        scaled = self.retry_after_s * (depth / slo.sli.threshold)
        return min(max(scaled, self.retry_after_s), self.retry_after_max_s)

    def admit(self, resource: str, bodies: list) -> Optional[float]:
        if resource not in self.resources:
            return None
        floor = self.ladder.admit_tier_floor
        if floor <= 0:
            return None
        cls = self.ladder.classifier
        tier = max((cls.tier_of_body(b) for b in bodies if isinstance(b, dict)),
                   default=PriorityTierClassifier.BATCH)
        if tier >= floor:
            with self._mu:
                self.admitted += 1
            return None
        with self._mu:
            self.throttled += 1
            self.throttled_by_tier[tier] = self.throttled_by_tier.get(tier, 0) + 1
        return self.retry_after_hint()

    def stats(self) -> dict:
        with self._mu:
            return {"admitted": self.admitted, "throttled": self.throttled,
                    "throttled_by_tier": dict(self.throttled_by_tier)}
