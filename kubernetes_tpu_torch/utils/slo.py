"""Declarative SLOs with multi-window burn-rate evaluation.

An SLO here is an *objective* (allowed good fraction, e.g. 0.99) over an
SLI derived from the time-series rings (``utils/timeseries.py``):

- :class:`RatioSLI` — bad/total counter deltas over a window (the
  bind-requeue rate, watch-gap rate);
- :class:`QuantileSLI` — the fraction of a histogram quantile track's
  samples above a threshold over a window (wave e2e latency p99);
- :class:`GaugeSLI` — the windowed mean of a gauge track graded against
  a threshold (queue depth for overload control).

Evaluation is the SRE multi-window burn-rate recipe: the *burn rate* is
``bad_fraction / error_budget`` and a breach fires only when BOTH the
fast window (pages fast on a cliff) and the slow window (arms only on a
sustained burn, so a single slow wave cannot page) exceed their
thresholds.  Recovery has hysteresis — ``recovery_evals`` consecutive
clean evaluations re-arm the breach — so a burn oscillating around the
threshold fires one dump, not one per scrape.

A breach fires the existing flight recorder (``tracing.current().dump``)
with the breach reason and the offending metric window attached: the
dump carries the last K wave traces with their txn-correlated spans, so
"throughput sagged" auto-captures the waves that sagged.  With the
off-box shipper enabled (``utils/telemetry.py``) that dump leaves the
process — the recorder's dump hook offers every snapshot to the shipper.

Everything takes an injectable clock through the store; no wall time is
read here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import tracing
from .timeseries import TimeSeriesStore


@dataclass(frozen=True)
class RatioSLI:
    """bad/total counter-delta ratio over a window.  ``bad_metric`` and
    ``total_metric`` are registered counter names (keyword-only and
    literal in every spec — the MN405 lint resolves them statically)."""

    bad_metric: str
    total_metric: str

    def bad_fraction(self, store: TimeSeriesStore,
                     window_s: float) -> Optional[float]:
        total = store.delta(self.total_metric, window_s)
        if total <= 0:
            return None  # no traffic in the window: no data, never a breach
        bad = store.delta(self.bad_metric, window_s)
        return max(0.0, min(1.0, bad / total))

    def tracks(self) -> list[str]:
        return [self.bad_metric, self.total_metric]


@dataclass(frozen=True)
class QuantileSLI:
    """Fraction of a histogram quantile track's samples above a
    threshold.  ``metric`` is the registered histogram name; the track
    read is ``<metric>:<quantile>`` as the scraper derives it."""

    metric: str
    threshold: float
    quantile: str = "p99"

    def bad_fraction(self, store: TimeSeriesStore,
                     window_s: float) -> Optional[float]:
        samples = store.query(f"{self.metric}:{self.quantile}", window_s)
        if not samples:
            return None
        bad = sum(1 for _, v in samples if v > self.threshold)
        return bad / len(samples)

    def tracks(self) -> list[str]:
        return [f"{self.metric}:{self.quantile}"]


@dataclass(frozen=True)
class GaugeSLI:
    """Windowed mean of a gauge track against a threshold, graded: the
    bad fraction is how far the mean exceeds the threshold (clamped to
    [0, 1]), so the burn rate scales with severity instead of stepping.
    Gauges are sampled every scrape regardless of traffic, so this SLI
    keeps producing data — and can therefore *recover* — even when the
    pipeline goes quiet, unlike counter-delta ratios (the property the
    degradation ladder in ``utils/overload.py`` needs to step back down
    after a surge drains)."""

    metric: str
    threshold: float

    def bad_fraction(self, store: TimeSeriesStore,
                     window_s: float) -> Optional[float]:
        samples = store.query(self.metric, window_s)
        if not samples:
            return None
        mean = sum(v for _, v in samples) / len(samples)
        if self.threshold <= 0:
            return 1.0 if mean > 0 else 0.0
        return max(0.0, min(1.0, mean / self.threshold - 1.0))

    def tracks(self) -> list[str]:
        return [self.metric]


@dataclass(frozen=True)
class SLO:
    """One objective over one SLI, with its burn-rate policy.  The
    default thresholds are the classic SRE pairing: 14.4x on a short
    window catches a cliff inside the hour, 6x on the long window
    catches a slow leak — both must agree before anyone is paged."""

    name: str
    sli: object  # RatioSLI | QuantileSLI | GaugeSLI
    objective: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    recovery_evals: int = 3

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


#: the pipeline's standing SLOs, over metrics ``SchedulerMetrics`` /
#: ``ClientMetrics`` register.  The latency threshold is the reference's
#: 5 s pod-startup SLO (e2e p99).
DEFAULT_SLOS = [
    SLO(name="wave_e2e_latency_p99",
        sli=QuantileSLI(
            metric="scheduler_e2e_scheduling_latency_microseconds",
            threshold=5_000_000.0)),
    SLO(name="bind_requeue_rate",
        sli=RatioSLI(
            bad_metric="scheduler_bind_requeues_total",
            total_metric="scheduler_schedule_attempts_total")),
    SLO(name="watch_fanout_staleness",
        sli=RatioSLI(
            bad_metric="client_watch_gaps_total",
            total_metric="scheduler_watch_frames_total")),
]


def serving_slos(worst_lag_revisions: float = 500.0) -> list[SLO]:
    """SLOs over the serving tier's per-client attribution gauge: the
    fleet's worst watcher gets a signal of its own instead of hiding in
    the cluster-wide gap ratio.  A GaugeSLI: it keeps producing samples
    (and can recover) while churn idles; ``worst_lag_revisions`` is the
    lag the budget is graded against."""
    return [
        SLO(name="watch_fanout_worst_client_staleness",
            sli=GaugeSLI(
                metric="client_watch_worst_staleness_revisions",
                threshold=worst_lag_revisions)),
    ]


def mesh_slos() -> list[SLO]:
    """SLOs over the node-axis mesh's per-shard gauges: one hot shard
    (skewed upload traffic, or a lopsided alive distribution after a
    compaction) burns its own budget instead of hiding in the cluster-wide
    mean.  Gauge SLIs, so both keep producing data (and can recover) while
    the mesh idles between waves."""
    return [
        SLO(name="mesh_shard_upload_skew",
            sli=GaugeSLI(
                metric="scheduler_mesh_worst_shard_upload_fraction",
                threshold=0.5)),
        SLO(name="mesh_shard_alive_skew",
            sli=GaugeSLI(
                metric="scheduler_mesh_shard_alive_skew",
                threshold=0.25)),
    ]


#: breach-context providers by SLO name (``register_breach_context``):
#: a provider's dict rides the flight-recorder dump when that SLO
#: breaches — the serving tier attaches its top-K laggard attribution
#: here.  Module-level and lock-free by the evaluator's single-threaded
#: contract (providers are registered at wiring time, read on the
#: scraper thread).
_BREACH_CONTEXT: dict = {}


def register_breach_context(slo_name: str, provider) -> None:
    """Attach ``provider`` (a zero-arg callable returning a JSON-shaped
    dict) to ``slo_name``: its output is included in the flight-recorder
    dump fired when that SLO breaches.  Last registration wins."""
    _BREACH_CONTEXT[slo_name] = provider


class BurnRateEvaluator:
    """Evaluates a set of SLOs against a time-series store.

    Single-threaded by contract: hooked as a scrape observer it runs on
    the scraper thread only (tests drive :meth:`evaluate` directly on a
    fake clock).  Each evaluation returns the events it fired —
    ``{"type": "breach"|"recovered", ...}`` — and a breach additionally
    takes a flight-recorder dump with the offending window attached."""

    def __init__(self, slos: Optional[list[SLO]] = None,
                 store: Optional[TimeSeriesStore] = None):
        self.slos = list(DEFAULT_SLOS if slos is None else slos)
        self.store = store
        self._state = {slo.name: {"breached": False, "clean": 0}
                       for slo in self.slos}
        self.breaches_fired = 0

    def attach(self, store: TimeSeriesStore) -> "BurnRateEvaluator":
        """Hook this evaluator to run after every scrape."""
        self.store = store
        store.add_observer(lambda _samples: self.evaluate())
        return self

    def state(self, name: str) -> dict:
        return dict(self._state[name])

    def evaluate(self) -> list[dict]:
        store = self.store
        if store is None:
            return []
        events: list[dict] = []
        for slo in self.slos:
            fast = slo.sli.bad_fraction(store, slo.fast_window_s)
            slow = slo.sli.bad_fraction(store, slo.slow_window_s)
            if fast is None or slow is None:
                continue  # no data on either window: never a breach
            fast_burn = fast / slo.error_budget
            slow_burn = slow / slo.error_budget
            burning = (fast_burn >= slo.fast_burn
                       and slow_burn >= slo.slow_burn)
            st = self._state[slo.name]
            if not st["breached"]:
                if burning:
                    st["breached"] = True
                    st["clean"] = 0
                    self.breaches_fired += 1
                    ev = {"type": "breach", "slo": slo.name,
                          "fast_burn": fast_burn, "slow_burn": slow_burn,
                          "objective": slo.objective}
                    events.append(ev)
                    self._fire_breach(slo, ev)
            elif burning:
                st["clean"] = 0
            else:
                st["clean"] += 1
                if st["clean"] >= slo.recovery_evals:
                    st["breached"] = False
                    st["clean"] = 0
                    events.append({"type": "recovered", "slo": slo.name})
        return events

    def _fire_breach(self, slo: SLO, ev: dict) -> None:
        """Dump the flight recorder with the offending metric window —
        the dump's waves carry the txn-correlated spans that burned the
        budget.  Recording must never crash the scrape loop."""
        tr = tracing.current()
        if tr is None:
            return
        try:
            window = {track: self.store.query(track, slo.slow_window_s)
                      for track in slo.sli.tracks()}
            extra = {}
            provider = _BREACH_CONTEXT.get(slo.name)
            if provider is not None:
                # per-SLO attribution (the serving tier's top-K laggard
                # dump): a provider failure must not lose the dump — the
                # outer except already guards, but keep the window even
                # when only the context breaks
                try:
                    extra["context"] = provider()
                except Exception:  # noqa: BLE001
                    import logging

                    logging.getLogger("kubernetes_tpu_torch.slo").exception(
                        "SLO breach context provider failed (dump kept)")
            tr.dump(f"slo:{slo.name}", fast_burn=ev["fast_burn"],
                    slow_burn=ev["slow_burn"], objective=slo.objective,
                    window=window, **extra)
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger("kubernetes_tpu_torch.slo").exception(
                "SLO breach dump failed (breach state kept)")


def monitor(slos: Optional[list[SLO]] = None,
            store: Optional[TimeSeriesStore] = None
            ) -> Optional[BurnRateEvaluator]:
    """Attach a burn-rate evaluator to the active (or given) time-series
    store — the one-call wiring daemons use after ``timeseries.enable``.
    Returns None when no store is active (monitoring needs rings)."""
    from . import timeseries

    target = store if store is not None else timeseries.current()
    if target is None:
        return None
    return BurnRateEvaluator(slos=slos, store=target).attach(target)
