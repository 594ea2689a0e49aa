"""Prometheus-style metrics primitives: counters, gauges and histograms, a
registry with a text exposition dump, and the metric sets the scheduler
and the informers bump.  The scheduler's three SLIs (the reference's
``plugin/pkg/scheduler/metrics/metrics.go:26-50``) are predefined in
``SchedulerMetrics``, in microseconds.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional

# reference metrics.go shape: 1ms .. ~1000s exponential (in microseconds),
# at 2^(1/4) steps — 80 buckets instead of the reference's 20, so a
# reported quantile's upper bound is within ~19% of the true value (the
# bench's SLI block reads these).  At sqrt(2) steps the >8s buckets were
# ~3.4s wide and adjacent segment commits of a north drain could land in
# ONE bucket, collapsing p50 and p99 to the same boundary.
_DEFAULT_BUCKETS = [1e3 * (2 ** (i / 4)) for i in range(80)]


class Histogram:
    def __init__(self, name: str, help: str = "", buckets: Optional[list[float]] = None):
        self.name = name
        self.help = help
        self.buckets = sorted(buckets or _DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        with self._mu:
            i = bisect.bisect_left(self.buckets, value)
            self._counts[i] += 1
            self._sum += value
            self._total += 1

    def observe_many(self, value: float, n: int) -> None:
        """n observations of the same value under one lock/bisect — the
        batch scheduler records one shared e2e latency for every pod in a
        committed batch; per-pod observe() would cost 150k lock rounds."""
        with self._mu:
            i = bisect.bisect_left(self.buckets, value)
            self._counts[i] += n
            self._sum += value * n
            self._total += n

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket boundaries (upper bound)."""
        with self._mu:
            if self._total == 0:
                return 0.0
            target = q * self._total
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= target:
                    return self.buckets[i] if i < len(self.buckets) else float("inf")
            return float("inf")

    def state(self) -> tuple[list[int], int, float]:
        """One consistent ``(bucket_counts, total, sum)`` snapshot under a
        single lock round — the time-series scraper derives several
        quantile tracks per scrape, and three ``quantile()`` calls could
        each see a different population."""
        with self._mu:
            return list(self._counts), self._total, self._sum

    def expose(self) -> str:
        # one consistent snapshot: without the lock a concurrent
        # observe() can land between the bucket walk and the _total
        # read, exposing cumulative bucket counts that exceed (or trail)
        # the reported _count — scrapers and the SLO checks both assume
        # the exposition is internally consistent
        with self._mu:
            counts = list(self._counts)
            total = self._total
            total_sum = self._sum
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            lines.append(f'{self.name}_bucket{{le="{b}"}} {acc}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum {total_sum}")
        lines.append(f"{self.name}_count {total}")
        return "\n".join(lines)


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._mu = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} counter\n"
            f"{self.name} {self._value}"
        )


class Gauge:
    """Last-write-wins gauge.  ``set`` takes a lock like the other
    primitives — gauges are written from resync/compaction threads and
    scraped from the health server's connection threads, so the
    single-writer assumption the pre-lock version leaned on does not
    hold for every instance (ktpu-analyze race-lint hygiene)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        with self._mu:
            self._value = v

    def inc(self, amount: float = 1.0) -> None:
        with self._mu:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
            f"{self.name} {self._value}"
        )


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._mu = threading.Lock()

    def register(self, metric):
        with self._mu:
            self._metrics[metric.name] = metric
        return metric

    def get(self, name: str):
        with self._mu:
            return self._metrics.get(name)

    def snapshot(self) -> list:
        """The registered metrics as a list, captured under the registry
        lock.  Daemons register metrics lazily (first use), so a scrape
        racing a registration must not iterate the mutating dict — both
        ``expose()`` and the time-series scraper walk this snapshot
        instead, outside the lock."""
        with self._mu:
            return list(self._metrics.values())

    def expose(self) -> str:
        # per-metric expose() takes each metric's own lock; holding the
        # registry lock across that walk would nest registry-lock →
        # metric-lock against every observe() in flight — snapshot the
        # dict under the lock, render outside it
        return "\n".join(m.expose() for m in self.snapshot()) + "\n"



class ClientMetrics:
    """Client observability: the wire client's retries and watch-stream
    failures (one instance per ``RemoteStore``; its watches share it) and
    the informers' relists (gap escalation or resync), handler callbacks
    that raised, and event payloads that failed to decode."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.remote_retries = r.register(Counter(
            "client_remote_retries_total",
            "request attempts re-issued after a retryable failure"))
        self.remote_fatal = r.register(Counter(
            "client_remote_fatal_total",
            "requests abandoned on a non-retryable classification"))
        self.remote_retry_exhausted = r.register(Counter(
            "client_remote_retry_exhausted_total",
            "requests abandoned after the retry budget ran out"))
        self.remote_drain_errors = r.register(Counter(
            "client_remote_drain_errors_total",
            "response-body drains that raised before a retry"))
        self.retry_after_honored = r.register(Counter(
            "client_retry_after_honored_total",
            "retry sleeps that honored a server Retry-After header"))
        self.watch_reconnects = r.register(Counter(
            "client_watch_reconnects_total",
            "watch streams re-established after an error"))
        self.watch_gaps = r.register(Counter(
            "client_watch_gaps_total",
            "watch resumes refused with 410 Gone (the informer relists)"))
        self.watch_errors = r.register(Counter(
            "client_watch_errors_total",
            "classified watch-stream errors (transport and HTTP)"))
        self.watch_close_errors = r.register(Counter(
            "client_watch_close_errors_total",
            "watch stream closes that raised (torn down anyway)"))
        self.ingest_bytes = r.register(Counter(
            "scheduler_ingest_decode_bytes_total",
            "wire bytes of watch payloads delivered to informers"))
        self.watch_parse_seconds = r.register(Counter(
            "client_watch_parse_seconds_total",
            "seconds the watch readers spent parsing stream lines (JSON, "
            "then a frame's columns) before an informer saw them"))
        self.informer_relists = r.register(Counter(
            "client_informer_relists_total",
            "full LIST + watch restarts (gap escalation or resync)"))
        self.informer_handler_errors = r.register(Counter(
            "client_informer_handler_errors_total",
            "handler callbacks that raised (isolated, loop continues)"))
        self.informer_decode_errors = r.register(Counter(
            "client_informer_decode_errors_total",
            "event payloads that failed to decode (delta lost, gap marked "
            "for relist)"))
        self.informer_frame_errors = r.register(Counter(
            "client_informer_frame_errors_total",
            "column-packed watch frames lost whole before application "
            "(broken columns): gap marked for relist"))
        self.informer_compactions = r.register(Counter(
            "client_informer_compactions_total",
            "lazy cache objects promoted and stripped of their wire payload"))
        self.informer_compaction_freed_bytes = r.register(Gauge(
            "client_informer_compaction_freed_bytes",
            "approximate wire-payload bytes released by the last compaction"))
        self.informer_dropped_events = r.register(Counter(
            "client_informer_dropped_events_total",
            "deltas dropped before application (fault injection)"))
        # the worst watcher's revision lag behind the store head, sampled
        # by utils.fanout.WatchFanoutTracker (a gauge: it keeps producing
        # samples while the fleet idles)
        self.watch_worst_staleness = r.register(Gauge(
            "client_watch_worst_staleness_revisions",
            "largest per-client revision lag behind the store head at the "
            "last fan-out staleness sample (0 = every watcher caught up)"))


# informers without an explicit metrics object aggregate here
DEFAULT_CLIENT_METRICS = ClientMetrics()


class StoreMetrics:
    """The coalescing window's flushes, folds and flush-path fallbacks (the
    fault matrix reads ``store_coalesce_fallbacks_total``)."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.coalesce_flushes = r.register(Counter(
            "store_coalesce_flushes_total",
            "coalescing windows flushed to the watcher queues (deadline, "
            "ordering barrier, key cap, or shutdown)"))
        self.coalesced_events = r.register(Counter(
            "store_coalesced_events_total",
            "per-key deliveries superseded inside a coalescing window "
            "(latest-wins folds)"))
        self.coalesce_fallbacks = r.register(Counter(
            "store_coalesce_fallbacks_total",
            "coalescing windows degraded to per-event delivery after a "
            "flush-path failure (state preserved, packing lost)"))


# the stores of a process aggregate here
DEFAULT_STORE_METRICS = StoreMetrics()


class APIServerMetrics:
    """The apiserver's request count and latency (microseconds), the error
    responses that could not be written because the client hung up, the
    creates the overload gate throttled and the telemetry records taken."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.request_count = r.register(Counter("apiserver_request_count", "total requests"))
        self.request_latency = r.register(
            Histogram("apiserver_request_latencies_microseconds"))
        self.error_write_failures = r.register(Counter(
            "apiserver_error_write_failures_total",
            "error responses that could not be written (client hung up)"))
        self.admission_throttled = r.register(Counter(
            "apiserver_admission_throttled_total",
            "create requests answered 429 + Retry-After by the overload "
            "admission gate"))
        self.telemetry_accepted = r.register(Counter(
            "apiserver_telemetry_accepted_total",
            "telemetry records accepted at /telemetry"))


class SchedulerMetrics:
    """The reference's three scheduling SLIs, in microseconds
    (``metrics/metrics.go:26-50``), plus the batch path's extras."""

    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.e2e_scheduling_latency = r.register(
            Histogram("scheduler_e2e_scheduling_latency_microseconds")
        )
        self.scheduling_algorithm_latency = r.register(
            Histogram("scheduler_scheduling_algorithm_latency_microseconds")
        )
        self.binding_latency = r.register(
            Histogram("scheduler_binding_latency_microseconds")
        )
        self.schedule_attempts = r.register(Counter("scheduler_schedule_attempts_total"))
        self.schedule_failures = r.register(Counter("scheduler_schedule_failures_total"))
        # batch-backend extras
        self.batch_size = r.register(Histogram("scheduler_batch_size", buckets=[2**i for i in range(20)]))
        self.batch_device_latency = r.register(
            Histogram("scheduler_batch_device_latency_microseconds")
        )
        self.bind_failures = r.register(Counter(
            "scheduler_bind_failures_total",
            "bind attempts that failed (conflict, not-found, transport)",
        ))
        self.bind_requeues = r.register(Counter(
            "scheduler_bind_requeues_total",
            "pods requeued with backoff after a transient bind failure",
        ))
        # steady-state pipeline (run_batch_loop / overlapped ingest)
        self.batch_queue_wait = r.register(Histogram(
            "scheduler_batch_queue_wait_microseconds",
            "time from the first ready pod to the wave's drain (the "
            "min-batch/max-wait accumulation window)",
        ))
        self.pipeline_prep_latency = r.register(Histogram(
            "scheduler_pipeline_prep_microseconds",
            "host prep (pump + signature warming) run inside the device's "
            "shadow between the final dispatch and its finalize",
        ))
        self.pipeline_device_wait = r.register(Histogram(
            "scheduler_pipeline_device_wait_microseconds",
            "device time left after the overlapped prep returned — the "
            "unfilled overlap headroom of the wave",
        ))
        # ingest: per-wave informer decode and application time, lazy
        # promotions, watch frames and the columnar confirm's fallbacks
        self.ingest_decode_seconds = r.register(Histogram(
            "scheduler_ingest_decode_seconds",
            "informer event-decode time per scheduling wave (seconds; "
            "near zero on the lazy path)",
            buckets=[1e-5 * (2 ** (i / 2)) for i in range(44)],
        ))
        self.ingest_parse_seconds = r.register(Histogram(
            "scheduler_ingest_parse_seconds",
            "watch-line parse time per scheduling wave on the wire client "
            "(JSON and frame columns, before the informer's decode; "
            "seconds, zero in process)",
            buckets=[1e-5 * (2 ** (i / 2)) for i in range(44)],
        ))
        self.ingest_promotions = r.register(Counter(
            "scheduler_ingest_promotions_total",
            "lazy-object sections and objects promoted to typed form by "
            "consumers (decode work that was needed)",
        ))
        self.pump_apply_seconds = r.register(Histogram(
            "scheduler_pump_apply_seconds",
            "informer event/frame application time per scheduling wave "
            "(cache apply + handler fan-out + bind confirm; seconds)",
            buckets=[1e-5 * (2 ** (i / 2)) for i in range(44)],
        ))
        self.watch_frames = r.register(Counter(
            "scheduler_watch_frames_total",
            "column-packed watch frames applied by this scheduler's "
            "informers (one a correlated store batch txn)",
        ))
        self.watch_frame_events = r.register(Counter(
            "scheduler_watch_frame_events_total",
            "events delivered inside watch frames",
        ))
        self.confirm_fallbacks = r.register(Counter(
            "scheduler_confirm_fallbacks_total",
            "frame bind-confirm entries the columnar revision fence "
            "rejected, routed through the per-pod compare instead",
        ))
        self.pipeline_prep_failures = r.register(Counter(
            "scheduler_pipeline_prep_failures_total",
            "overlapped-prep runs that raised; the work is deferred to the "
            "next wave's synchronous path (no decisions are affected)",
        ))
        # preemption (the PostFilter phase)
        self.preemption_attempts = r.register(Counter(
            "scheduler_preemption_attempts_total",
            "preemption attempts, one per failed priority pod (a cohort "
            "member that is granted freed space without evicting counts too)"))
        self.preemption_victims = r.register(Counter(
            "scheduler_preemption_victims_total", "pods evicted by preemption"))
        self.preemption_latency = r.register(Histogram(
            "scheduler_preemption_latency_microseconds",
            "one preemption attempt: victim selection and the evictions"))
        # overload control: pending_pods is the degradation ladder's input
        # (a gauge sampled every scrape, so the ladder can recover with no
        # traffic); the rest are its state and its shed actions
        self.pending_pods = r.register(Gauge(
            "scheduler_pending_pods",
            "ready pods in the scheduling queue at the last batch-loop "
            "iteration (the overload ladder's queue-depth signal)"))
        self.degradation_rung = r.register(Gauge(
            "scheduler_degradation_rung",
            "current overload degradation rung (0=full fidelity, "
            "1=widened batching, 2=score planes shed, 3=admission "
            "throttled)"))
        self.degradation_transitions = r.register(Counter(
            "scheduler_degradation_transitions_total",
            "degradation-ladder rung changes (engage, step, recover)"))
        self.score_plane_sheds = r.register(Counter(
            "scheduler_score_plane_sheds_total",
            "batches scheduled with the preferred interpod-affinity score "
            "plane shed (rung >= 2; feasibility untouched)"))
        self.oracle_pods = r.register(Counter(
            "scheduler_backend_oracle_pods_total",
            "pods the batch backend scheduled on the host oracle (a policy "
            "the fused scan does not express, or a pod with more disks than "
            "a volume slot row holds)"))
        self.preemption_sheds = r.register(Counter(
            "scheduler_preemption_sheds_total",
            "preemption-eligible pods denied the PostFilter pass because "
            "their tier is below the ladder's floor (rung >= 2)"))
        # the frontier scan and the device-resident node cache
        self.tensorize_upload_fraction = r.register(Histogram(
            "scheduler_tensorize_upload_fraction",
            "fraction of node-axis columns re-uploaded to device per wave "
            "(0 = fully cache-resident, 1 = full upload)",
            buckets=[i / 20 for i in range(21)]))
        self.frontier_compactions = r.register(Counter(
            "scheduler_frontier_compactions_total",
            "mid-segment device node-axis compactions (the alive-union "
            "fraction fell below the threshold and the scan resumed at a "
            "smaller power-of-two width)"))
        self.frontier_alive_fraction = r.register(Histogram(
            "scheduler_frontier_alive_fraction",
            "lowest alive-union fraction observed per frontier segment "
            "(1.0 = no column ever died; small = heavy pruning)",
            buckets=[i / 20 for i in range(21)]))
        self.host_syncs = r.register(Counter(
            "scheduler_host_syncs_total",
            "blocking device→host round-trips performed by batch "
            "finalize (control reads + result copies)"))
