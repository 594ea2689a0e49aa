"""The scheduler: watch wiring, the per-pod loop, and the batch seam.

Capability of ``plugin/pkg/scheduler/scheduler.go`` +
``factory/factory.go:120 NewConfigFactory``:

- informers feed the scheduler cache (bound and assumed pods, nodes) and
  the pending queue (unscheduled pods) — factory.go:140,188-199,391-520;
- ``schedule_one`` (scheduler.go:253): pop → snapshot → schedule → assume →
  bind, with failure → backoff re-enqueue (MakeDefaultErrorFunc,
  factory.go:718) and assumed-pod TTL expiry;
- Scheduled / FailedScheduling events (scheduler.go:174,248) and the three
  latency SLIs (metrics/metrics.go).

The batch path: ``schedule_pending_batch`` drains the queue and hands the
batch to ``backend`` (``ops/backend.py`` ``BatchBackend``), committing each
segment's results (assume, one ``bind_many`` txn, events) while the card
scans the next segment; ``run_batch_loop`` serves arrivals wave by wave
under a min-batch/max-wait policy.  Preemption is not part of this
package yet.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Callable, Optional

from ..api import types as api
from ..client.clientset import BindConflictError, Clientset
from ..client.informer import Handler, InformerFactory
from ..client.record import EventBroadcaster
from ..store.store import NotFoundError
from ..utils.metrics import SchedulerMetrics
from ..utils.trace import Trace
from .generic_scheduler import FitError, GenericScheduler
from .nodeinfo import NodeInfo, SchedulerCache
from .priorities import PriorityContext
from .queue import PodBackoff, SchedulingQueue

logger = logging.getLogger("kubernetes_tpu_torch.scheduler")

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# the overlapped prep's poll period while the final segment scans: short
# enough to catch the scan's end, long enough to leave the GIL to the
# arrival and event-sink threads between polls
_PREP_POLL_S = 0.002

# the backend timers whose per-wave deltas land in last_batch_phases
_PHASE_KEYS = ("tensorize_s", "dispatch_s", "device_wait_s", "kernel_ms")


def _is_scheduler_pod(pod: api.Pod, name: str) -> bool:
    return (pod.spec.scheduler_name == name
            and pod.status.phase in (api.PENDING, api.RUNNING))


class Scheduler:
    def __init__(
        self,
        clientset: Clientset,
        algorithm: Optional[GenericScheduler] = None,
        backend=None,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        assume_ttl: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        emit_events: bool = True,
        enable_preemption: bool = False,
    ):
        if enable_preemption:
            raise NotImplementedError(
                "preemption is not ported to kubernetes_tpu_torch yet "
                "(ROADMAP.md Queue 1, item 5: Preemption)")
        self.clientset = clientset
        self.algorithm = algorithm or GenericScheduler()
        self.backend = backend  # ops.backend.BatchBackend or None
        self.scheduler_name = scheduler_name
        self.cache = SchedulerCache(ttl=assume_ttl, clock=clock)
        self.queue = SchedulingQueue(clock=clock)
        self.backoff = PodBackoff(clock=clock)
        self.metrics = SchedulerMetrics()
        self.emit_events = emit_events
        self._clock = clock
        self._snapshot: dict[str, NodeInfo] = {}
        self._last_prep_s = 0.0
        # per-wave phase split of the last schedule_pending_batch call:
        # deltas of the backend's timers plus the commit and prep seconds
        self.last_batch_phases: dict = {}
        # async event pipeline (client-go tools/record): the hot path only
        # enqueues; correlation and store writes happen on the sink
        self.broadcaster = EventBroadcaster(clientset, source=scheduler_name, clock=clock)
        self._recorder = self.broadcaster.recorder("Pod")

        self.informers = InformerFactory(clientset)
        self._wire_informers()

    # -- informer wiring (factory.go:140-520) ------------------------------
    def _wire_informers(self) -> None:
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
        ))
        self.informers.informer("Node").add_handler(Handler(
            on_add=lambda n: self.cache.add_node(n),
            on_update=lambda old, new: self.cache.update_node(new),
            on_delete=lambda n: self.cache.remove_node(n.meta.name),
        ))
        # cache-only informers: spreading priorities and volume predicates
        for kind in ("Service", "ReplicaSet", "PersistentVolume", "PersistentVolumeClaim"):
            self.informers.informer(kind)

    def _on_pod_add(self, pod: api.Pod) -> None:
        if pod.spec.node_name:
            self.cache.add_pod(pod)
        elif _is_scheduler_pod(pod, self.scheduler_name):
            self.queue.add(pod)

    def _on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        if new.spec.node_name:
            if old is not None and old.spec.node_name:
                self.cache.update_pod(old, new)
            else:
                self.queue.remove(new.meta.key)
                self.cache.add_pod(new)
        elif _is_scheduler_pod(new, self.scheduler_name):
            self.queue.update(new)
        else:
            # terminal (Failed/Succeeded) or another scheduler's while
            # pending: drop it from the queue
            self.queue.remove(new.meta.key)

    def _on_pod_delete(self, pod: api.Pod) -> None:
        if pod.spec.node_name:
            self.cache.remove_pod(pod)
        else:
            self.queue.remove(pod.meta.key)

    def start(self, manual: bool = True) -> None:
        """Seed the informers.  manual=True: the caller pumps and events
        drain through ``broadcaster.flush()``; manual=False: informer
        threads run the watch loops and the event sink thread runs."""
        if manual:
            self.informers.start_all_manual()
        else:
            self.informers.start_all()
            if self.emit_events:
                self.broadcaster.start()

    def stop(self) -> None:
        """Close the queue (ending a batch loop), drain and stop the event
        sink, and stop the informer threads."""
        self.queue.close()
        self.broadcaster.stop(drain=True)
        self.informers.stop_all()

    def pump(self) -> int:
        n = self.informers.pump_all()
        if not self.broadcaster.running:
            # manual drive: no sink thread, so drain events here
            self.broadcaster.flush()
        return n

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict[str, NodeInfo]:
        """Generation-checked copy-on-write refresh (cache.go:79)."""
        self.cache.snapshot_into(self._snapshot)
        return self._snapshot

    def _volume_listers(self) -> tuple[dict, dict]:
        """(PVs by name, PVCs by namespaced key)."""
        pvs = {pv.meta.name: pv for pv in self.informers.informer("PersistentVolume").list()}
        pvcs = {pvc.meta.key: pvc for pvc in self.informers.informer("PersistentVolumeClaim").list()}
        return pvs, pvcs

    def priority_context(self, snapshot: dict[str, NodeInfo]) -> PriorityContext:
        services = self.informers.informer("Service").list()
        replicasets = self.informers.informer("ReplicaSet").list()
        pvs, pvcs = self._volume_listers()
        return PriorityContext(
            snapshot, services=services, replicasets=replicasets, pvcs=pvcs, pvs=pvs
        )

    # -- events ------------------------------------------------------------
    def _event(self, pod: api.Pod, etype: str, reason: str, message: str) -> None:
        if self.emit_events:
            self._recorder.event(pod, etype, reason, message)

    # -- bind + failure handling ------------------------------------------
    def _requeue_after_bind_failure(self, pod: api.Pod) -> None:
        """A transient bind failure re-enqueues the LATEST informer version
        with backoff, while the pod is still ours to place; a pod bound by
        someone else or turned terminal meanwhile is left alone."""
        latest = self.informers.informer("Pod").get(pod.meta.key)
        if latest is None:
            return  # deleted while the bind was in flight
        if latest.spec.node_name or not _is_scheduler_pod(latest, self.scheduler_name):
            return
        self.metrics.bind_requeues.inc()
        self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))

    def _bind(self, pod: api.Pod, node_name: str) -> bool:
        start = self._clock()
        try:
            self.clientset.pods.bind(api.Binding(
                pod_namespace=pod.meta.namespace, pod_name=pod.meta.name, node_name=node_name))
        except (BindConflictError, NotFoundError) as e:
            # permanent for this placement: the pod is bound elsewhere or
            # deleted, and the informer stream delivers the truth
            logger.warning("bind failed for %s: %s", pod.meta.key, e)
            self.metrics.bind_failures.inc()
            self.cache.forget_pod(pod)
            self._event(pod, "Warning", "FailedBinding", str(e))
            return False
        except Exception as e:
            # transient: the decision may still be right — drop the
            # assumption and retry the pod with backoff
            logger.warning("transient bind failure for %s: %s: %s",
                           pod.meta.key, type(e).__name__, e)
            self.metrics.bind_failures.inc()
            self.cache.forget_pod(pod)
            self._event(pod, "Warning", "FailedBinding", str(e))
            self._requeue_after_bind_failure(pod)
            return False
        self.metrics.binding_latency.observe((self._clock() - start) * 1e6)
        self.cache.finish_binding(pod.meta.key)
        self._event(pod, "Normal", "Scheduled", f"Successfully assigned {pod.meta.key} to {node_name}")
        return True

    def handle_schedule_failure(self, pod: api.Pod, err: Exception,
                                ev_batch: Optional[list] = None) -> None:
        """MakeDefaultErrorFunc (factory.go:718): re-enqueue with backoff.

        Re-enqueues the *latest* version from the informer cache, not the
        popped object: a spec patch that landed while the pod was in
        flight (the missing toleration, say) must not be lost.  Batch
        callers pass ``ev_batch`` to collect the FailedScheduling event
        instead of enqueueing it per pod mid-batch."""
        self.metrics.schedule_failures.inc()
        if ev_batch is not None and self.emit_events:
            ev_batch.append((pod, "Warning", "FailedScheduling", str(err)))
        else:
            self._event(pod, "Warning", "FailedScheduling", str(err))
        latest = self.informers.informer("Pod").get(pod.meta.key)
        if latest is None:
            return  # deleted while we were scheduling it
        if latest.spec.node_name or not _is_scheduler_pod(latest, self.scheduler_name):
            return  # bound by someone else, or became terminal
        self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))

    # -- the per-pod oracle loop (scheduler.go:253) ------------------------
    def schedule_one(self, timeout: Optional[float] = 0.0, async_bind: bool = False) -> bool:
        pod = self.queue.pop(timeout=timeout)
        if pod is None:
            return False
        start = self._clock()
        trace = Trace(f"Scheduling {pod.meta.key}", clock=self._clock)
        self.metrics.schedule_attempts.inc()
        snapshot = self.snapshot()
        trace.step("snapshot")
        try:
            algo_start = self._clock()
            result = self.algorithm.schedule(pod, snapshot, self.priority_context(snapshot))
            self.metrics.scheduling_algorithm_latency.observe((self._clock() - algo_start) * 1e6)
        except FitError as e:
            self.handle_schedule_failure(pod, e)
            return True
        trace.step("schedule")
        self.cache.assume_pod(pod, result.node_name)
        self.backoff.forget(pod.meta.key)
        if async_bind:
            threading.Thread(target=self._bind, args=(pod, result.node_name), daemon=True).start()
        else:
            self._bind(pod, result.node_name)
        trace.step("bind")
        self.metrics.e2e_scheduling_latency.observe((self._clock() - start) * 1e6)
        trace.log_if_long(0.1)
        return True

    def run_pending(self, max_pods: Optional[int] = None, pump_every: int = 100) -> int:
        """Drive schedule_one until the queue drains (test/bench harness)."""
        n = 0
        while (max_pods is None or n < max_pods) and len(self.queue) > 0:
            if not self.schedule_one(timeout=0.0):
                break
            n += 1
            if n % pump_every == 0:
                self.pump()
        self.pump()
        return n

    # -- the steady-state pipeline -----------------------------------------
    def _poll_full_device_window(self) -> bool:
        """Should the overlapped prep keep polling for the whole scan?  A
        card executes off the host CPU, so polling hides in its shadow;
        the CPU scan shares the host cores and needs a spare one."""
        if self.backend is not None and self.backend.device.type == "cuda":
            return True
        return (os.cpu_count() or 1) > 1

    def _pipeline_idle(self, device_busy: Optional[Callable[[], bool]] = None) -> None:
        """Cross-wave overlapped prep, run by the backend while the final
        segment scans: pump the informers (the next wave's arrivals and
        this wave's earlier bind confirmations are digested before the
        next drain) and warm the per-pod signature and content memos of
        everything queued.  With a ``device_busy`` probe the prep keeps
        pumping, ``_PREP_POLL_S`` apart, until the scan ends.

        Touches only informers, cache and queue, never the snapshot the
        in-flight batch was tensorized from, so this wave's decisions are
        already fixed.  A failure here is contained: the work re-runs at
        the next wave's start, which is the unpipelined behavior."""
        # imported here: models.snapshot imports this package's modules
        from ..models.snapshot import _pod_content_key, pod_signature_key

        t0 = time.perf_counter()
        poll = device_busy is not None and self._poll_full_device_window()
        try:
            while True:
                self.pump()
                for pod in self.queue.snapshot_pending():
                    pod_signature_key(pod)
                    _pod_content_key(pod)
                if not poll or not device_busy():
                    break
                time.sleep(_PREP_POLL_S)
        except Exception as e:
            self.metrics.pipeline_prep_failures.inc()
            logger.warning("overlapped prep failed (work deferred to the "
                           "next wave): %s: %s", type(e).__name__, e)
        finally:
            self._last_prep_s = time.perf_counter() - t0
            self.metrics.pipeline_prep_latency.observe(self._last_prep_s * 1e6)

    def run_batch_loop(
        self,
        min_batch: int = 1,
        max_wait: float = 0.05,
        idle_timeout: Optional[float] = None,
        max_waves: Optional[int] = None,
        poll_interval: float = 0.005,
        max_batch: Optional[int] = None,
        stop: Optional[threading.Event] = None,
    ) -> int:
        """Continuous service: drain and schedule as pods arrive, under a
        min-batch/max-wait accumulation policy, until the queue is closed
        (or ``stop`` is set, or ``idle_timeout``/``max_waves`` ends the
        loop).  Each iteration pumps the informers (a no-op when watch
        threads own the streams), waits until ``min_batch`` pods are ready
        or ``max_wait`` has passed since the first ready pod, and runs one
        pipelined wave.  Returns total pods bound."""
        bound_total = 0
        waves = 0

        def stopped() -> bool:
            return self.queue.closed or (stop is not None and stop.is_set())

        idle_deadline = (self._clock() + idle_timeout
                         if idle_timeout is not None else None)
        while not stopped() and (max_waves is None or waves < max_waves):
            self.pump()
            ready = len(self.queue)
            self.metrics.pending_pods.set(float(ready))
            if ready == 0:
                if idle_deadline is not None and self._clock() >= idle_deadline:
                    break
                self.queue.wait_ready(timeout=poll_interval)
                continue
            t_first = self._clock()
            while (ready < min_batch and not stopped()
                   and self._clock() - t_first < max_wait):
                # a plain sleep, not wait_ready: a pod is already ready, so
                # wait_ready would return at once and spin
                time.sleep(poll_interval)
                self.pump()
                ready = len(self.queue)
            self.metrics.batch_queue_wait.observe((self._clock() - t_first) * 1e6)
            self.metrics.pending_pods.set(float(ready))
            bound, _ = self.schedule_pending_batch(max_batch)
            bound_total += bound
            waves += 1
            idle_deadline = (self._clock() + idle_timeout
                             if idle_timeout is not None else None)
        return bound_total

    # -- the batch path ----------------------------------------------------
    def schedule_pending_batch(self, max_batch: Optional[int] = None) -> tuple[int, int]:
        """Drain the queue, schedule the batch on the backend, and assume +
        bind each segment's results in pod order.  Returns (bound, failed)."""
        if self.backend is None:
            raise RuntimeError("no batch backend configured")
        pods = self.queue.drain(max_batch)
        if not pods:
            return (0, 0)
        self.metrics.batch_size.observe(len(pods))
        # Cyclic GC is paused for the whole batch: at 10^5 pods a
        # collection walks millions of live objects and costs more than
        # everything it frees
        gc_was_enabled = gc.isenabled()
        gc.disable()
        totals = {"bound": 0, "failed": 0, "commit_s": 0.0}
        # ONE event enqueue for the whole batch, after the last commit: a
        # per-segment enqueue would wake the sink thread mid-batch, and its
        # store writes would take the GIL from the host phases outside the
        # card's shadow
        ev_batch: list = []
        start = self._clock()

        def commit_segment(entries: list) -> None:
            """Assume + bind + record one segment's results; the backend
            calls this while the card scans the NEXT segment."""
            t_commit = time.perf_counter()
            to_bind: list[tuple[api.Pod, api.Binding]] = []
            to_assume: list[tuple] = []
            for pod, node_name, req_vec, nz_vec in entries:
                if node_name is None:
                    self.handle_schedule_failure(pod, FitError(pod, {}), ev_batch)
                    totals["failed"] += 1
                    continue
                # the kernel path's per-signature request vectors spare the
                # cache assume a per-pod quantity parse
                to_assume.append((pod, node_name, req_vec, nz_vec))
                self.backoff.forget(pod.meta.key)
                to_bind.append((pod, api.Binding(
                    pod_namespace=pod.meta.namespace, pod_name=pod.meta.name,
                    node_name=node_name)))
            self.cache.assume_many(to_assume)
            bind_start = self._clock()
            try:
                errors = self.clientset.pods.bind_many([b for _, b in to_bind])
            except Exception as e:
                # the whole txn failed before any CAS applied: every entry
                # takes the per-item failure path below
                logger.warning("bind_many failed for %d pods: %s: %s",
                               len(to_bind), type(e).__name__, e)
                errors = [f"transient: {e}"] * len(to_bind)
            self.metrics.binding_latency.observe((self._clock() - bind_start) * 1e6)
            finished: list[str] = []
            emit = self.emit_events
            for (pod, binding), err in zip(to_bind, errors):
                if err is None:
                    finished.append(pod.meta.key)
                    if emit:
                        ev_batch.append((pod, "Normal", "Scheduled",
                                         ("Successfully assigned %s to %s",
                                          pod.meta.key, binding.node_name)))
                    totals["bound"] += 1
                else:
                    logger.warning("bind failed for %s: %s", pod.meta.key, err)
                    self.metrics.bind_failures.inc()
                    self.cache.forget_pod(pod)
                    if emit:
                        ev_batch.append((pod, "Warning", "FailedBinding", err))
                    self._requeue_after_bind_failure(pod)
                    totals["failed"] += 1
            self.cache.finish_binding_many(finished)
            # per-segment e2e SLI: pods committed in segment s were bound
            # NOW, not at batch end — one observe_many per segment keeps
            # p50 and p99 distinct without per-pod lock rounds
            self.metrics.e2e_scheduling_latency.observe_many(
                (self._clock() - start) * 1e6, len(to_bind))
            totals["commit_s"] += time.perf_counter() - t_commit

        bstats = self.backend.stats
        pre_phases = {k: bstats[k] for k in _PHASE_KEYS}
        self._last_prep_s = 0.0
        try:
            snapshot = self.snapshot()
            pctx = self.priority_context(snapshot)
            algo_start = self._clock()
            self.backend.schedule_batch(pods, snapshot, pctx, on_segment=commit_segment,
                                        on_idle=self._pipeline_idle)
            # wall time of the whole dispatch; commits of all but the final
            # segment ran in the card's shadow
            self.metrics.batch_device_latency.observe((self._clock() - algo_start) * 1e6)
            self.metrics.schedule_attempts.inc(len(pods))
            self.last_batch_phases = {k: bstats[k] - pre_phases[k] for k in _PHASE_KEYS}
            self.last_batch_phases["commit_s"] = totals["commit_s"]
            self.last_batch_phases["prep_s"] = self._last_prep_s
            self.metrics.pipeline_device_wait.observe(
                self.last_batch_phases["device_wait_s"] * 1e6)
        finally:
            if gc_was_enabled:
                gc.enable()
            # committed segments' events survive a mid-batch failure:
            # their pods ARE bound
            if ev_batch:
                self._recorder.event_batch(ev_batch)
        if self.emit_events and not self.broadcaster.running:
            self.broadcaster.flush()
        return (totals["bound"], totals["failed"])

    # -- housekeeping ------------------------------------------------------
    def cleanup(self) -> list[str]:
        return self.cache.cleanup_expired()
