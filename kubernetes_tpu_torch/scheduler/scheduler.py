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
under a min-batch/max-wait policy.  If anything leaves the backend (a
kernel fault, real or injected), the pods no committed segment took are
requeued before the error goes on.

Preemption (the PostFilter phase, on by default as in the JAX package): a
priority pod that fits nowhere evicts a minimal set of lower-priority
victims (``preemption.py``).  The per-pod path tries it at once
(``_try_preempt``); the batch path collects the wave's failed priority
pods and runs one cohort pass after the scan (``_preempt_cohort``, with
the vectorized ``ops.preemption_kernel.PreemptionState``).  Each evicted
preemptor is requeued at once and binds in the next wave.

Ingest: the pod handlers route on ``lazy.pod_brief`` (node name, scheduler
name and phase read straight off a lazy pod's wire dict), and a
``bind_many`` watch frame confirms the whole wave's assumptions in one
cache lock hold (``SchedulerCache.confirm_many``); what its revision fence
rejects takes the per-pod path.

Tracing (``utils/tracing.py``): each batch wave is one ``wave-N`` root
span; the backend's ``tensorize``/``dispatch``/``oracle`` spans, the
``commit`` and ``prep`` phases, ``ingest.pump`` and the informers' spans
nest under it on this thread.  Fault points: ``scheduler.bind`` (the
per-pod bind; ``bind_many`` items fail in the store) and
``scheduler.pipeline.prep``.  Overload (``utils/overload.py``): with a
``DegradationLadder`` attached, the batch loop re-reads the ladder every
iteration (wider accumulation at rung 1, the interpod score plane shed
and preemption reserved for the critical tier at rung 2).
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Callable, Optional

from .. import faults
from ..api import lazy
from ..api import types as api
from ..client.clientset import BindConflictError, Clientset
from ..client.informer import Handler, InformerFactory
from ..client.record import EventBroadcaster
from ..store.store import ADDED, MODIFIED, NotFoundError
from ..utils import tracing
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
    _, sched_name, phase = lazy.pod_brief(pod)
    return sched_name == name and phase in (api.PENDING, api.RUNNING)


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
        enable_preemption: bool = True,
    ):
        self.clientset = clientset
        self.algorithm = algorithm or GenericScheduler()
        self.backend = backend  # ops.backend.BatchBackend or None
        self.scheduler_name = scheduler_name
        self.cache = SchedulerCache(ttl=assume_ttl, clock=clock)
        self.queue = SchedulingQueue(clock=clock)
        self.backoff = PodBackoff(clock=clock)
        self.metrics = SchedulerMetrics()
        if backend is not None and hasattr(backend, "shed_counter"):
            backend.shed_counter = self.metrics.score_plane_sheds
            backend.oracle_counter = self.metrics.oracle_pods
        if backend is not None and hasattr(backend, "frontier_counter"):
            backend.frontier_counter = self.metrics.frontier_compactions
        # the overload ladder (attach_overload); None = full fidelity
        self.overload = None
        # attributes the batch loop stamps onto the next wave's root span
        self._wave_attrs_pending: dict = {}
        self.emit_events = emit_events
        self.enable_preemption = enable_preemption
        self._clock = clock
        self._snapshot: dict[str, NodeInfo] = {}
        self._last_prep_s = 0.0
        # per-wave phase split of the last schedule_pending_batch call:
        # deltas of the backend's timers plus the commit and prep seconds
        self.last_batch_phases: dict = {}
        # seconds of the last cohort pass: the state's build, the
        # per-preemptor ranking (victim selection), and the evictions with
        # the pump and snapshot that observe them
        self.last_cohort_phases: dict = {}
        # async event pipeline (client-go tools/record): the hot path only
        # enqueues; correlation and store writes happen on the sink
        self.broadcaster = EventBroadcaster(clientset, source=scheduler_name, clock=clock)
        self._recorder = self.broadcaster.recorder("Pod")

        self.informers = InformerFactory(clientset)
        self._wire_informers()
        # the ingest counters at the end of the last wave: a wave's ingest
        # is what the informers did since (arrivals, the bind confirm of
        # the previous wave, this wave's prep pump), on whatever thread
        self._ingest_mark = self._ingest_stats() + (0.0,)

    # -- informer wiring (factory.go:140-520) ------------------------------
    def _wire_informers(self) -> None:
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
            on_batch=self._on_pod_frame,
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
        # pod_brief reads the routing fields off a lazy pod's wire dict:
        # routing builds no spec or status view
        node_name, sched_name, phase = lazy.pod_brief(pod)
        if node_name:
            self.cache.add_pod(pod)
        elif sched_name == self.scheduler_name and phase in (api.PENDING, api.RUNNING):
            self.queue.add(pod)

    def _on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        if lazy.pod_brief(new)[0]:
            if old is not None and lazy.pod_brief(old)[0]:
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
        if lazy.pod_brief(pod)[0]:
            self.cache.remove_pod(pod)
        else:
            self.queue.remove(pod.meta.key)

    def _on_pod_frame(self, frame, deltas) -> None:
        """Batch-aware pod routing (``Handler.on_batch``): a watch frame
        carries a whole store txn.  A bind-confirm frame (``bind_many``:
        MODIFIED entries with a node and a prev-revision column) confirms
        the wave against the frame's identity, node and prev-revision
        columns in one cache lock hold (``SchedulerCache.confirm_many``).
        What the revision fence rejects, and every other delta, takes the
        per-pod routing, so the outcome equals per-event delivery.  Its
        span carries the store txn's correlation id."""
        tr = tracing.current()
        if tr is None:
            return self._route_pod_frame(frame, deltas)
        with tr.span("scheduler.confirm", cat="ingest", kind=frame.kind, txn=frame.txn,
                     events=len(deltas)) as sp:
            fb0 = self.metrics.confirm_fallbacks.value
            self._route_pod_frame(frame, deltas)
            sp.set(fallbacks=int(self.metrics.confirm_fallbacks.value - fb0))

    def _route_pod_frame(self, frame, deltas) -> None:
        self.metrics.watch_frames.inc()
        self.metrics.watch_frame_events.inc(len(deltas))
        rest = deltas
        prev = frame.prev_revisions
        if prev is not None:
            node_names = frame.node_names
            keys = frame.keys
            confirmable: list = []
            rest = []
            for d in deltas:
                etype, old, new, i = d
                if etype == MODIFIED and node_names[i]:
                    confirmable.append((keys[i], node_names[i], prev[i], new, old))
                else:
                    rest.append(d)
            if confirmable:
                # one queue lock and one cache lock for the whole wave
                self.queue.remove_many([c[0] for c in confirmable])
                for _key, _node, _prev, new, old in self.cache.confirm_many(confirmable):
                    # no assumption, another node, or an intervening
                    # write: the per-pod compare decides
                    self.metrics.confirm_fallbacks.inc()
                    self._on_pod_update(old, new)
        for etype, old, new, _i in rest:
            if etype == ADDED:
                self._on_pod_add(new)
            elif etype == MODIFIED:
                self._on_pod_update(old, new)
            else:
                self._on_pod_delete(old if old is not None else new)

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
        tr = tracing.current()
        with (tr.span("ingest.pump", cat="ingest")
              if tr is not None else tracing.NULL_SPAN) as sp:
            n = self.informers.pump_all()
            if not self.broadcaster.running:
                # manual drive: no sink thread, so drain events here
                self.broadcaster.flush()
            sp.set(events=n)
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
        # a decided placement that did not land: a flight-recorder trigger
        tracing.notify_requeue(pod.meta.key)
        self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))

    def _bind(self, pod: api.Pod, node_name: str) -> bool:
        tr = tracing.current()
        with (tr.span("scheduler.bind", cat="bind", pod=pod.meta.key, node=node_name)
              if tr is not None else tracing.NULL_SPAN):
            return self._bind_attempt(pod, node_name)

    def _bind_attempt(self, pod: api.Pod, node_name: str) -> bool:
        start = self._clock()
        try:
            faults.hit("scheduler.bind", pod=pod.meta.key, node=node_name, via="bind")
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
                                ev_batch: Optional[list] = None,
                                preempt_cohort: Optional[list] = None) -> None:
        """MakeDefaultErrorFunc (factory.go:718): re-enqueue with backoff.

        Re-enqueues the *latest* version from the informer cache, not the
        popped object: a spec patch that landed while the pod was in
        flight (the missing toleration, say) must not be lost.

        For priority pods, tries preemption first (the PostFilter phase):
        evicting a minimal set of lower-priority victims and requeueing the
        preemptor without backoff into the freed space.  Under overload
        rung 2 only the critical tier may preempt; the others are backed
        off and counted (``preemption_sheds``).

        ``ev_batch``: batch callers pass a list to collect the
        FailedScheduling event instead of enqueueing it per pod mid-batch.
        ``preempt_cohort``: batch callers pass a list to DEFER priority
        pods' preemption to one cohort pass after the drain
        (``_preempt_cohort``)."""
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
        if self.enable_preemption and latest.spec.priority > 0:
            ov = self.overload
            if ov is not None and ov.classifier.tier_of(latest) < ov.preempt_tier_floor:
                self.metrics.preemption_sheds.inc()
            elif preempt_cohort is not None:
                preempt_cohort.append(latest)  # requeue decided at cohort time
                return
            elif self._try_preempt(latest):
                self.queue.add(latest)  # victims evicted; retry immediately
                return
        self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))

    def _evict_victims(self, pod: api.Pod, target, ev_batch: Optional[list] = None) -> None:
        for victim in target.victims:
            try:
                self.clientset.pods.delete(victim.meta.name, victim.meta.namespace)
                self.metrics.preemption_victims.inc()
                msg = (f"Preempted by {pod.meta.key} (priority "
                       f"{pod.spec.priority}) on {target.node_name}")
                if ev_batch is not None and self.emit_events:
                    ev_batch.append((victim, "Normal", "Preempted", msg))
                else:
                    self._event(victim, "Normal", "Preempted", msg)
            except NotFoundError:
                continue

    def _try_preempt(self, pod: api.Pod) -> bool:
        from .preemption import find_preemption_target

        start = self._clock()
        self.metrics.preemption_attempts.inc()
        pvs, pvcs = self._volume_listers()
        target = find_preemption_target(
            pod, self.snapshot(), self.algorithm.predicates, pvcs=pvcs, pvs=pvs
        )
        if target is None:
            self.metrics.preemption_latency.observe((self._clock() - start) * 1e6)
            return False
        self._evict_victims(pod, target)
        self.pump()  # observe the deletions so the next attempt sees freed space
        self.metrics.preemption_latency.observe((self._clock() - start) * 1e6)
        return True

    def _preempt_cohort(self, cohort: list, ev_batch: Optional[list] = None) -> int:
        """Batch-path PostFilter: the vectorized state bounds every
        (preemptor, node) pair's victim cost; the exact reprieve evaluation
        then runs only on nodes whose bound can win
        (``find_preemption_target_fast``, whose decisions equal the per-pod
        oracle's on the same state by construction).  Preemptors are
        processed in batch order; each eviction updates the state columns
        of the touched node so later preemptors see the new truth.  Returns
        the number of successful preemptions; every cohort pod is requeued
        (immediately on success, with backoff otherwise).

        As in the JAX package, the state's rows are refreshed only for the
        evicted node: a pump that delivers other nodes' changes mid-cohort
        (threaded informers, concurrent writers) leaves their rows stale,
        and a priority level that appears mid-cohort is never freeable
        (``PreemptionState.update_node``)."""
        from ..models.snapshot import pod_signature_key
        from ..ops.preemption_kernel import PreemptionState
        from .preemption import _fast_eligible, find_preemption_target_fast
        from .units import pod_request_vec

        if not cohort:
            return 0
        t_start = time.perf_counter()
        snapshot = self.snapshot()
        pvs, pvcs = self._volume_listers()
        state = PreemptionState(snapshot)
        rank_s = evict_s = 0.0
        t_built = time.perf_counter()
        # node-static predicate gate memo per preemptor SIGNATURE (the gate
        # is victim-independent and generation-checked inside
        # find_preemption_target_fast, so same-template preemptors pay it
        # once per node across the whole cohort)
        static_caches: dict = {}
        preempted = 0
        # fits-now recheck state: shadow clones of earlier-eviction targets
        # (the ONLY nodes that can have become feasible since the batch
        # proved these pods unschedulable).  ``claims`` carries every
        # cohort member already promised capacity on a node, and shadows
        # are rebuilt as fresh state plus claims, so a second eviction on
        # the same node never drops earlier claimants.  Capped: a huge
        # touched set turns the recheck off.
        recheck_shadow: dict[str, NodeInfo] = {}
        claims: dict[str, list] = {}
        recheck_cap = 64
        for pod in cohort:
            start = self._clock()
            self.metrics.preemption_attempts.inc()
            latest = self.informers.informer("Pod").get(pod.meta.key)
            if latest is None:
                continue  # deleted while deferred
            if latest.spec.node_name or not _is_scheduler_pod(latest, self.scheduler_name):
                continue
            t_rank = time.perf_counter()
            cands: list = []
            if not _fast_eligible(latest, self.algorithm.predicates):
                # odd preemptors (ports, volumes, own required affinity, a
                # custom predicate set) take the branch-and-bound path,
                # which needs the prefilter bounds; the fast vectorized path
                # derives everything from `state` directly
                cands = state.candidates_for(
                    pod_request_vec(latest).units, latest.spec.priority)
            target = find_preemption_target_fast(
                latest, snapshot, cands, self.algorithm.predicates,
                pvcs=pvcs, pvs=pvs,
                static_cache=static_caches.setdefault(pod_signature_key(latest), {}),
                state=state,
                recheck_nodes=sorted(recheck_shadow.items())
                if 0 < len(recheck_shadow) <= recheck_cap else None)
            t_ranked = time.perf_counter()
            rank_s += t_ranked - t_rank
            if target is None:
                self.metrics.preemption_latency.observe((self._clock() - start) * 1e6)
                self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))
                continue
            if not target.victims:
                # an earlier cohort eviction already freed space this pod
                # provably fits into: no eviction, retry immediately, and
                # record the claim so later cohort members see it taken
                claims.setdefault(target.node_name, []).append(latest)
                shadow = recheck_shadow.get(target.node_name)
                if shadow is not None:
                    shadow.add_pod(latest)
                self.queue.add(latest)
                self.metrics.preemption_latency.observe((self._clock() - start) * 1e6)
                continue
            self._evict_victims(latest, target, ev_batch)
            self.pump()  # observe deletions: cache and informers advance
            snapshot = self.snapshot()
            fresh = snapshot.get(target.node_name)
            state.update_node(target.node_name, fresh)
            evict_s += time.perf_counter() - t_ranked
            claims.setdefault(target.node_name, []).append(latest)
            if fresh is not None:
                # shadow = post-eviction state PLUS every outstanding claim
                # on this node: later cohort members must not be granted
                # already-promised capacity
                shadow = fresh.clone()
                for claimant in claims[target.node_name]:
                    shadow.add_pod(claimant)
                recheck_shadow[target.node_name] = shadow
            preempted += 1
            self.queue.add(latest)  # retry immediately into the freed space
            self.metrics.preemption_latency.observe((self._clock() - start) * 1e6)
        self.last_cohort_phases = {
            "preemptors": len(cohort), "preempted": preempted,
            "state_s": t_built - t_start, "rank_s": rank_s, "evict_s": evict_s,
            "total_s": time.perf_counter() - t_start}
        return preempted

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
            faults.hit("scheduler.pipeline.prep")
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
            t_end = time.perf_counter()
            self._last_prep_s = t_end - t0
            self.metrics.pipeline_prep_latency.observe(self._last_prep_s * 1e6)
            tr = tracing.current()
            if tr is not None:
                # the overlapped prep inside the wave (same clock reads)
                tr.complete("prep", t0, t_end, cat="phase", polled=poll)

    # -- overload control ---------------------------------------------------
    def attach_overload(self, ladder) -> None:
        """Wire a ``utils.overload.DegradationLadder``: its rung lands in
        this scheduler's gauge and counter, and the batch loop reads it
        every iteration (accumulation knobs, the score-plane shed, the
        preemption tier floor)."""
        self.overload = ladder
        ladder.gauge = self.metrics.degradation_rung
        ladder.transition_counter = self.metrics.degradation_transitions

    def _apply_overload_knobs(self) -> None:
        """Push the ladder's rung-2 shed onto the backend before a wave."""
        ov = self.overload
        if ov is not None and self.backend is not None and hasattr(self.backend,
                                                                   "shed_score_planes"):
            self.backend.shed_score_planes = ov.shed_score_planes

    def _top_tier_ready(self) -> bool:
        """A critical-tier pod waits in the queue: under overload the
        accumulation window ends early for it.  O(pending); rate-limited
        by the caller."""
        ov = self.overload
        if ov is None:
            return False
        cls = ov.classifier
        return any(cls.tier_of(pod) >= cls.CRITICAL for pod in self.queue.snapshot_pending())

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
            # the ladder is read every iteration: a rung change takes
            # effect at the next wave
            ov = self.overload
            eff_min_batch, eff_max_wait = min_batch, max_wait
            if ov is not None:
                ov.poll()
                eff_min_batch, eff_max_wait = ov.batch_knobs(min_batch, max_wait)
            t_first = self._clock()
            tier_check_at = t_first
            while (ready < eff_min_batch and not stopped()
                   and self._clock() - t_first < eff_max_wait):
                # a plain sleep, not wait_ready: a pod is already ready, so
                # wait_ready would return at once and spin
                time.sleep(poll_interval)
                self.pump()
                ready = len(self.queue)
                if ov is not None and ov.rung >= 1:
                    now = self._clock()
                    if now >= tier_check_at:
                        tier_check_at = now + 0.025
                        if self._top_tier_ready():
                            break  # critical pods never wait the widened window
            queue_wait = self._clock() - t_first
            self.metrics.batch_queue_wait.observe(queue_wait * 1e6)
            self.metrics.pending_pods.set(float(ready))
            # the accumulation window rides on the next wave's root span
            self._wave_attrs_pending = {"queue_wait_s": round(queue_wait, 6),
                                        "accumulated": ready, "min_batch": eff_min_batch}
            if ov is not None:
                self._wave_attrs_pending["overload_rung"] = ov.rung
            bound, _ = self.schedule_pending_batch(max_batch)
            bound_total += bound
            waves += 1
            idle_deadline = (self._clock() + idle_timeout
                             if idle_timeout is not None else None)
        return bound_total

    def _ingest_stats(self) -> tuple:
        """Cumulative ingest counters over this scheduler's informers:
        (decode s, lazy promotions, apply s, frames, frame events, parse
        s).  Parse is the wire client's watch-line parse, which runs on
        the watch readers before an informer decodes (0 in process).
        Their per-wave deltas land in ``last_batch_phases``."""
        decode_s = apply_s = 0.0
        frames = frame_events = 0
        for inf in self.informers.informers():
            st = inf.stats
            decode_s += st["decode_s"]
            apply_s += st["apply_s"]
            frames += st["frames"]
            frame_events += st["frame_events"]
        promos = lazy.STATS["promotions"] + lazy.STATS["sections"]
        parse = getattr(getattr(self.clientset.store, "metrics", None), "watch_parse_seconds", None)
        parse_s = parse.value if parse is not None else 0.0
        return decode_s, promos, apply_s, frames, frame_events, parse_s

    # -- the batch path ----------------------------------------------------
    def schedule_pending_batch(self, max_batch: Optional[int] = None) -> tuple[int, int]:
        """Drain the queue, schedule the batch on the backend, and assume +
        bind each segment's results in pod order; then one preemption pass
        over the wave's failed priority pods.  Returns (bound, failed).

        If the backend raises, every drained pod that no committed segment
        took is requeued before the error goes on: a card fault loses no
        pod in process."""
        if self.backend is None:
            raise RuntimeError("no batch backend configured")
        pods = self.queue.drain(max_batch)
        if not pods:
            return (0, 0)
        self._apply_overload_knobs()
        self.metrics.batch_size.observe(len(pods))
        tr = tracing.current()
        # Cyclic GC is paused for the whole batch: at 10^5 pods a
        # collection walks millions of live objects and costs more than
        # everything it frees
        gc_was_enabled = gc.isenabled()
        gc.disable()
        totals = {"bound": 0, "failed": 0, "committed": 0, "commit_s": 0.0}
        # ONE event enqueue for the whole batch, after the last commit: a
        # per-segment enqueue would wake the sink thread mid-batch, and its
        # store writes would take the GIL from the host phases outside the
        # card's shadow
        ev_batch: list = []
        # priority pods whose scheduling failed: preemption is deferred to
        # ONE cohort pass after the scan (see _preempt_cohort)
        preempt_cohort: Optional[list] = [] if self.enable_preemption else None
        start = self._clock()

        def commit_segment(entries: list) -> None:
            """Assume + bind + record one segment's results; the backend
            calls this while the card scans the NEXT segment."""
            t_commit = time.perf_counter()
            to_bind: list[tuple[api.Pod, api.Binding]] = []
            to_assume: list[tuple] = []
            for pod, node_name, req_vec, nz_vec in entries:
                if node_name is None:
                    self.handle_schedule_failure(pod, FitError(pod, {}), ev_batch,
                                                 preempt_cohort=preempt_cohort)
                    totals["failed"] += 1
                    continue
                # the kernel path's per-signature request vectors spare the
                # cache assume a per-pod quantity parse
                to_assume.append((pod, node_name, req_vec, nz_vec))
                self.backoff.forget(pod.meta.key)
                to_bind.append((pod, api.Binding(
                    pod_namespace=pod.meta.namespace, pod_name=pod.meta.name,
                    node_name=node_name)))
            held = self.cache.assume_many(to_assume)
            if held:
                # bound meanwhile (a bind that landed before its reply was
                # lost, then the relist): not bound again
                logger.warning("%d pods of the wave are already in the scheduler cache, "
                               "not bound again: %s", len(held), held[:5])
                held = set(held)
                to_bind = [x for x in to_bind if x[0].meta.key not in held]
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
            # entries arrive in pod order: the committed pods are a prefix
            # of the drained batch
            totals["committed"] += len(entries)
            t_commit_end = time.perf_counter()
            totals["commit_s"] += t_commit_end - t_commit
            if tr is not None:
                # the same clock reads as commit_s
                tr.complete("commit", t_commit, t_commit_end, cat="phase", pods=len(entries),
                            bound=len(finished))

        bstats = self.backend.stats
        pre_phases = {k: bstats[k] for k in _PHASE_KEYS}
        # blocking device-to-host reads and the node cache's uploads: the
        # same pre/post deltas as the phase timers
        pre_syncs = bstats.get("host_syncs", 0)
        ncache = getattr(self.backend, "device_node_cache", None)
        pre_cols = ((ncache.stats["dirty_cols"], ncache.stats["cols_total"])
                    if ncache is not None else None)
        self._last_prep_s = 0.0
        # one span tree a wave: everything this thread does for the batch
        # nests under the root, entered right before the try so that no
        # exception path leaks an open root
        wave_cm = wave_span = None
        if tr is not None:
            wave_cm = tr.wave(pods=len(pods), **self._wave_attrs_pending)
            wave_span = wave_cm.__enter__()
        self._wave_attrs_pending = {}
        wave_exc = None
        try:
            snapshot = self.snapshot()
            pctx = self.priority_context(snapshot)
            algo_start = self._clock()
            try:
                self.backend.schedule_batch(pods, snapshot, pctx, on_segment=commit_segment,
                                            on_idle=self._pipeline_idle)
            except BaseException as e:
                wave_exc = e
                self._requeue_uncommitted(pods[totals["committed"]:])
                # the committed prefix's failed priority pods wait on a
                # cohort pass that will not run: back them off as failures
                self._requeue_uncommitted(preempt_cohort or [], backoff=True)
                raise
            # wall time of the whole dispatch; commits of all but the final
            # segment ran in the card's shadow
            self.metrics.batch_device_latency.observe((self._clock() - algo_start) * 1e6)
            self.metrics.schedule_attempts.inc(len(pods))
            if preempt_cohort:
                # PostFilter: one vectorized pass over the failed priority
                # pods, exact victim selection on the survivors
                self._preempt_cohort(preempt_cohort, ev_batch)
            self.last_batch_phases = {k: bstats[k] - pre_phases[k] for k in _PHASE_KEYS}
            self.last_batch_phases["commit_s"] = totals["commit_s"]
            self.last_batch_phases["prep_s"] = self._last_prep_s
            wave_syncs = int(bstats.get("host_syncs", 0) - pre_syncs)
            self.last_batch_phases["host_syncs"] = wave_syncs
            if wave_syncs:
                self.metrics.host_syncs.inc(wave_syncs)
            if wave_span is not None:
                wave_span.set(host_syncs=wave_syncs)
            if pre_cols is not None:
                dirty = ncache.stats["dirty_cols"] - pre_cols[0]
                cols = ncache.stats["cols_total"] - pre_cols[1]
                if cols > 0:
                    self.metrics.tensorize_upload_fraction.observe(dirty / cols)
                    if wave_span is not None:
                        # tensorize attribution: the node axis's upload
                        wave_span.set(dirty_cols=dirty, cols_total=cols,
                                      upload_fraction=round(dirty / cols, 4))
            # the frontier trajectory of this wave, one entry a segment
            lf = getattr(self.backend, "last_frontier", None)
            if lf:
                self.last_batch_phases["frontier"] = [dict(seg) for seg in lf]
                if wave_span is not None:
                    wave_span.set(frontier=[dict(seg) for seg in lf])
                for seg in lf:
                    if seg.get("alive_frac"):
                        self.metrics.frontier_alive_fraction.observe(min(seg["alive_frac"]))
            self.metrics.pipeline_device_wait.observe(
                self.last_batch_phases["device_wait_s"] * 1e6)
            # the ingest of the wave: informer decode and application
            # (cache apply, handler fan-out, the frame confirm), lazy
            # promotions, frames and the confirm's fallbacks since the
            # last wave ended
            post = self._ingest_stats() + (self.metrics.confirm_fallbacks.value,)
            decode_s, promos, apply_s, frames, frame_events, parse_s, fallbacks = (
                b - a for a, b in zip(self._ingest_mark, post))
            self._ingest_mark = post
            self.last_batch_phases.update(
                decode_s=decode_s, promotions=promos, apply_s=apply_s, frames=frames,
                frame_events=frame_events, parse_s=parse_s, confirm_fallbacks=int(fallbacks))
            self.metrics.ingest_decode_seconds.observe(decode_s)
            self.metrics.ingest_parse_seconds.observe(parse_s)
            if promos > 0:
                self.metrics.ingest_promotions.inc(promos)
            self.metrics.pump_apply_seconds.observe(apply_s)
            if wave_span is not None:
                wave_span.set(decode_s=round(decode_s, 6), promotions=promos,
                              apply_s=round(apply_s, 6), frames=frames,
                              frame_events=frame_events)
        finally:
            if wave_cm is not None:
                wave_span.set(bound=totals["bound"], failed=totals["failed"],
                              committed=totals["committed"])
                wave_cm.__exit__(type(wave_exc) if wave_exc is not None else None, wave_exc,
                                 None)
                # the phase split from the wave's spans: the same clock
                # reads as the stats timers, so the two agree
                self.last_batch_phases.update(wave_span.phase_totals())
            if gc_was_enabled:
                gc.enable()
            # committed segments' events survive a mid-batch failure:
            # their pods ARE bound
            if ev_batch:
                self._recorder.event_batch(ev_batch)
        if self.emit_events and not self.broadcaster.running:
            self.broadcaster.flush()
        return (totals["bound"], totals["failed"])

    def _requeue_uncommitted(self, pods: list, backoff: bool = False) -> None:
        """Put back drained pods no committed segment took, in their latest
        informer version, while each is still ours to place; with
        ``backoff``, after each pod's backoff."""
        pod_informer = self.informers.informer("Pod")
        for pod in pods:
            latest = pod_informer.get(pod.meta.key)
            if (latest is not None and not latest.spec.node_name
                    and _is_scheduler_pod(latest, self.scheduler_name)):
                if backoff:
                    self.queue.add_after(latest, self.backoff.get_backoff(pod.meta.key))
                else:
                    self.queue.add(latest)

    # -- housekeeping ------------------------------------------------------
    def cleanup(self) -> list[str]:
        return self.cache.cleanup_expired()
