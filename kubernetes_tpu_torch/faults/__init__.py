"""Deterministic fault injection (see ``faults/core.py``): the catalogue.

Every fault point the port instruments is registered here, so importing
the package yields the complete registry.  The port keeps its own
registry, apart from the JAX package's: ``tests/test_torch_faults.py``
holds it to one scenario a point, and each point carries the JAX name of
its twin so the two fault matrices line up row for row.

Catalogue (point → instrumented site → recovery path):

======================== ================================== ===========================
point                    site                               recovery
======================== ================================== ===========================
store.wal.append         WriteAheadLog.append               crash + recover: replay
                         (torn: a partial record lands)     truncates the torn tail
store.commit             Store.create/create_many/update/   caller retry (remote 5xx) or
                         delete/bind_many entry             scheduler requeue-with-backoff
store.coalesce           Store._flush_pending_locked        that window degrades to
                         (the coalescing window's flush)    per-event delivery
remote.request           RemoteStore request loop           retry + exponential backoff
remote.watch.stream      RemoteWatch connect/read loop      reconnect from resourceVersion;
                         (phase=frame: a packed frame)      410 → GAP → informer relist
informer.deliver         SharedInformer._apply              relist/resync reconverges cache
informer.decode          SharedInformer._apply decode       delta lost, gap marked; next
                                                            pump relists and reconverges
informer.apply_batch     SharedInformer._apply_batch        frame lost as a unit, gap
                         (column-packed watch frames)       marked; next pump relists
scheduler.bind           Scheduler._bind /                  forget + requeue with backoff;
                         Store.bind_many per item           retry lands on freed capacity
scheduler.pipeline.prep  Scheduler._pipeline_idle           contained: counted, the work
                                                            re-runs at the next wave
backend.pallas.segment   BatchBackend: the fused scan's     raises: the wave fails and the
                         launch and its finalize            scheduler requeues its drained
                                                            pods; nothing reroutes the
                                                            segment (no fallback ladder)
backend.compact          BatchBackend's frontier scan:      raises, as the kernel seam:
                         phase=seed (the prefilter),        the scheduler requeues the
                         gather (a compaction), loop (a     drained pods; nothing retries
                         loop run, first or re-entry)       the segment at full width
telemetry.ship           TelemetryShipper._ship_batch       retry + backoff, then the
                                                            shipper's local dead ring
apiserver.admit          APIServer create-path admission    client retries honoring
                         gate (429 + Retry-After)           Retry-After
======================== ================================== ===========================

The registry names every point of the JAX package's.
"""

from .core import (
    Fault,
    FaultConfigError,
    FaultInjected,
    FaultPlan,
    FaultPoint,
    FaultSpec,
    active_plan,
    hit,
    register,
    registry,
)

register("store.wal.append",
         "WAL record append — error: append fails before any byte lands; "
         "torn: a partial record hits disk and the process 'crashes'")
register("store.commit",
         "store write commit (create/create_many/update/delete/bind_many) — "
         "error: the write fails before any state mutates")
register("store.coalesce",
         "coalescing-window flush at the broadcaster seam — error: the "
         "framed flush path fails and THAT window degrades to per-event "
         "delivery of the same folded events (state preserved, packing "
         "lost, store_coalesce_fallbacks_total increments)")
register("remote.request",
         "one HTTP request attempt in RemoteStore — error: transport "
         "failure; delay: slow apiserver")
register("remote.watch.stream",
         "RemoteWatch connect/read — error: the stream breaks mid-flight; "
         "phase=frame: a column-packed frame fails to decode, the watch "
         "emits a GAP and ends (the informer relists)")
register("informer.deliver",
         "SharedInformer delta application — drop: the event never reaches "
         "cache or handlers")
register("informer.decode",
         "watch-event payload decode (lazy wrap or eager from_dict) — error: "
         "the delta is lost and the informer marks a gap")
register("informer.apply_batch",
         "column-packed watch-frame application — error: the whole frame is "
         "lost before any event applied; the informer marks a gap")
register("scheduler.bind",
         "placement commit — error/drop: one pod's bind fails (the per-pod "
         "path raises, bind_many reports a per-item error)")
register("scheduler.pipeline.prep",
         "overlapped host prep between waves — error: the prep dies mid-wave; "
         "the wave completes and the prep re-runs at the next wave")
register("backend.pallas.segment",
         "the fused scan's launch or finalize for one segment — error: the "
         "kernel fails; the port raises (no fallback ladder)")
register("backend.compact",
         "the frontier scan: phase=seed the tensorize-time prefilter, "
         "phase=gather a node-axis compaction, phase=loop a loop run (the "
         "first or a re-entry) — error: the port raises (no full-width "
         "retry)")
register("telemetry.ship",
         "one telemetry batch through the sink — error: the collector is "
         "down; retry + backoff, then the shipper's local dead ring")
register("apiserver.admit",
         "the apiserver's overload admission gate on create paths — drop: "
         "throttled with 429 + Retry-After (the fault's value is the hint "
         "in seconds)")

__all__ = [
    "Fault",
    "FaultConfigError",
    "FaultInjected",
    "FaultPlan",
    "FaultPoint",
    "FaultSpec",
    "active_plan",
    "hit",
    "register",
    "registry",
]
