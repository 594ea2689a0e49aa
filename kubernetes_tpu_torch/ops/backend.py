"""The batch scheduling backend.

``BatchBackend.schedule_batch`` is the seam a scheduler calls with its
drained FIFO batch: it reproduces the sequential-greedy decisions of the
CPU oracle (``scheduler/generic_scheduler.py``) binding for binding.

One ordered pass cuts the batch into segments that respect the tensor
budgets (signatures, affinity terms, conflict-capable disks, host ports,
pods per segment); pods with more distinct disks than a volume slot row
holds run as singleton oracle segments.  Each kernel segment is tensorized against the
state its predecessors left, carried to the device (``models/carry.py``),
scanned, and its chosen nodes committed into a copy-on-write work map.

On CUDA every kernel segment runs on the fused kernel
(``ops/fused_scan.py``); on the CPU it runs on the plain scan
(``ops/scan_ref.py``).  A kernel that fails to build or launch raises: no
segment is quietly rerouted to another path, and neither is a failure the
``backend.pallas.segment`` fault point injects at the launch or the
finalize.  The kernel takes any zone count and any host-port count.

With tracing on, each kernel segment records a ``tensorize`` and a
``dispatch`` span from the same clock reads as the stats timers; the
dispatch span carries the route (``impl``), the kernel's plan and, at the
segment's finish, the kernel's device milliseconds from the CUDA events
that ``stats["kernel_ms"]`` reads (no extra device sync).  Oracle work
records an ``oracle`` span.  Under overload rung 2 the scheduler sets
``shed_score_planes``: the interpod score weight is zeroed (feasibility
untouched) and the shed is counted.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import faults
from ..api import types as api
from ..models.carry import from_reference
from ..models.snapshot import (
    HostBatchState,
    Tensorizer,
    count_affinity_terms,
    pod_disk_vols,
    pod_signature_key,
)
from ..scheduler.generic_scheduler import FitError, GenericScheduler
from ..scheduler.nodeinfo import NodeInfo
from ..scheduler.predicates import DEFAULT_PREDICATES
from ..scheduler.priorities import (
    BalancedResourceAllocation,
    EqualPriority,
    ImageLocalityPriority,
    InterPodAffinityPriority,
    LeastRequestedPriority,
    MostRequestedPriority,
    NodeAffinityPriority,
    NodePreferAvoidPodsPriority,
    PriorityContext,
    SelectorSpreadPriority,
    TaintTolerationPriority,
)
from ..scheduler.units import CPU_MILLI, MEM_MIB, ResourceVec
from ..utils import tracing
from . import fused_scan, scan_ref

# The oracle priorities the scan reproduces bit for bit; a configured
# priority outside this table sends the whole batch to the oracle.
_PRIORITY_WEIGHT_KEY = {
    LeastRequestedPriority: "least",
    MostRequestedPriority: "most",
    BalancedResourceAllocation: "balanced",
    SelectorSpreadPriority: "spread",
    NodeAffinityPriority: "node_affinity",
    TaintTolerationPriority: "taint",
    InterPodAffinityPriority: "interpod",
    NodePreferAvoidPodsPriority: "prefer_avoid",
    ImageLocalityPriority: "image",
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device, named or by default, raises
    at once when there is no card, not at the first launch.  The CPU is
    used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the batch backend runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev


def _segment_vecs(static):
    """Per-signature ResourceVecs for the commit path: the request vector
    and its nonzero variant (cpu/mem replaced by the defaulted values)."""
    req_vecs, nz_vecs = [], []
    for g in range(len(static.g_request)):
        units = [int(x) for x in static.g_request[g]]
        req_vecs.append(ResourceVec(units))
        nz_units = list(units)
        nz_units[CPU_MILLI] = int(static.g_nonzero[g][0])
        nz_units[MEM_MIB] = int(static.g_nonzero[g][1])
        nz_vecs.append(ResourceVec(nz_units))
    return req_vecs, nz_vecs


class BatchBackend:
    def __init__(
        self,
        algorithm: Optional[GenericScheduler] = None,
        tensorizer: Optional[Tensorizer] = None,
        device=None,
        # a power of two so full segments share one scan length
        max_segment_pods: int = 65536,
    ):
        self.device = resolve_device(device)
        self.algorithm = algorithm or GenericScheduler()
        self.tensorizer = tensorizer or Tensorizer()
        self.max_segment_pods = max_segment_pods
        # selector-match corpus and disk locations, kept across batches and
        # reconciled against each batch's snapshot by node generation
        self._host_state: Optional[HostBatchState] = None
        # overload rung 2: zero the interpod score weight (the scheduler
        # sets it a wave); the sheds count into shed_counter when wired
        self.shed_score_planes = False
        self.shed_counter = None
        # pods scheduled on the host oracle, into the scheduler's metrics
        # when wired
        self.oracle_counter = None
        # the last kernel segment's route and plan (and, once finished, its
        # kernel_ms): the dispatch span's attributes
        self.dispatch_attrs: dict = {}
        self.stats = {"kernel_pods": 0, "oracle_pods": 0, "segments": 0,
                      # batches whose interpod score plane was shed
                      "score_plane_sheds": 0,
                      # host seconds (cumulative): tensorize, pack + launch,
                      # wait for the device's result
                      "tensorize_s": 0.0, "dispatch_s": 0.0, "device_wait_s": 0.0,
                      # fused-kernel device time by CUDA events (CUDA only)
                      "kernel_ms": 0.0}

    # -- greedy segmentation ------------------------------------------------
    def _segments(
        self, pods: list[api.Pod], mounted_disks: Optional[set] = None
    ) -> list[tuple[str, list[tuple[int, api.Pod]]]]:
        """Split the ordered batch into kernel segments that respect the
        tensor budgets, walking pod order once — every cut preserves
        sequential-greedy parity because each segment re-tensorizes against
        the state its predecessors left.  Pods with more distinct disks than
        ``vols_per_pod`` become singleton oracle segments.  The volume
        budget counts conflict-capable disks only (shared within the
        segment or already mounted).  The host-port budget keeps the
        segment's port vocabulary, bucketed as the tensorizer buckets it,
        within the signature row's shared port slot, ``MAX_PORTS`` (on the
        CPU too, so both devices cut alike).  A pod whose signature alone
        has more ports than that is a kernel segment of its own, and the
        tensorizer's sticky port bucket does not keep its width (see
        ``schedule_batch``).  Each segment is (kind, [(index, pod)]), kind
        ``"kernel"`` or ``"oracle"``."""
        tz = self.tensorizer
        max_ports = fused_scan.MAX_PORTS // tz.port_multiple * tz.port_multiple
        mounted = mounted_disks if mounted_disks is not None else set()
        out: list = []
        cur: list[tuple[int, api.Pod]] = []
        sigs: set = set()
        vols_once: set = set()
        vols_conflict: set = set()
        ports: set = set()
        n_terms = 0

        def flush() -> None:
            nonlocal cur, sigs, vols_once, vols_conflict, ports, n_terms
            if cur:
                out.append(("kernel", cur))
            cur, sigs, vols_once, vols_conflict, ports, n_terms = [], set(), set(), set(), set(), 0

        for i, pod in enumerate(pods):
            pv = pod_disk_vols(pod)
            key = pod_signature_key(pod)
            # a signature's host ports are part of its key: count them once
            hp = set(pod.host_ports()) if key not in sigs else set()
            if len(pv) > tz.vols_per_pod:
                flush()
                out.append(("oracle", [(i, pod)]))
                continue
            pv_conflict = {d for d in pv if d in mounted or d in vols_once}
            t_new = count_affinity_terms(pod) if key not in sigs else 0
            if cur and (
                len(cur) >= self.max_segment_pods
                or (key not in sigs and len(sigs) >= tz.max_groups)
                or n_terms + t_new > tz.max_terms
                or len(vols_conflict | pv_conflict) > tz.max_vols
                or len(ports | hp) > max_ports
            ):
                flush()
                t_new = count_affinity_terms(pod)
                hp = set(pod.host_ports())
                pv_conflict = {d for d in pv if d in mounted}
            sigs.add(key)
            n_terms += t_new
            ports |= hp
            vols_conflict |= pv_conflict
            vols_once |= pv
            cur.append((i, pod))
        flush()
        return out

    # -- config support check ---------------------------------------------
    def _kernel_weights(self) -> Optional[dict]:
        """Map the oracle's priority config onto scan weights; None if any
        configured priority has no scan implementation."""
        weights = {k: 0 for k in set(_PRIORITY_WEIGHT_KEY.values())}
        for prio, weight in self.algorithm.priorities:
            if isinstance(prio, EqualPriority):
                continue  # constant shift; never changes argmax or ties
            key = _PRIORITY_WEIGHT_KEY.get(type(prio))
            if key is None:
                return None
            weights[key] += weight
        if self.shed_score_planes and weights["interpod"]:
            # overload rung 2: the interpod score plane changes which
            # feasible node wins, never whether a pod fits; counted so the
            # degradation is stated
            weights["interpod"] = 0
            self.stats["score_plane_sheds"] += 1
            if self.shed_counter is not None:
                self.shed_counter.inc()
        return weights

    def _config_supported(self) -> Optional[dict]:
        if self.algorithm.extenders:
            return None
        if set(self.algorithm.predicates.keys()) != set(DEFAULT_PREDICATES.keys()):
            return None
        return self._kernel_weights()

    # -- device dispatch -----------------------------------------------------
    def _dispatch(self, static, init):
        """Carry one tensorized segment to the device and start its scan.
        Returns (finisher, device_busy): the zero-argument finisher gives
        (chosen, final rr); ``device_busy`` polls, without synchronizing,
        whether the launched scan is still running (None on the CPU, where
        the scan has already run).  ``self.dispatch_attrs`` is this
        segment's route and plan; the finisher adds the kernel's device
        milliseconds (the dispatch span's attributes)."""
        scan_static, scan_state = from_reference(vars(static), vars(init), self.device)
        impl = "cuda" if self.device.type == "cuda" else "cpu"
        self.dispatch_attrs = span_attrs = {"impl": impl}
        # the kernel's seam: an injected failure raises like a real one
        faults.hit("backend.pallas.segment", impl=impl, phase="launch")
        if self.device.type != "cuda":
            chosen, rr = scan_ref.scan(scan_static, scan_state)

            def finish_cpu():
                faults.hit("backend.pallas.segment", impl=impl, phase="finalize")
                return chosen.numpy(), rr
            return finish_cpu, None
        pl = fused_scan.plan(scan_static)
        bufs = fused_scan.pack(scan_static, scan_state, pl)
        fused_scan.load()  # a first call builds: keep that out of kernel_ms
        span_attrs.update(cluster=pl.cs, threads=pl.threads, zones_at=pl.zones_at)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_scan.launch(scan_static, scan_state, bufs, pl)
        end.record()

        def finish():
            out = fused_scan.finalize(scan_static, bufs)
            faults.hit("backend.pallas.segment", impl=impl, phase="finalize")
            # finalize synchronized on the result: the events are complete
            span_attrs["kernel_ms"] = ms = start.elapsed_time(end)
            self.stats["kernel_ms"] += ms
            return out
        return finish, (lambda: not end.query())

    # -- the batch entry point ---------------------------------------------
    def schedule_batch(
        self,
        pods: list[api.Pod],
        node_info_map: dict[str, NodeInfo],
        pctx: PriorityContext,
        on_segment=None,
        on_idle=None,
    ) -> list[Optional[str]]:
        """Schedule ``pods`` in order against ``node_info_map``; returns the
        chosen node name per pod (None = unschedulable).  The map is not
        mutated: placements land in clones made on first write.

        ``on_segment`` (optional) is called with ``[(pod, node_name|None,
        req_vec|None, nz_vec|None), ...]`` per completed segment, after the
        next segment's scan has been launched, so the caller's commit work
        overlaps device time.  Entry order across calls equals pod order.

        ``on_idle`` (optional) is called once as ``on_idle(device_busy=fn)``
        after the batch's final kernel segment was launched and every
        earlier segment handed to ``on_segment``: the point where the host
        would otherwise block in the finisher while the card still scans.
        ``fn`` polls the launch's end event without synchronizing (None on
        the CPU).  The callback must not mutate ``node_info_map``."""
        weights = self._config_supported()
        work_map = dict(node_info_map)
        cloned: set[str] = set()

        def mutable_info(node_name: str):
            info = work_map.get(node_name)
            if info is None or node_name in cloned:
                return info
            info = info.clone()
            work_map[node_name] = info
            cloned.add(node_name)
            return info

        work_pctx = PriorityContext(
            work_map,
            services=pctx.services,
            replicasets=pctx.replicasets,
            hard_pod_affinity_weight=pctx.hard_pod_affinity_weight,
            pvcs=pctx.pvcs,
            pvs=pctx.pvs,
        )
        assignments: list[Optional[str]] = [None] * len(pods)

        host_state = None
        if weights is not None:
            if self._host_state is None:
                self._host_state = HostBatchState(work_map)
            else:
                self._host_state.reconcile(work_map)
            host_state = self._host_state
        mounted_disks = host_state.mounted_disks if host_state is not None else set()

        def apply(pod: api.Pod, node_name: Optional[str], i: int,
                  req_vec=None, nz_vec=None) -> None:
            assignments[i] = node_name
            if node_name is None:
                return
            info = mutable_info(node_name)
            if info is not None:
                if req_vec is not None:
                    info.add_pod_counted(pod, req_vec, nz_vec)
                else:
                    info.add_pod(pod)
            if host_state is not None:
                host_state.add_pod(pod, node_name)

        def run_oracle(pod: api.Pod, i: int) -> None:
            try:
                res = self.algorithm.schedule(pod, work_map, work_pctx)
                apply(pod, res.node_name, i)
            except FitError:
                apply(pod, None, i)
            self.stats["oracle_pods"] += 1
            if self.oracle_counter is not None:
                self.oracle_counter.inc()

        def run_oracle_pods(segment: list[tuple[int, api.Pod]]) -> None:
            t0 = time.perf_counter()
            for i, pod in segment:
                run_oracle(pod, i)
            tr = tracing.current()
            if tr is not None:
                tr.complete("oracle", t0, time.perf_counter(), cat="phase", pods=len(segment))

        def dispatch_kernel_segment(segment: list[tuple[int, api.Pod]]):
            """Tensorize + launch; returns (finisher, device_busy) where the
            finisher waits, applies and returns the segment's commit
            entries, or (None, None) when the tensorizer rejects the
            segment (budget)."""
            seg_pods = [p for _, p in segment]
            tr = tracing.current()
            tz = self.tensorizer
            sticky_ports = tz._sticky.get("ports")
            t0 = time.perf_counter()
            static = self.tensorizer.build_static(
                seg_pods, work_map, work_pctx,
                least_requested_weight=weights["least"],
                most_requested_weight=weights["most"],
                balanced_weight=weights["balanced"],
                spread_weight=weights["spread"],
                node_affinity_weight=weights["node_affinity"],
                taint_weight=weights["taint"],
                prefer_avoid_weight=weights["prefer_avoid"],
                image_weight=weights["image"],
                interpod_weight=weights["interpod"],
                mounted_disks=mounted_disks,
            )
            if static is not None and static.g_ports.shape[1] > max_ports:
                # a wide pod's own segment: the segments after it keep the
                # port width they had
                if sticky_ports is None:
                    tz._sticky.pop("ports", None)
                else:
                    tz._sticky["ports"] = sticky_ports
            if static is None:
                t1 = time.perf_counter()
                self.stats["tensorize_s"] += t1 - t0
                if tr is not None:
                    tr.complete("tensorize", t0, t1, cat="phase", pods=len(seg_pods),
                                rejected=True)
                return None, None
            init = self.tensorizer.initial_state(
                static, work_map, work_pctx, seg_pods,
                round_robin=self.algorithm._round_robin, host_state=host_state)
            t1 = time.perf_counter()
            self.stats["tensorize_s"] += t1 - t0
            if tr is not None:
                # the same clock reads as the stats timer
                tr.complete("tensorize", t0, t1, cat="phase", pods=len(seg_pods),
                            groups=len(static.g_request), n_pad=int(static.n_pad))
            self.dispatch_attrs = {}
            wait, device_busy = self._dispatch(static, init)
            span_attrs = self.dispatch_attrs
            t2 = time.perf_counter()
            self.stats["dispatch_s"] += t2 - t1
            if tr is not None:
                dispatch_span = tr.complete("dispatch", t1, t2, cat="phase", **span_attrs)

            def finish() -> list:
                t3 = time.perf_counter()
                chosen, final_rr = wait()
                t4 = time.perf_counter()
                self.stats["device_wait_s"] += t4 - t3
                if tr is not None:
                    tr.complete("device_wait", t3, t4, cat="phase", pods=len(segment))
                    if "kernel_ms" in span_attrs:
                        dispatch_span.set(kernel_ms=span_attrs["kernel_ms"])
                self.algorithm._round_robin = final_rr
                req_vecs, nz_vecs = _segment_vecs(static)
                entries = []
                for k, ((i, pod), idx) in enumerate(zip(segment, chosen)):
                    node_name = static.node_names[int(idx)] if int(idx) >= 0 else None
                    g = int(static.group_of_pod[k])
                    apply(pod, node_name, i, req_vecs[g], nz_vecs[g])
                    entries.append((pod, node_name, req_vecs[g], nz_vecs[g]))
                self.stats["kernel_pods"] += len(segment)
                self.stats["segments"] += 1
                return entries
            return finish, device_busy

        def run_kernel_segment(segment: list[tuple[int, api.Pod]]) -> None:
            """Sync path with a binary split on a budget reject: each half
            re-tensorizes against the updated state, so parity holds."""
            finish, _ = dispatch_kernel_segment(segment)
            if finish is not None:
                finish()
            elif len(segment) == 1:
                run_oracle(segment[0][1], segment[0][0])
            else:
                mid = len(segment) // 2
                run_kernel_segment(segment[:mid])
                run_kernel_segment(segment[mid:])

        if weights is None:
            run_oracle_pods(list(enumerate(pods)))
            if on_segment is not None and pods:
                on_segment([(pod, assignments[i], None, None)
                            for i, pod in enumerate(pods)])
            return assignments
        max_ports = fused_scan.MAX_PORTS // self.tensorizer.port_multiple \
            * self.tensorizer.port_multiple

        pending: list = []  # prior segments' entries awaiting the caller

        def flush_pending() -> None:
            nonlocal pending
            if on_segment is not None and pending:
                on_segment(pending)
            pending = []

        try:
            segments = self._segments(pods, mounted_disks=mounted_disks)
            for si, (kind, segment) in enumerate(segments):
                if kind == "oracle":
                    run_oracle_pods(segment)
                    pending.extend((pod, assignments[i], None, None) for i, pod in segment)
                    continue
                finish, device_busy = dispatch_kernel_segment(segment)
                if finish is None:
                    flush_pending()
                    run_kernel_segment(segment)
                    pending.extend((pod, assignments[i], None, None) for i, pod in segment)
                    continue
                # the device is scanning this segment: hand earlier entries
                # to the caller in its shadow
                flush_pending()
                if on_idle is not None and si == len(segments) - 1:
                    # the final segment is in flight and nothing is left to
                    # commit: the card's shadow goes to the caller's prep
                    on_idle(device_busy=device_busy)
                pending = finish()
            flush_pending()
        except BaseException:
            # an aborted batch leaves speculative placements in the host
            # state that no cache generation accounts for: close it and
            # drop it so the next batch rebuilds from its snapshot
            if self._host_state is not None:
                self._host_state.close()
                self._host_state = None
            raise
        return assignments
