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

The route is the JAX package's on a GPU (its rung 1, ``_dispatch_frontier``):
the frontier scan is on by default.  The tensorize-time prefilter
(``models.snapshot.frontier_seed``) drops the node columns no signature can
take, when that halves the axis; a segment longer than one chunk then runs
the device-resident loop (``ops/frontier.py``: the fused scan a chunk at a
time, the ``frontier_refresh`` kernel after each, node-axis compaction when
the alive columns fall under ``frontier_compact_frac`` of the width), or,
with ``frontier_device_loop=False`` or a ``frontier_chunk`` that is not a
power of two, the chunked host loop (the same kernels, a host read of the
alive count between chunks; ``last_frontier`` mode ``"chunked"``), and
any other segment one full launch (of the prefiltered axis, if the prefilter
cut it).  Every route takes the four node-axis statics from a
``DeviceNodeCache`` kept across segments and waves (a prefiltered axis
bypasses it).  A frontier failure, real or injected at ``backend.compact``
(phases ``seed``, ``gather``, ``loop``), raises like a kernel failure:
nothing retries the segment at full width.  With ``frontier_mesh=True`` the
loop runs with the node axis split into shards (``parallel/mesh.py``, the
mesh kernel ``ops/csrc/mesh_scan.cu`` on a card); its segment's entry in
``last_frontier`` has ``mode`` ``"mesh"``, ``n_shards`` and the per-shard
alive fractions.

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

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import faults
from ..api import types as api
from ..models.carry import from_reference
from ..models.snapshot import (
    HostBatchState,
    Tensorizer,
    compact_segment,
    count_affinity_terms,
    frontier_seed,
    pad_segment_to_multiple,
    pod_disk_vols,
    pod_signature_key,
)
from ..parallel.mesh import make_mesh, mesh_dispatch_span
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
from .frontier import FrontierRun, _pow2_width
from .node_cache import DeviceNodeCache

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
        # the frontier scan, with the JAX constructor's defaults: prefilter
        # dead columns at tensorize time, run segments longer than
        # frontier_chunk as the device-resident chunk loop, compact the node
        # axis to a power of two >= frontier_min_width when the alive
        # columns fall to frontier_compact_frac of the width; the loop
        # engages while the prefilter's alive fraction is at most
        # frontier_engage_frac.  The device loop runs when
        # frontier_device_loop is set and frontier_chunk is a power of two;
        # otherwise the chunked host loop does (a host read a chunk, the
        # same kernels), and the mesh is the device loop's only.
        frontier: bool = True,
        frontier_chunk: int = 512,
        frontier_compact_frac: float = 0.5,
        frontier_min_width: int = 128,
        frontier_device_loop: bool = True,
        frontier_engage_frac: float = 1.0,
        # the node-axis mesh (parallel/mesh.py): True runs the frontier loop
        # with the node axis split into shards (the mesh kernel on a card,
        # the plain sharded step on the CPU); "auto", the JAX default, stays
        # off until shards on several cards exist (the port's shards share
        # the backend's device); False is off.  The shard count is the
        # largest power of two <= mesh_devices (None: the device count of
        # the backend's kind).  Fewer than 2 shards raise here, and a mesh
        # launch that fails raises out of the segment: nothing degrades to
        # the single-device loop.
        frontier_mesh="auto",
        mesh_devices: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.algorithm = algorithm or GenericScheduler()
        self.tensorizer = tensorizer or Tensorizer()
        self.max_segment_pods = max_segment_pods
        if frontier_chunk <= 0:
            raise ValueError("frontier_chunk must be positive")
        self.frontier = frontier
        self.frontier_chunk = frontier_chunk
        self.frontier_compact_frac = frontier_compact_frac
        self.frontier_min_width = frontier_min_width
        self.frontier_device_loop = frontier_device_loop
        self.frontier_engage_frac = frontier_engage_frac
        # the JAX backend's choice: the device loop takes a power-of-two chunk
        self._device_loop = bool(frontier_device_loop) and not frontier_chunk & (frontier_chunk - 1)
        # node-axis statics on the device, reused across segments and waves
        self.device_node_cache = DeviceNodeCache(self.device)
        self.frontier_mesh = frontier_mesh
        self.mesh_devices = mesh_devices
        self._mesh = self._frontier_mesh() if self._mesh_enabled() else None
        self.device_node_cache.set_mesh(self._mesh)
        # compactions into the scheduler's metrics when wired
        self.frontier_counter = None
        # this batch's frontier trajectory, one entry a frontier segment
        self.last_frontier: list = []
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
                      # fused-kernel (and frontier refresh) device time by
                      # CUDA events (CUDA only)
                      "kernel_ms": 0.0,
                      # the frontier: segments it served, compactions,
                      # columns the prefilter dropped
                      "frontier_segments": 0, "frontier_compactions": 0,
                      "frontier_prefilter_cols": 0,
                      # blocking device-to-host reads on the finish path
                      "host_syncs": 0,
                      # the cross-batch host state: built from a snapshot,
                      # or reconciled against the next batch's
                      "host_state_rebuilds": 0, "host_state_reconciles": 0}

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
        # kernel: implements LeastRequestedPriority, MostRequestedPriority
        # kernel: implements BalancedResourceAllocation, SelectorSpreadPriority
        # kernel: implements NodeAffinityPriority, TaintTolerationPriority
        # kernel: implements InterPodAffinityPriority, NodePreferAvoidPodsPriority
        # kernel: implements ImageLocalityPriority
        weights = {k: 0 for k in set(_PRIORITY_WEIGHT_KEY.values())}
        for prio, weight in self.algorithm.priorities:
            if isinstance(prio, EqualPriority):
                # kernel: implements EqualPriority
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

    # -- the node-axis mesh ---------------------------------------------------
    def _mesh_enabled(self) -> bool:
        # "auto" engages the JAX package's mesh on a multi-device TPU; the
        # port's shards would share one card, so it stays off.  The mesh is
        # the device loop's: the chunked host loop runs unsharded
        return self.frontier_mesh != "auto" and bool(self.frontier_mesh) and self._device_loop

    def _frontier_mesh(self):
        """The node-axis mesh: the largest power-of-two shard count <=
        mesh_devices, every shard on the backend's device.  Raises with
        fewer than 2."""
        n = (torch.cuda.device_count() if self.device.type == "cuda" else 1) \
            if self.mesh_devices is None else int(self.mesh_devices)
        p = 1
        while p * 2 <= n:
            p *= 2
        if p < 2:
            raise ValueError(f"the sharded loop needs >= 2 shards, mesh_devices gives {n}")
        return make_mesh(p, devices=[self.device] * p)

    # -- the frontier's seams ----------------------------------------------
    def _on_frontier_compact(self, width: int, width_new: int, n_alive: int) -> None:
        # fault seam before the gather: an injected failure raises out of
        # the segment like a kernel failure
        faults.hit("backend.compact", phase="gather", width=width, new_width=width_new)
        self.stats["frontier_compactions"] += 1
        if self.frontier_counter is not None:
            self.frontier_counter.inc()
        tr = tracing.current()
        if tr is not None:
            tr.instant("frontier.compact", width=width, new_width=width_new, alive=n_alive)

    def _on_frontier_loop(self, run_index: int, width: int, start_chunk: int) -> None:
        # fault seam before every loop run (the first and each re-entry
        # after a compaction)
        faults.hit("backend.compact", phase="loop", run=run_index, width=width,
                   start_chunk=start_chunk)
        tr = tracing.current()
        if tr is not None:
            tr.instant("frontier.loop_enter", run=run_index, width=width, start_chunk=start_chunk)

    def _frontier_plan(self, static, init):
        """The JAX package's rung-1 route for one segment: seed the monotone
        step-0 plane (``init.still_ok``), compact the node axis at
        tensorize time when enough columns are already dead, and decide
        whether the chunked loop engages.  Returns (the segment to scan,
        its initial state, the kept columns of ``static``'s axis or None,
        chunked?)."""
        faults.hit("backend.compact", phase="seed")
        alive = frontier_seed(static, init)
        n_alive = int(alive.sum())
        width = _pow2_width(n_alive, self.frontier_min_width)
        kept = None
        if width < static.n_pad and n_alive <= self.frontier_compact_frac * static.n_pad:
            kept = np.nonzero(alive)[0]
            static, init = compact_segment(static, init, kept, width)
        # the loop engages when the segment is longer than a chunk and its
        # axis wider than the floor; a mostly-alive fleet chunks too
        # (frontier_engage_frac 1.0)
        chunked = (len(static.group_of_pod) > self.frontier_chunk
                   and static.n_pad > self.frontier_min_width
                   and n_alive <= self.frontier_engage_frac * len(alive))
        return static, init, kept, chunked

    # -- device dispatch -----------------------------------------------------
    def _dispatch(self, static, init):
        """Carry one tensorized segment to the device and start its scan on
        its route.  Returns (finisher, device_busy): the zero-argument
        finisher gives (chosen index per pod in ``static``'s axis, final
        rr); ``device_busy`` polls, without synchronizing, whether the
        launched work is still running (None on the CPU, where it has
        already run).  ``self.dispatch_attrs`` is this segment's route and
        plan; the finisher adds the kernels' device milliseconds (the
        dispatch span's attributes)."""
        impl = "cuda" if self.device.type == "cuda" else "cpu"
        self.dispatch_attrs = span_attrs = {"impl": impl}
        # the kernel's seam: an injected failure raises like a real one
        faults.hit("backend.pallas.segment", impl=impl, phase="launch")
        cstatic, cinit, kept, chunked = static, init, None, False
        if self.frontier:
            cstatic, cinit, kept, chunked = self._frontier_plan(static, init)
        entry = None
        if chunked or kept is not None:
            if kept is not None:
                self.stats["frontier_prefilter_cols"] += static.n_pad - cstatic.n_pad
            entry = {"prefilter": [int(static.n_pad), int(cstatic.n_pad)]}
            span_attrs["frontier"] = "loop" if chunked else "prefilter"
        if not chunked:
            # one launch over the whole segment: the frontier plane stays home
            cinit = dataclasses.replace(cinit, still_ok=None)
        mesh = self._mesh if chunked else None
        if mesh is not None:
            # every shard owns an equal slice: pad with dead columns (the
            # real columns keep their indices)
            cstatic, cinit = pad_segment_to_multiple(cstatic, cinit, mesh.size)
            entry["prefilter"][1] = int(cstatic.n_pad)
            span_attrs["frontier"] = "mesh"
        scan_static, scan_state = from_reference(
            vars(cstatic), vars(cinit), self.device,
            node_arrays=self.device_node_cache.node_arrays(cstatic))
        if mesh is None:
            # the fused scan's pods a loop iteration (PallasSuperSteps): on
            # the card the library its launches run; the plain scan on the
            # CPU is the same function at every K
            self.stats["superstep_k"] = fused_scan.superstep_k()
        if chunked:
            with (mesh_dispatch_span(mesh, cstatic.n_pad) if mesh is not None
                  else tracing.NULL_SPAN):
                run = FrontierRun(scan_static, scan_state, chunk_len=self.frontier_chunk,
                                  compact_frac=self.frontier_compact_frac,
                                  min_width=self.frontier_min_width,
                                  on_compact=self._on_frontier_compact,
                                  on_loop=self._on_frontier_loop, mesh=mesh,
                                  device_loop=self._device_loop)
            busy = run.device_busy
            self.stats["frontier_segments"] += 1

            def wait():
                chosen, rr = run.finalize()
                self.stats["host_syncs"] += run.stats["host_syncs"]
                entry.update(widths=run.stats["widths"], alive_frac=run.stats["alive_frac"],
                             chunks=run.stats["chunks"], compactions=run.stats["compactions"],
                             mode="mesh" if mesh is not None else "loop"
                             if self._device_loop else "chunked",
                             host_syncs=run.stats["host_syncs"])
                if mesh is not None:
                    entry.update(n_shards=run.stats["n_shards"],
                                 shard_alive_frac=run.stats["shard_alive_frac"])
                self.last_frontier.append(entry)
                if impl == "cuda":
                    span_attrs.update(launches=run.launches,
                                      refresh_launches=run.refresh_launches)
                return chosen, rr, run.kernel_ms if impl == "cuda" else None
        else:
            wait, busy = self._launch_full(scan_static, scan_state, span_attrs)
            if entry is not None:
                self.stats["frontier_segments"] += 1
                entry.update(widths=[int(cstatic.n_pad)], alive_frac=[], chunks=1,
                             compactions=0, mode="plain", host_syncs=1)
                self.last_frontier.append(entry)

        def finish():
            chosen, rr, ms = wait()
            faults.hit("backend.pallas.segment", impl=impl, phase="finalize")
            if ms is not None:
                span_attrs["kernel_ms"] = ms
                self.stats["kernel_ms"] += ms
            if kept is not None:
                # the prefiltered axis back to the segment's (kept may be
                # empty: a pool already full at the segment's start)
                mapped = np.full(len(chosen), -1, dtype=np.int64)
                hit = chosen >= 0
                mapped[hit] = kept[chosen[hit]]
                chosen = mapped
            return chosen, rr
        return finish, busy

    def _launch_full(self, scan_static, scan_state, span_attrs: dict):
        """One launch of the fused scan over the whole segment (the plain
        scan on the CPU).  Returns (wait, device_busy); ``wait`` gives
        (chosen, rr, kernel ms or None)."""
        if self.device.type != "cuda":
            chosen, rr = scan_ref.scan(scan_static, scan_state)

            def wait_cpu():
                self.stats["host_syncs"] += 1
                return chosen.numpy(), rr, None
            return wait_cpu, None
        pl = fused_scan.plan(scan_static)
        bufs = fused_scan.pack(scan_static, scan_state, pl)
        fused_scan.load()  # a first call builds: keep that out of kernel_ms
        span_attrs.update(cluster=pl.cs, threads=pl.threads, zones_at=pl.zones_at, launches=1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_scan.launch(scan_static, scan_state, bufs, pl)
        end.record()

        def wait():
            chosen, rr = fused_scan.finalize(scan_static, bufs)
            self.stats["host_syncs"] += 1
            # finalize synchronized on the result: the events are complete
            return chosen, rr, start.elapsed_time(end)
        return wait, (lambda: not end.query())

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
        self.last_frontier = []  # this batch's frontier trajectory
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
                self.stats["host_state_rebuilds"] += 1
            else:
                self._host_state.reconcile(work_map)
                self.stats["host_state_reconciles"] += 1
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
                    # what the finish learned: the device time and, on the
                    # frontier route, the launches its loop runs made
                    dispatch_span.set(**{k: span_attrs[k] for k in
                                         ("kernel_ms", "launches", "refresh_launches")
                                         if k in span_attrs})
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
