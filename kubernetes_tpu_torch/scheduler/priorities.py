"""Oracle scoring priorities — the fixed-point scoring spec.

Capability of the reference's default priority set
(``plugin/pkg/scheduler/algorithm/priorities/``; registration
``algorithmprovider/defaults/defaults.go:188-228``).  Scores are integers
0..10 per priority per node (``schedulerapi.MaxPriority``), combined by
integer weighted sum (``core/generic_scheduler.go:374-379``).

Where the reference computes intermediate *fractions* in float64 and
truncates (``int(fScore)``), this framework's spec replaces the float math
with 10-bit fixed point (``x*1024//y``) or direct integer division — chosen
so that for non-negative operands the result equals ``floor`` of the real
value, exactly what Go's ``int()`` truncation produces.  All intermediates
fit int32 at the 5k-node/150k-pod design scale, so the device scan
(``ops/scan_ref.py``, ``ops/csrc/fused_scan.cu``) reproduces these numbers
bit-for-bit.

Each priority exposes ``compute_all(pod, infos, ctx) -> list[int]``
(scores aligned with ``infos``) — the whole-node-axis shape that both the
oracle and the vectorized kernels share.
"""

from __future__ import annotations

from typing import Optional

from ..api import types as api
from ..api.selectors import matches_simple_selector
from .nodeinfo import NodeInfo
from .units import (
    CPU_MILLI,
    FIXED_POINT_ONE,
    MAX_PRIORITY,
    MEM_MIB,
    pod_nonzero_request_vec,
)
from .predicates import _pod_matches_term

PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"
DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1

# ImageLocality bounds, canonical MiB (reference image_locality.go:
# minImgSize 23MB, maxImgSize 1000MB).
_MIN_IMG_MIB = 23
_MAX_IMG_MIB = 1000


class PriorityContext:
    """Cluster-wide lookups for priorities: grouping objects for spread and
    the node-info map for topology."""

    def __init__(
        self,
        node_info_map: dict[str, NodeInfo],
        services: Optional[list[api.Service]] = None,
        replicasets: Optional[list[api.ReplicaSet]] = None,
        hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
        pvcs: Optional[dict[str, object]] = None,
        pvs: Optional[dict[str, object]] = None,
    ):
        self.node_info_map = node_info_map
        self.services = services or []
        self.replicasets = replicasets or []
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        # volume listers consumed by the predicate context ("ns/name" -> PVC,
        # name -> PV); carried here so one context object reaches both the
        # scoring and (via GenericScheduler.schedule) the filtering phase
        self.pvcs = pvcs or {}
        self.pvs = pvs or {}


# one zone-key implementation for oracle AND tensorizer (bit-parity):
from .nodeinfo import _zone_key_of as _zone_key_of_node


def _zone_key(node: Optional[api.Node]) -> str:
    """reference ``utilnode.GetZoneKey``; scoring loops read the cached
    ``NodeInfo.zone_key`` (same function) instead."""
    return _zone_key_of_node(node)


# ---------------------------------------------------------------------------
# Resource-shape priorities (least/most requested, balanced)
# ---------------------------------------------------------------------------


def _least_requested_score(requested: int, capacity: int) -> int:
    """reference least_requested.go:65 calculateUnusedScore."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * MAX_PRIORITY) // capacity


def _most_requested_score(requested: int, capacity: int) -> int:
    """reference most_requested.go:41 calculateUsedScore."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return (requested * MAX_PRIORITY) // capacity


class LeastRequestedPriority:
    """(capacity-requested)*10/capacity averaged over cpu+mem, on NONZERO
    requests (least_requested.go:33)."""

    name = "LeastRequestedPriority"

    def compute_all(self, pod: api.Pod, infos: list[NodeInfo], ctx: PriorityContext) -> list[int]:
        req = pod_nonzero_request_vec(pod)
        rc, rm = req.units[CPU_MILLI], req.units[MEM_MIB]
        out = []
        for info in infos:
            nz, al = info.nonzero_requested.units, info.allocatable.units
            cpu = _least_requested_score(nz[CPU_MILLI] + rc, al[CPU_MILLI])
            mem = _least_requested_score(nz[MEM_MIB] + rm, al[MEM_MIB])
            out.append((cpu + mem) // 2)
        return out


class MostRequestedPriority:
    """Bin-packing twin of LeastRequested (most_requested.go:33; the
    ClusterAutoscalerProvider default and BASELINE 'MostAllocated')."""

    name = "MostRequestedPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        req = pod_nonzero_request_vec(pod)
        rc, rm = req.units[CPU_MILLI], req.units[MEM_MIB]
        out = []
        for info in infos:
            nz, al = info.nonzero_requested.units, info.allocatable.units
            cpu = _most_requested_score(nz[CPU_MILLI] + rc, al[CPU_MILLI])
            mem = _most_requested_score(nz[MEM_MIB] + rm, al[MEM_MIB])
            out.append((cpu + mem) // 2)
        return out


class BalancedResourceAllocation:
    """10 - 10*|cpuFraction - memFraction| (balanced_resource_allocation.go),
    fractions in 10-bit fixed point."""

    name = "BalancedResourceAllocation"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        req = pod_nonzero_request_vec(pod)
        rc, rm = req.units[CPU_MILLI], req.units[MEM_MIB]
        out = []
        for info in infos:
            nz, al = info.nonzero_requested.units, info.allocatable.units
            cpu_req = nz[CPU_MILLI] + rc
            mem_req = nz[MEM_MIB] + rm
            cpu_cap = al[CPU_MILLI]
            mem_cap = al[MEM_MIB]
            if cpu_cap == 0 or mem_cap == 0 or cpu_req >= cpu_cap or mem_req >= mem_cap:
                out.append(0)
                continue
            f_cpu = (cpu_req * FIXED_POINT_ONE) // cpu_cap
            f_mem = (mem_req * FIXED_POINT_ONE) // mem_cap
            diff = abs(f_cpu - f_mem)
            out.append((MAX_PRIORITY * FIXED_POINT_ONE - diff * MAX_PRIORITY) // FIXED_POINT_ONE)
        return out


# ---------------------------------------------------------------------------
# Spreading
# ---------------------------------------------------------------------------


class SelectorSpreadPriority:
    """Spread pods of the same service/replicaset across nodes and zones
    (selector_spreading.go:98; zoneWeighting=2/3 at :35 becomes the exact
    (node + 2*zone)/3 fixed-point blend here)."""

    name = "SelectorSpreadPriority"

    def _selectors_for_pod(self, pod: api.Pod, ctx: PriorityContext):
        sels = []
        for svc in ctx.services:
            if svc.meta.namespace == pod.meta.namespace and svc.selector:
                if matches_simple_selector(svc.selector, pod.meta.labels):
                    sels.append(("simple", svc.selector))
        for rs in ctx.replicasets:
            if rs.meta.namespace == pod.meta.namespace and not rs.selector.is_empty():
                if rs.selector.matches(pod.meta.labels):
                    sels.append(("label", rs.selector))
        return sels

    def _matches_any(self, sels, q: api.Pod) -> bool:
        for kind, sel in sels:
            if kind == "simple":
                if matches_simple_selector(sel, q.meta.labels):
                    return True
            else:
                if sel.matches(q.meta.labels):
                    return True
        return False

    def compute_all(self, pod, infos, ctx) -> list[int]:
        sels = self._selectors_for_pod(pod, ctx)
        counts = []
        zone_counts: dict[str, int] = {}
        for info in infos:
            cnt = 0
            if sels:
                for q in info.pods:
                    if q.meta.namespace == pod.meta.namespace and self._matches_any(sels, q):
                        cnt += 1
            counts.append(cnt)
            zk = info.zone_key
            if zk:
                zone_counts[zk] = zone_counts.get(zk, 0) + cnt
        max_n = max(counts, default=0)
        have_zones = len(zone_counts) != 0
        max_z = max(zone_counts.values(), default=0)
        out = []
        for info, cnt in zip(infos, counts):
            node_fp = (
                ((max_n - cnt) * MAX_PRIORITY * FIXED_POINT_ONE) // max_n
                if max_n > 0
                else MAX_PRIORITY * FIXED_POINT_ONE
            )
            total_fp = node_fp
            if have_zones:
                zk = info.zone_key
                if zk:
                    zone_fp = (
                        ((max_z - zone_counts[zk]) * MAX_PRIORITY * FIXED_POINT_ONE) // max_z
                        if max_z > 0
                        else MAX_PRIORITY * FIXED_POINT_ONE
                    )
                    # fScore*(1/3) + zoneScore*(2/3), exact in thirds
                    total_fp = (node_fp + 2 * zone_fp) // 3
            out.append(total_fp // FIXED_POINT_ONE)
        return out


# ---------------------------------------------------------------------------
# Node-preference priorities
# ---------------------------------------------------------------------------


class NodeAffinityPriority:
    """Sum of matching preferred node-affinity term weights, normalized
    10*count/max (node_affinity.go Map/Reduce)."""

    name = "NodeAffinityPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        aff = pod.spec.affinity
        terms = aff.node_affinity_preferred if aff else []
        counts = []
        for info in infos:
            cnt = 0
            if info.node is not None:
                for pt in terms:
                    if pt.weight > 0 and pt.preference.matches(info.node.meta.labels):
                        cnt += pt.weight
            counts.append(cnt)
        max_c = max(counts, default=0)
        if max_c == 0:
            return [0] * len(infos)
        return [(MAX_PRIORITY * c) // max_c for c in counts]


class TaintTolerationPriority:
    """Fewer intolerable PreferNoSchedule taints is better
    (taint_toleration.go; reduce is reversed-normalize)."""

    name = "TaintTolerationPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        counts = []
        for info in infos:
            cnt = 0
            if info.node is not None:
                for taint in info.node.spec.taints:
                    if taint.effect != api.PREFER_NO_SCHEDULE:
                        continue
                    if not any(t.tolerates(taint) for t in pod.spec.tolerations):
                        cnt += 1
            counts.append(cnt)
        max_c = max(counts, default=0)
        if max_c == 0:
            return [MAX_PRIORITY] * len(infos)
        return [(MAX_PRIORITY * (max_c - c)) // max_c for c in counts]


class NodePreferAvoidPodsPriority:
    """Weight-10000 veto for nodes annotated to avoid this pod's controller
    (node_prefer_avoid_pods.go).  The annotation value here is a
    comma-separated list of controller UIDs (the reference uses a JSON
    AvoidPods struct; capability is identical)."""

    name = "NodePreferAvoidPodsPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        ref = pod.meta.controller_ref()
        out = []
        for info in infos:
            if ref is None or ref.kind not in ("ReplicaSet", "ReplicationController"):
                out.append(MAX_PRIORITY)
                continue
            ann = info.node.meta.annotations.get(PREFER_AVOID_PODS_ANNOTATION, "") if info.node else ""
            avoided = ref.uid in [u.strip() for u in ann.split(",") if u.strip()]
            out.append(0 if avoided else MAX_PRIORITY)
        return out


class ImageLocalityPriority:
    """Prefer nodes that already hold the pod's images (image_locality.go),
    non-default in the reference's provider but registered."""

    name = "ImageLocalityPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        images = {c.image for c in pod.spec.containers if c.image}
        out = []
        for info in infos:
            total_mib = 0
            if info.node is not None:
                for img in info.node.status.images:
                    if any(n in images for n in img.get("names", [])):
                        total_mib += int(img.get("sizeBytes", 0)) // (2**20)
            if total_mib < _MIN_IMG_MIB:
                out.append(0)
            elif total_mib > _MAX_IMG_MIB:
                out.append(MAX_PRIORITY)
            else:
                out.append(((total_mib - _MIN_IMG_MIB) * MAX_PRIORITY) // (_MAX_IMG_MIB - _MIN_IMG_MIB))
        return out


class EqualPriority:
    name = "EqualPriority"

    def compute_all(self, pod, infos, ctx) -> list[int]:
        return [1] * len(infos)


# ---------------------------------------------------------------------------
# Inter-pod affinity scoring (interpod_affinity.go:119) — O(pods x terms)
# term processing into a (topologyKey, value) weight accumulator, then a
# per-node gather + min/max normalization.
# ---------------------------------------------------------------------------


class InterPodAffinityPriority:
    name = "InterPodAffinityPriority"

    def compute_all(self, pod, infos, ctx: PriorityContext) -> list[int]:
        aff = pod.spec.affinity
        # (topology_key, value) -> accumulated weight
        topo_weights: dict[tuple[str, str], int] = {}

        def add(node: Optional[api.Node], key: str, weight: int) -> None:
            if node is None or not key:
                return
            value = node.meta.labels.get(key)
            if value is None:
                return
            topo_weights[(key, value)] = topo_weights.get((key, value), 0) + weight

        # Weight accumulation walks existing pods on EVERY node in the
        # cluster (reference allNodeNames from nodeNameToInfo,
        # interpod_affinity.go:124-128); only the final per-node gather below
        # is restricted to the feasible `infos`.
        for info in ctx.node_info_map.values():
            existing_pods = (
                info.pods
                if aff and (aff.pod_affinity_preferred or aff.pod_anti_affinity_preferred)
                else info.pods_with_affinity
            )
            for existing in existing_pods:
                # incoming pod's soft terms vs existing pod
                if aff is not None:
                    for wt in aff.pod_affinity_preferred:
                        if _pod_matches_term(existing, pod, wt.term):
                            add(info.node, wt.term.topology_key, wt.weight)
                    for wt in aff.pod_anti_affinity_preferred:
                        if _pod_matches_term(existing, pod, wt.term):
                            add(info.node, wt.term.topology_key, -wt.weight)
                # symmetry: existing pod's terms vs incoming pod
                eaff = existing.spec.affinity
                if eaff is not None:
                    if ctx.hard_pod_affinity_weight > 0:
                        for term in eaff.pod_affinity_required:
                            if _pod_matches_term(pod, existing, term):
                                add(info.node, term.topology_key, ctx.hard_pod_affinity_weight)
                    for wt in eaff.pod_affinity_preferred:
                        if _pod_matches_term(pod, existing, wt.term):
                            add(info.node, wt.term.topology_key, wt.weight)
                    for wt in eaff.pod_anti_affinity_preferred:
                        if _pod_matches_term(pod, existing, wt.term):
                            add(info.node, wt.term.topology_key, -wt.weight)

        counts = []
        for info in infos:
            total = 0
            if info.node is not None:
                for (key, value), w in topo_weights.items():
                    if info.node.meta.labels.get(key) == value:
                        total += w
            counts.append(total)

        # reference min/max start at 0 (declared zero-valued floats)
        max_c = max(max(counts, default=0), 0)
        min_c = min(min(counts, default=0), 0)
        if max_c == min_c:
            return [0] * len(infos)
        return [(MAX_PRIORITY * (c - min_c)) // (max_c - min_c) for c in counts]


# ---------------------------------------------------------------------------
# Default provider set (defaults.go:188-228) with weights
# ---------------------------------------------------------------------------


def default_priorities() -> list[tuple[object, int]]:
    return [
        (SelectorSpreadPriority(), 1),
        (InterPodAffinityPriority(), 1),
        (LeastRequestedPriority(), 1),
        (BalancedResourceAllocation(), 1),
        (NodePreferAvoidPodsPriority(), 10000),
        (NodeAffinityPriority(), 1),
        (TaintTolerationPriority(), 1),
    ]


def cluster_autoscaler_priorities() -> list[tuple[object, int]]:
    """defaults.go:65-66: swap LeastRequested for MostRequested (bin-pack)."""
    out = []
    for prio, weight in default_priorities():
        if isinstance(prio, LeastRequestedPriority):
            out.append((MostRequestedPriority(), weight))
        else:
            out.append((prio, weight))
    return out


class ServiceSpreadingPriority(SelectorSpreadPriority):
    """Registered non-default priority (``defaults.go``
    ServiceSpreadingPriority): SelectorSpread restricted to SERVICE
    selectors only — the pre-SelectorSpread spreading behavior kept for
    compatibility.

    No scan weight: not in ``ops/backend._PRIORITY_WEIGHT_KEY``, so a
    policy that uses it schedules every batch on the oracle, as in the
    JAX package."""

    # kernel: host-fallback — compat-only priority; configs using it take the all-oracle path (no _PRIORITY_WEIGHT_KEY entry)
    name = "ServiceSpreadingPriority"

    def _selectors_for_pod(self, pod: api.Pod, ctx: PriorityContext):
        return [
            ("simple", svc.selector)
            for svc in ctx.services
            if svc.meta.namespace == pod.meta.namespace and svc.selector
            and matches_simple_selector(svc.selector, pod.meta.labels)
        ]
