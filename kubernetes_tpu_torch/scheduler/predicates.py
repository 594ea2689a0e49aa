"""Oracle filter predicates — the feasibility spec.

The default predicate set of the reference scheduler
(``plugin/pkg/scheduler/algorithm/predicates/predicates.go``).  This module
is the sequential CPU oracle: the behavioral specification that the
feasibility masks built by ``models/snapshot.py`` and evaluated by the scan
(``ops/scan_ref.py``, ``ops/csrc/fused_scan.cu``) reproduce bit-for-bit on
the canonical fixed-point units.

Each predicate: ``fn(pod, meta, node_info, ctx) -> (ok, reasons)`` where
``meta`` is per-pod precomputation shared across all nodes and ``ctx``
exposes cluster-wide lookups (all pods, node-by-name).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api import types as api
from ..api.selectors import matches_simple_selector
from .nodeinfo import NodeInfo
from .units import CPU_MILLI, GPU_COUNT, MEM_MIB, STORAGE_MIB, ResourceVec, pod_request_vec

# Failure reasons (predicate name -> human string), mirroring the
# reference's typed PredicateFailureReasons.
INSUFFICIENT_CPU = "Insufficient cpu"
INSUFFICIENT_MEMORY = "Insufficient memory"
INSUFFICIENT_STORAGE = "Insufficient ephemeral-storage"
INSUFFICIENT_GPU = "Insufficient nvidia.com/gpu"
INSUFFICIENT_PODS = "Too many pods"
NODE_NOT_MATCH_HOST = "node(s) didn't match the requested hostname"
PORT_CONFLICT = "node(s) didn't have free ports"
SELECTOR_MISMATCH = "node(s) didn't match node selector"
TAINT_NOT_TOLERATED = "node(s) had taints that the pod didn't tolerate"
MEMORY_PRESSURE = "node(s) had memory pressure"
DISK_PRESSURE = "node(s) had disk pressure"
DISK_CONFLICT = "node(s) had no available disk"
MAX_VOLUME_COUNT = "node(s) exceed max volume count"
VOLUME_ZONE_CONFLICT = "node(s) had volume zone conflict"
VOLUME_NODE_CONFLICT = "node(s) didn't match PersistentVolume's node affinity"
UNBOUND_PVC = "pod has unbound/missing PersistentVolumeClaim"
AFFINITY_NOT_MATCH = "node(s) didn't satisfy inter-pod (anti)affinity"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
NODE_NOT_READY = "node(s) were not ready"


@dataclass
class MatchingAntiAffinityTerm:
    """An existing pod's required anti-affinity term that selects the pod
    being scheduled (the symmetry set, reference
    ``getMatchingAntiAffinityTerms`` ``predicates.go:1065,1120``)."""

    term: api.PodAffinityTerm
    owner_node_labels: dict[str, str]


@dataclass
class PredicateMetadata:
    """Per-pod precomputation shared across all nodes
    (``predicates/metadata.go``).  Cheap host-side work done once per pod;
    the batch tensorizer computes the same things as [P, ...] arrays."""

    pod_request: ResourceVec = field(default_factory=ResourceVec)
    is_best_effort: bool = False
    host_ports: list[tuple[str, int]] = field(default_factory=list)
    matching_anti_affinity_terms: list[MatchingAntiAffinityTerm] = field(default_factory=list)
    # The pod's OWN required (anti)affinity terms, collapsed to topology
    # VALUE SETS per term (computed once per pod; the per-node check then
    # costs O(1) set lookups instead of an all-pods scan — the value-set
    # form of predicates.go:1181's per-node scan, bit-identical because
    # _same_topology is exactly "both nodes carry the key with equal
    # values").  None = pod carries no such terms.
    own_affinity_values: "list[tuple[str, set, bool, bool]] | None" = None
    # [(topology_key, matching_values, matching_pod_exists, self_match)]
    own_anti_affinity_values: "list[tuple[str, set]] | None" = None
    # [(topology_key, forbidden_values)]
    # Symmetry set collapsed the same way: key -> owner-node values where
    # co-location is forbidden; sym_always_fails = a symmetry term with no
    # topology key (forbids every node, as the term list form does)
    sym_forbidden: "dict[str, set] | None" = None
    sym_always_fails: bool = False


class PredicateContext:
    """Cluster-wide lookups for cross-node predicates (affinity).

    The pod lists are memoized: one Schedule() call evaluates N nodes
    against the same snapshot, and rebuilding a 150k-pod list per node
    would dominate the filter phase (the reference avoids this with
    predicate metadata, ``predicates/metadata.go``)."""

    def __init__(
        self,
        node_info_map: dict[str, NodeInfo],
        pvcs: Optional[dict[str, object]] = None,
        pvs: Optional[dict[str, object]] = None,
        services: Optional[list] = None,
    ):
        self.node_info_map = node_info_map
        # "ns/name" -> PersistentVolumeClaim; name -> PersistentVolume
        # (the reference threads pvcLister/pvLister into the volume
        # predicates via ConfigFactory, factory.go:120)
        self.pvcs = pvcs or {}
        self.pvs = pvs or {}
        # Services (CheckServiceAffinity reads the serviceLister the same
        # way, predicates.go:821)
        self.services = services or []
        self._all_pods: Optional[list[tuple[api.Pod, NodeInfo]]] = None
        self._all_pods_with_affinity: Optional[list[tuple[api.Pod, NodeInfo]]] = None

    def bound_pv_for(self, pod: api.Pod, vol: api.Volume):
        """Resolve a pod volume's PVC reference to its bound PV.
        Returns (pv, ok): ok=False means missing/unbound claim (the
        reference fails scheduling on lookup errors, predicates.go:430)."""
        pvc = self.pvcs.get(f"{pod.meta.namespace}/{vol.pvc_name}")
        if pvc is None or not pvc.volume_name:
            return None, False
        pv = self.pvs.get(pvc.volume_name)
        if pv is None:
            return None, False
        return pv, True

    def all_pods_with_affinity(self) -> list[tuple[api.Pod, NodeInfo]]:
        if self._all_pods_with_affinity is None:
            self._all_pods_with_affinity = [
                (p, info)
                for info in self.node_info_map.values()
                for p in info.pods_with_affinity
            ]
        return self._all_pods_with_affinity

    def all_pods(self) -> list[tuple[api.Pod, NodeInfo]]:
        if self._all_pods is None:
            self._all_pods = [
                (p, info) for info in self.node_info_map.values() for p in info.pods
            ]
        return self._all_pods

    def node_labels(self, node_name: str) -> dict[str, str]:
        info = self.node_info_map.get(node_name)
        if info is None or info.node is None:
            return {}
        return info.node.meta.labels


def compute_metadata(pod: api.Pod, ctx: PredicateContext) -> PredicateMetadata:
    meta = PredicateMetadata(
        pod_request=pod_request_vec(pod),
        is_best_effort=pod.qos_class() == api.BEST_EFFORT,
        host_ports=pod.host_ports(),
    )
    # Symmetry set: every existing pod whose required anti-affinity selects
    # this pod forbids co-location within its term's topology domain.
    for existing, info in ctx.all_pods_with_affinity():
        aff = existing.spec.affinity
        if aff is None or not aff.pod_anti_affinity_required:
            continue
        node_labels = info.node.meta.labels if info.node else {}
        for term in aff.pod_anti_affinity_required:
            if _pod_matches_term(pod, existing, term):
                meta.matching_anti_affinity_terms.append(
                    MatchingAntiAffinityTerm(term=term, owner_node_labels=node_labels)
                )
    if meta.matching_anti_affinity_terms:
        meta.sym_forbidden = {}
        for mt in meta.matching_anti_affinity_terms:
            key = mt.term.topology_key
            if not key:
                meta.sym_always_fails = True
                continue
            if key in mt.owner_node_labels:
                meta.sym_forbidden.setdefault(key, set()).add(mt.owner_node_labels[key])

    # The pod's own required terms, collapsed to per-term topology value
    # sets in ONE pass over the cluster (instead of one pass per node)
    aff = pod.spec.affinity
    if aff is not None and (aff.pod_affinity_required or aff.pod_anti_affinity_required):
        all_pods = ctx.all_pods()
        if aff.pod_affinity_required:
            meta.own_affinity_values = []
            for term in aff.pod_affinity_required:
                values: set = set()
                exists = False
                for existing, existing_info in all_pods:
                    if not _pod_matches_term(existing, pod, term):
                        continue
                    exists = True
                    labels = existing_info.node.meta.labels if existing_info.node else {}
                    if term.topology_key in labels:
                        values.add(labels[term.topology_key])
                meta.own_affinity_values.append(
                    (term.topology_key, values, exists, _pod_matches_term(pod, pod, term))
                )
        if aff.pod_anti_affinity_required:
            meta.own_anti_affinity_values = []
            for term in aff.pod_anti_affinity_required:
                values = set()
                for existing, existing_info in all_pods:
                    if not _pod_matches_term(existing, pod, term):
                        continue
                    labels = existing_info.node.meta.labels if existing_info.node else {}
                    if term.topology_key in labels:
                        values.add(labels[term.topology_key])
                meta.own_anti_affinity_values.append((term.topology_key, values))
    return meta


def _pod_matches_term(candidate: api.Pod, term_owner: api.Pod, term: api.PodAffinityTerm) -> bool:
    """Does ``candidate`` fall in the term's namespace+selector scope?
    (reference ``priorityutil.PodMatchesTermsNamespaceAndSelector``)"""
    namespaces = term.namespaces or [term_owner.meta.namespace]
    if candidate.meta.namespace not in namespaces:
        return False
    if term.selector is None:
        return False
    return term.selector.matches(candidate.meta.labels)


def _same_topology(labels_a: dict[str, str], labels_b: dict[str, str], key: str) -> bool:
    """reference ``priorityutil.NodesHaveSameTopologyKey``: both nodes carry
    the key and the values are equal."""
    if not key:
        return False
    return key in labels_a and key in labels_b and labels_a[key] == labels_b[key]


# ---------------------------------------------------------------------------
# GeneralPredicates (predicates.go:900): resources + host + ports + selector
# ---------------------------------------------------------------------------


def pod_fits_resources(pod, meta: PredicateMetadata, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``PodFitsResources`` (:556): requested + pod <= allocatable
    per resource, plus the pod-count dimension."""
    reasons = []
    if len(info.pods) + 1 > info.allocatable_pods:
        reasons.append(INSUFFICIENT_PODS)
    req = meta.pod_request
    checks = (
        (CPU_MILLI, INSUFFICIENT_CPU),
        (MEM_MIB, INSUFFICIENT_MEMORY),
        (STORAGE_MIB, INSUFFICIENT_STORAGE),
        (GPU_COUNT, INSUFFICIENT_GPU),
    )
    for slot, reason in checks:
        if req[slot] > 0 and info.requested[slot] + req[slot] > info.allocatable[slot]:
            reasons.append(reason)
    return (not reasons), reasons


def pod_fits_host(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``PodFitsHost`` (:698)."""
    if not pod.spec.node_name:
        return True, []
    ok = info.node is not None and pod.spec.node_name == info.node.meta.name
    return ok, ([] if ok else [NODE_NOT_MATCH_HOST])


def pod_fits_host_ports(pod, meta: PredicateMetadata, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``PodFitsHostPorts`` (:859)."""
    for port in meta.host_ports:
        if port in info.used_ports:
            return False, [PORT_CONFLICT]
    return True, []


def pod_matches_node_selector(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``PodMatchNodeSelector`` (:686) =
    ``podMatchesNodeLabels``: spec.nodeSelector AND required node affinity."""
    if info.node is None:
        return False, [SELECTOR_MISMATCH]
    labels = info.node.meta.labels
    if pod.spec.node_selector and not matches_simple_selector(pod.spec.node_selector, labels):
        return False, [SELECTOR_MISMATCH]
    aff = pod.spec.affinity
    if aff is not None and aff.node_affinity_required is not None:
        # nil terms list matches nothing is handled by NodeSelector.matches
        if not aff.node_affinity_required.matches(labels):
            return False, [SELECTOR_MISMATCH]
    return True, []


def general_predicates(pod, meta, info, ctx) -> tuple[bool, list[str]]:
    reasons: list[str] = []
    for fn in (pod_fits_resources, pod_fits_host, pod_fits_host_ports, pod_matches_node_selector):
        ok, r = fn(pod, meta, info, ctx)
        reasons.extend(r)
    return (not reasons), reasons


# ---------------------------------------------------------------------------
# Taints / node conditions
# ---------------------------------------------------------------------------


def pod_tolerates_node_taints(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``PodToleratesNodeTaints`` (:1241): only NoSchedule and
    NoExecute taints matter; every such taint must be tolerated."""
    if info.node is None:
        return True, []
    for taint in info.node.spec.taints:
        if taint.effect not in (api.NO_SCHEDULE, api.NO_EXECUTE):
            continue
        if not any(t.tolerates(taint) for t in pod.spec.tolerations):
            return False, [TAINT_NOT_TOLERATED]
    return True, []


def check_node_memory_pressure(pod, meta: PredicateMetadata, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``CheckNodeMemoryPressurePredicate`` (:1274): only
    BestEffort pods are blocked by memory pressure."""
    if not meta.is_best_effort:
        return True, []
    if info.memory_pressure:
        return False, [MEMORY_PRESSURE]
    return True, []


def check_node_disk_pressure(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``CheckNodeDiskPressurePredicate`` (:1296): blocks all pods."""
    if info.disk_pressure:
        return False, [DISK_PRESSURE]
    return True, []


def check_node_schedulable(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """spec.unschedulable gate (reference enforces this in the node lister
    filter, ``factory.go``'s scheduled-node predicate; kept explicit here)."""
    if info.node is not None and info.node.spec.unschedulable:
        return False, [NODE_UNSCHEDULABLE]
    return True, []


def check_node_condition(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """Ready-condition gate: the reference's scheduler node lister excludes
    nodes whose Ready condition is not True (``factory.go``
    getNodeConditionPredicate) — without it, pods land on dead nodes and
    ping-pong through eviction."""
    if info.node is None:
        return False, [NODE_NOT_READY]
    ready = info.node.status.condition(api.NODE_READY)
    if ready is not None and ready.status != "True":
        return False, [NODE_NOT_READY]
    return True, []


# ---------------------------------------------------------------------------
# Volumes
# ---------------------------------------------------------------------------

# Disk kinds that allow co-location when every reference is read-only
# (reference NoDiskConflict: GCE PD and ISCSI allow all-read-only sharing;
# EBS and RBD never share — predicates.go:121-183).
_READONLY_SHARED_KINDS = {"gce-pd", "iscsi"}

VOLUME_COUNT_LIMITS = {
    "aws-ebs": 39,  # DefaultMaxEBSVolumes
    "gce-pd": 16,  # DefaultMaxGCEPDVolumes
    "azure-disk": 16,
}


def no_disk_conflict(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    for vol in pod.spec.volumes:
        if not vol.disk_id:
            continue
        for existing in info.pods:
            for evol in existing.spec.volumes:
                if evol.disk_id != vol.disk_id or evol.disk_kind != vol.disk_kind:
                    continue
                if vol.disk_kind in _READONLY_SHARED_KINDS and vol.read_only and evol.read_only:
                    continue
                return False, [DISK_CONFLICT]
    return True, []


def max_volume_count(pod, meta, info: NodeInfo, ctx) -> tuple[bool, list[str]]:
    """reference ``MaxPDVolumeCountChecker`` (:215): per attachable-disk
    kind, distinct volumes already on the node plus the pod's new ones must
    not exceed the kind's limit."""
    for kind, limit in VOLUME_COUNT_LIMITS.items():
        pod_vols = {v.disk_id for v in pod.spec.volumes if v.disk_kind == kind and v.disk_id}
        if not pod_vols:
            continue
        node_vols = set()
        for existing in info.pods:
            for evol in existing.spec.volumes:
                if evol.disk_kind == kind and evol.disk_id:
                    node_vols.add(evol.disk_id)
        if len(node_vols | pod_vols) > limit:
            return False, [MAX_VOLUME_COUNT]
    return True, []


def no_volume_zone_conflict(pod, meta, info: NodeInfo, ctx: PredicateContext) -> tuple[bool, list[str]]:
    """reference ``VolumeZoneChecker.predicate`` (predicates.go:402): a pod
    referencing a PVC bound to a zone-labelled PV may only land on nodes in
    that zone; missing/unbound claims fail scheduling outright."""
    vols = [v for v in pod.spec.volumes if v.pvc_name]
    if not vols:
        return True, []
    if info.node is None:
        return False, [VOLUME_ZONE_CONFLICT]
    node_zone = info.node.meta.labels.get(api.ZONE_LABEL, "")
    for vol in vols:
        pv, ok = ctx.bound_pv_for(pod, vol)
        if not ok:
            return False, [UNBOUND_PVC]
        if pv.zone and pv.zone != node_zone:
            return False, [VOLUME_ZONE_CONFLICT]
    return True, []


def no_volume_node_conflict(pod, meta, info: NodeInfo, ctx: PredicateContext) -> tuple[bool, list[str]]:
    """reference ``VolumeNodeChecker.predicate`` (predicates.go:1323): a PV
    carrying node affinity (local volumes) pins its pods to matching nodes.
    Unlike the zone check, unresolvable claims are skipped here — the zone
    predicate already reports them (mirrors the reference's split where the
    node checker tolerates nil PVs)."""
    vols = [v for v in pod.spec.volumes if v.pvc_name]
    if not vols:
        return True, []
    if info.node is None:
        return False, [VOLUME_NODE_CONFLICT]
    labels = info.node.meta.labels
    for vol in vols:
        pv, ok = ctx.bound_pv_for(pod, vol)
        if not ok:
            continue
        if pv.node_affinity is not None and not pv.node_affinity.matches(labels):
            return False, [VOLUME_NODE_CONFLICT]
    return True, []


# ---------------------------------------------------------------------------
# Inter-pod affinity / anti-affinity (the reference's hot spot,
# predicates.go:982 MatchInterPodAffinity)
# ---------------------------------------------------------------------------


def match_inter_pod_affinity(pod, meta: PredicateMetadata, info: NodeInfo, ctx: PredicateContext) -> tuple[bool, list[str]]:
    if meta is None:
        # probe callers without precomputation get the real thing — the
        # scan branches below must never run against missing symmetry data
        meta = compute_metadata(pod, ctx)
    if info.node is None:
        return False, [AFFINITY_NOT_MATCH]
    node_labels = info.node.meta.labels

    # 1. Symmetry: existing pods' required anti-affinity must not be broken
    #    (satisfiesExistingPodsAntiAffinity, predicates.go:1146) — value-set
    #    form when precomputed, term-list scan otherwise
    if meta is not None and meta.sym_forbidden is not None:
        if meta.sym_always_fails:
            return False, [AFFINITY_NOT_MATCH]
        for key, values in meta.sym_forbidden.items():
            if key in node_labels and node_labels[key] in values:
                return False, [AFFINITY_NOT_MATCH]
    else:
        for mt in meta.matching_anti_affinity_terms:
            if not mt.term.topology_key:
                return False, [AFFINITY_NOT_MATCH]
            if _same_topology(node_labels, mt.owner_node_labels, mt.term.topology_key):
                return False, [AFFINITY_NOT_MATCH]

    aff = pod.spec.affinity
    if aff is None or (not aff.pod_affinity_required and not aff.pod_anti_affinity_required):
        return True, []

    # 2+3. The pod's own required terms (satisfiesPodsAffinityAntiAffinity,
    # predicates.go:1181) over the per-pod precomputed value sets: a term is
    # satisfied iff this node's topology value is in the term's matching
    # set (affinity) / out of it (anti-affinity); the first-pod rule
    # (predicates.go:1196-1216) rides the precomputed exists/self flags.
    if meta is not None and (
        meta.own_affinity_values is not None or meta.own_anti_affinity_values is not None
    ):
        for key, values, exists, self_match in meta.own_affinity_values or ():
            if not key:
                return False, [AFFINITY_NOT_MATCH]
            if node_labels.get(key) in values and key in node_labels:
                continue
            if exists:
                return False, [AFFINITY_NOT_MATCH]
            if not self_match:
                return False, [AFFINITY_NOT_MATCH]
        for key, values in meta.own_anti_affinity_values or ():
            if not key:
                return False, [AFFINITY_NOT_MATCH]
            if key in node_labels and node_labels.get(key) in values:
                return False, [AFFINITY_NOT_MATCH]
        return True, []

    # direct per-node scan (reached only with a hand-built meta lacking
    # the value sets, e.g. external predicate callers)
    all_pods = None  # lazily fetched
    for term in aff.pod_affinity_required:
        if not term.topology_key:
            return False, [AFFINITY_NOT_MATCH]
        if all_pods is None:
            all_pods = ctx.all_pods()
        term_matches = False
        matching_pod_exists = False
        for existing, existing_info in all_pods:
            if not _pod_matches_term(existing, pod, term):
                continue
            matching_pod_exists = True
            existing_labels = existing_info.node.meta.labels if existing_info.node else {}
            if _same_topology(node_labels, existing_labels, term.topology_key):
                term_matches = True
                break
        if not term_matches:
            # First-pod rule (predicates.go:1196-1216): if no pod anywhere
            # matches the term but the pod matches its own term, disregard.
            if matching_pod_exists:
                return False, [AFFINITY_NOT_MATCH]
            if not _pod_matches_term(pod, pod, term):
                return False, [AFFINITY_NOT_MATCH]

    for term in aff.pod_anti_affinity_required:
        if not term.topology_key:
            return False, [AFFINITY_NOT_MATCH]
        if all_pods is None:
            all_pods = ctx.all_pods()
        for existing, existing_info in all_pods:
            if not _pod_matches_term(existing, pod, term):
                continue
            existing_labels = existing_info.node.meta.labels if existing_info.node else {}
            if _same_topology(node_labels, existing_labels, term.topology_key):
                return False, [AFFINITY_NOT_MATCH]

    return True, []


# ---------------------------------------------------------------------------
# Registry — the default predicate set, in a fixed evaluation order
# (order affects only failure reasons, not feasibility).
# ---------------------------------------------------------------------------

PredicateFn = Callable[[api.Pod, PredicateMetadata, NodeInfo, PredicateContext], tuple[bool, list[str]]]


def make_check_node_label_presence(labels: list, presence: bool) -> PredicateFn:
    """``CheckNodeLabelPresence`` factory (predicates.go:737): with
    presence=True every listed label must EXIST on the node; with
    presence=False none may (value-agnostic — used to steer off/onto
    labeled pools).

    No scan mask: a policy-file-only predicate, and any config whose
    predicate set differs from DEFAULT_PREDICATES schedules on the oracle
    (``ops/backend._config_supported``)."""
    # kernel: host-fallback — policy-only; non-default predicate configs run all-oracle (backend._config_supported)

    def check_node_label_presence(pod, meta, info: NodeInfo, ctx):
        node_labels = info.node.meta.labels if info.node else {}
        for label in labels:
            if (label in node_labels) != presence:
                want = "present" if presence else "absent"
                return False, [f"node label {label!r} must be {want}"]
        return True, []

    return check_node_label_presence


def make_check_service_affinity(labels: list) -> PredicateFn:
    """``CheckServiceAffinity`` factory (predicates.go:821): pods of one
    Service co-locate on nodes sharing the same VALUES for the given
    label set — the first scheduled pod of a service pins those values
    (e.g. all of service S in one region).

    No scan mask: the pinned values depend on which pod of the service
    lands first, a cross-pod dynamic the tensorizer does not model, and
    non-default predicate configs schedule on the oracle anyway
    (``ops/backend._config_supported``)."""
    # kernel: host-fallback — first-pod-pins-values dynamic not tensorized; non-default configs run all-oracle

    def _pinned_values(pod, ctx) -> dict:
        """Node-independent: the label values this pod must match —
        explicit nodeSelector first, else inherited from the first
        resident pod of the pod's services.  Memoized on ctx (one
        Schedule call evaluates N nodes; the resident-pod scan must not
        run N times)."""
        cache = getattr(ctx, "_svc_affinity_want", None)
        if cache is None:
            cache = ctx._svc_affinity_want = {}
        hit = cache.get(id(pod))
        if hit is not None:
            return hit
        want: dict = {}
        for label in labels:
            if pod.spec.node_selector and label in pod.spec.node_selector:
                want[label] = pod.spec.node_selector[label]
        missing = [label for label in labels if label not in want]
        if missing:
            selectors = [
                svc.selector for svc in ctx.services
                if svc.selector and svc.meta.namespace == pod.meta.namespace
                and all(pod.meta.labels.get(k) == v for k, v in svc.selector.items())
            ]
            if selectors:
                for other, other_info in ctx.all_pods():
                    if other.meta.namespace != pod.meta.namespace:
                        continue
                    if not any(
                        all(other.meta.labels.get(k) == v for k, v in sel.items())
                        for sel in selectors
                    ):
                        continue
                    other_labels = (other_info.node.meta.labels
                                    if other_info.node else {})
                    for label in missing:
                        if label in other_labels:
                            want.setdefault(label, other_labels[label])
                    break  # first service pod pins the values
        cache[id(pod)] = want
        return want

    def check_service_affinity(pod, meta, info: NodeInfo, ctx):
        node_labels = info.node.meta.labels if info.node else {}
        for label, value in _pinned_values(pod, ctx).items():
            if node_labels.get(label) != value:
                return False, [
                    f"service affinity: node label {label!r} must be {value!r}"]
        return True, []

    return check_service_affinity


DEFAULT_PREDICATES: dict[str, PredicateFn] = {
    "CheckNodeSchedulable": check_node_schedulable,
    "CheckNodeCondition": check_node_condition,
    "NoDiskConflict": no_disk_conflict,
    "MaxVolumeCount": max_volume_count,
    "NoVolumeZoneConflict": no_volume_zone_conflict,
    "NoVolumeNodeConflict": no_volume_node_conflict,
    "GeneralPredicates": general_predicates,
    "PodToleratesNodeTaints": pod_tolerates_node_taints,
    "CheckNodeMemoryPressure": check_node_memory_pressure,
    "CheckNodeDiskPressure": check_node_disk_pressure,
    "MatchInterPodAffinity": match_inter_pod_affinity,
}


def pod_fits_on_node(
    pod: api.Pod,
    meta: PredicateMetadata,
    info: NodeInfo,
    ctx: PredicateContext,
    predicates: Optional[dict[str, PredicateFn]] = None,
) -> tuple[bool, list[str]]:
    """Run every predicate (``podFitsOnNode``, ``core/generic_scheduler.go:234``)
    — all of them, collecting every failure reason, like the reference."""
    reasons: list[str] = []
    for fn in (predicates or DEFAULT_PREDICATES).values():
        ok, r = fn(pod, meta, info, ctx)
        if not ok:
            reasons.extend(r)
    return (not reasons), reasons


_ECACHE_MISS = object()


def _post_cache_stages(pod, meta, info, ctx, has_disk_vols, has_pvc_vols,
                       has_own_aff) -> Optional[str]:
    """The cross-node stages (never cached): volumes + inter-pod affinity."""
    if has_disk_vols:
        ok, r = no_disk_conflict(pod, meta, info, ctx)
        if ok:
            ok, r = max_volume_count(pod, meta, info, ctx)
        if not ok:
            return r[0]
    if has_pvc_vols:
        ok, r = no_volume_zone_conflict(pod, meta, info, ctx)
        if ok:
            ok, r = no_volume_node_conflict(pod, meta, info, ctx)
        if not ok:
            return r[0]
    if has_own_aff or meta.matching_anti_affinity_terms:
        ok, r = match_inter_pod_affinity(pod, meta, info, ctx)
        if not ok:
            return r[0]
    return None


def fast_fit_nodes(
    pod: api.Pod,
    meta: PredicateMetadata,
    node_names: list,
    node_info_map: dict,
    ctx: PredicateContext,
    sig_key: Optional[str] = None,
) -> tuple[list[str], dict[str, list[str]]]:
    """The DEFAULT predicate set fused into one inline pass per node.

    SURVEY §7.1/§2.12: hot paths must not be interpreted-Python *dispatch*
    loops — 11 predicate function calls per node per pod is exactly that.
    This staged form produces IDENTICAL feasibility (every stage is the
    same arithmetic as its predicate function, in the same order); the
    only divergence is that an infeasible node reports its FIRST failing
    stage's reason rather than every failing predicate's — reasons feed
    only the failure-event message.  Custom predicate configs keep the
    full per-predicate loop.

    Pod-invariant work is hoisted: toleration checks memoize on the
    node's taint tuple, stage flags are plain attribute reads, and the
    volume/port/selector stages are skipped entirely for pods that carry
    none (the common case).

    With ``sig_key``, the equivalence-cache analogue engages (reference
    ``core/equivalence_cache.go:55``): each NodeInfo carries its OWN
    ``(generation, {signature: verdict})`` memo of the NODE-LOCAL
    predicate prefix — conditions, taints, resources, host/ports/
    selector — whose inputs are fully covered by the signature and the
    node's generation counter (add/remove_pod and set_node bump it; the
    dict is replaced whenever the generation moves, the reference's
    per-node invalidation).  Living ON the NodeInfo makes the cache
    lineage-correct by construction: the backend's speculative clones
    and a deleted-then-recreated node are different objects with
    different caches.  The cross-node stages (volumes, inter-pod
    affinity) are re-evaluated every time, exactly the split the
    reference enforces by invalidating those predicates on any cluster
    pod event."""
    feasible: list[str] = []
    failures: dict[str, list[str]] = {}

    req = meta.pod_request.units
    req_cpu, req_mem, req_sto, req_gpu = (
        req[CPU_MILLI], req[MEM_MIB], req[STORAGE_MIB], req[GPU_COUNT],
    )
    best_effort = meta.is_best_effort
    host_ports = meta.host_ports
    want_host = pod.spec.node_name
    node_selector = pod.spec.node_selector
    aff = pod.spec.affinity
    node_aff = aff.node_affinity_required if aff is not None else None
    has_disk_vols = any(v.disk_id for v in pod.spec.volumes)
    has_pvc_vols = any(v.pvc_name for v in pod.spec.volumes)
    tolerations = pod.spec.tolerations
    tol_memo: dict[tuple, bool] = {}
    has_own_aff = (
        meta.sym_forbidden is not None
        or meta.own_affinity_values is not None
        or meta.own_anti_affinity_values is not None
    )
    # the cross-node tail is skipped wholesale for plain pods — one spare
    # function call per node per pod is measurable at cluster scale
    needs_tail = (
        has_disk_vols or has_pvc_vols or has_own_aff
        or bool(meta.matching_anti_affinity_terms)
    )

    for name in node_names:
        info = node_info_map[name]
        node = info.node
        node_cache = None
        if sig_key is not None:
            node_cache = getattr(info, "_pred_cache", None)
            if node_cache is None or node_cache[0] != info.generation:
                node_cache = (info.generation, {})
                info._pred_cache = node_cache
            hit = node_cache[1].get(sig_key, _ECACHE_MISS)
            if hit is not _ECACHE_MISS:
                why = hit
                if why is None and needs_tail:
                    why = _post_cache_stages(
                        pod, meta, info, ctx, has_disk_vols, has_pvc_vols,
                        has_own_aff,
                    )
                if why is None:
                    feasible.append(name)
                else:
                    failures[name] = [why]
                continue
        why = None
        if node is None:
            why = NODE_NOT_READY
        elif node.spec.unschedulable:
            why = NODE_UNSCHEDULABLE
        else:
            ready = node.status.condition(api.NODE_READY)
            if ready is not None and ready.status != "True":
                why = NODE_NOT_READY
        if why is None and info.disk_pressure:
            why = DISK_PRESSURE
        if why is None and best_effort and info.memory_pressure:
            why = MEMORY_PRESSURE
        if why is None:
            taints = node.spec.taints
            if taints:
                tkey = tuple(
                    (t.key, t.value, t.effect) for t in taints
                    if t.effect in (api.NO_SCHEDULE, api.NO_EXECUTE)
                )
                if tkey:
                    ok = tol_memo.get(tkey)
                    if ok is None:
                        ok = all(
                            any(tol.tolerates(t) for tol in tolerations)
                            for t in taints
                            if t.effect in (api.NO_SCHEDULE, api.NO_EXECUTE)
                        )
                        tol_memo[tkey] = ok
                    if not ok:
                        why = TAINT_NOT_TOLERATED
        if why is None:
            # PodFitsResources (:556) + pod count
            alloc = info.allocatable.units
            used = info.requested.units
            if len(info.pods) + 1 > info.allocatable_pods:
                why = INSUFFICIENT_PODS
            elif req_cpu > 0 and used[CPU_MILLI] + req_cpu > alloc[CPU_MILLI]:
                why = INSUFFICIENT_CPU
            elif req_mem > 0 and used[MEM_MIB] + req_mem > alloc[MEM_MIB]:
                why = INSUFFICIENT_MEMORY
            elif req_sto > 0 and used[STORAGE_MIB] + req_sto > alloc[STORAGE_MIB]:
                why = INSUFFICIENT_STORAGE
            elif req_gpu > 0 and used[GPU_COUNT] + req_gpu > alloc[GPU_COUNT]:
                why = INSUFFICIENT_GPU
        if why is None and want_host and want_host != node.meta.name:
            why = NODE_NOT_MATCH_HOST
        if why is None and host_ports:
            for port in host_ports:
                if port in info.used_ports:
                    why = PORT_CONFLICT
                    break
        if why is None and (node_selector or node_aff is not None):
            labels = node.meta.labels
            if node_selector and not matches_simple_selector(node_selector, labels):
                why = SELECTOR_MISMATCH
            elif node_aff is not None and not node_aff.matches(labels):
                why = SELECTOR_MISMATCH
        if node_cache is not None:
            # memoize the node-local prefix verdict (why or clean)
            node_cache[1][sig_key] = why
        if why is None and needs_tail:
            # ONE implementation of the cross-node tail for hit and miss
            why = _post_cache_stages(
                pod, meta, info, ctx, has_disk_vols, has_pvc_vols, has_own_aff
            )
        if why is None:
            feasible.append(name)
        else:
            failures[name] = [why]
    return feasible, failures
