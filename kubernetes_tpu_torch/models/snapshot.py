"""Tensorization: cluster snapshot + pod batch → dense arrays.

The bridge between the object world (``NodeInfo`` maps) and the device scan
(``ops/``).

- **Node axis**: nodes sorted by name form the canonical axis shared with
  the oracle; padded to a multiple with an ``exists`` mask.
- **Pod equivalence signatures**: pods created from the same template are
  identical to every predicate and priority.  The batch is deduped into G
  signatures and every per-pod×node static quantity becomes a [G, N] array,
  so nothing is ever [P, N].
- **Strings die on the host**: selectors, labels, taints and topology keys
  are evaluated here; the device sees only integer arrays.

``Tensorizer.build_static`` produces the numpy ``BatchStatic`` of one
segment; ``initial_state`` extracts its dynamic ``InitialState`` from the
NodeInfo map.  ``models/carry.py`` turns both into device tensors.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..api import lazy as lazy_mod
from ..api import types as api
from ..scheduler.nodeinfo import NodeInfo
from ..native import MatchEngine
from ..scheduler.predicates import (
    VOLUME_COUNT_LIMITS,
    _READONLY_SHARED_KINDS,
    _pod_matches_term,
)
from ..scheduler.priorities import (
    PREFER_AVOID_PODS_ANNOTATION,
    PriorityContext,
    SelectorSpreadPriority,
    _zone_key,
)
from ..scheduler.units import (
    CPU_MILLI,
    MEM_MIB,
    NUM_RESOURCES,
    pod_nonzero_request_vec,
    pod_request_vec,
)

_MIN_IMG_MIB = 23
_MAX_IMG_MIB = 1000


def _freeze(x):
    """Recursively convert dict/list structures into hashable tuples
    (dicts as sorted item tuples)."""
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


def _raw_sig_spec_parts(spec: dict, ns: str, labels_t: tuple, ref) -> tuple:
    """Assemble the signature key from a RAW spec dict plus resolved meta
    components — field-for-field the same key `pod_signature_key` builds
    from a decoded pod (store payloads are ``to_dict`` images, so the
    frozen subtrees come out identical)."""
    aff = spec.get("affinity")
    return (
        ns,
        labels_t,
        tuple(sorted((spec.get("nodeSelector") or {}).items())),
        spec.get("nodeName", ""),
        _freeze(aff) if aff else None,
        tuple(_freeze(t) for t in spec.get("tolerations") or ()),
        tuple(_freeze(v) for v in spec.get("volumes") or ()
              if not v.get("diskID")),
        ref,
        tuple(
            (
                c.get("image", ""),
                tuple(sorted(
                    (k, str(v)) for k, v in
                    (((c.get("resources") or {}).get("requests")) or {}).items())),
                tuple(sorted(
                    (p.get("protocol", "TCP"), p.get("hostPort", 0))
                    for p in c.get("ports") or () if p.get("hostPort", 0) > 0)),
            )
            for c in spec.get("containers") or ()
        ),
    )


def raw_pod_signature_key(d: dict) -> tuple:
    """``pod_signature_key`` straight from a wire dict: the column-batch
    emit path groups without constructing a typed object."""
    meta = d.get("metadata") or {}
    spec = d.get("spec") or {}
    return _raw_sig_spec_parts(
        spec,
        meta.get("namespace", "default"),
        tuple(sorted((meta.get("labels") or {}).items())),
        lazy_mod.raw_controller_ref(meta),
    )


def pod_signature_key(pod: api.Pod) -> tuple:
    """Canonical scheduling-equivalence key: exact over everything the
    predicates and priorities read.  An opaque hashable nested tuple.

    Memoized on the pod object: the backend's segmenter and build_static
    both key every pod of every segment.  Safe because batch pods are
    immutable while in flight (a spec change produces a new object).

    A lazy pod whose spec is still undecoded keys straight off its wire
    dict (``_raw_sig_spec_parts``): the same tuple for store round-tripped
    payloads, so grouping is unchanged and no Container or Affinity object
    is built.  A payload that kept a client's unnormalized JSON (defaulted
    keys omitted) may key differently from its eager twin, which only
    splits equivalence groups more finely, never merges distinct pods."""
    cached = getattr(pod, "_sig_key", None)
    if cached is not None:
        return cached
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        meta_raw = lazy_mod.undecoded_meta(pod)
        if meta_raw is not None:
            key = _raw_sig_spec_parts(
                spec_raw,
                meta_raw.get("namespace", "default"),
                tuple(sorted((meta_raw.get("labels") or {}).items())),
                lazy_mod.raw_controller_ref(meta_raw))
        else:
            # meta already decoded (the queue read .key): read it typed
            ref = pod.meta.controller_ref()
            key = _raw_sig_spec_parts(
                spec_raw,
                pod.meta.namespace,
                tuple(sorted(pod.meta.labels.items())),
                (ref.kind, ref.uid) if ref else None)
    else:
        ref = pod.meta.controller_ref()
        key = (
            pod.meta.namespace,
            tuple(sorted(pod.meta.labels.items())),
            tuple(sorted(pod.spec.node_selector.items())),
            pod.spec.node_name,
            _freeze(pod.spec.affinity.to_dict()) if pod.spec.affinity else None,
            tuple(_freeze(t.to_dict()) for t in pod.spec.tolerations),
            # direct-disk volumes are deliberately EXCLUDED: their identity
            # lives on the per-pod volume-slot axis (pod_vol_ids), so
            # distinct disk ids do not mint new signatures
            tuple(_freeze(v.to_dict()) for v in pod.spec.volumes if not v.disk_id),
            (ref.kind, ref.uid) if ref else None,
            tuple(
                (
                    c.image,
                    tuple(sorted((k, str(v)) for k, v in c.resources.requests.items())),
                    tuple(sorted((p.protocol, p.host_port) for p in c.ports if p.host_port > 0)),
                )
                for c in pod.spec.containers
            ),
        )
    try:
        object.__setattr__(pod, "_sig_key", key)
    except AttributeError:
        pass
    return key


def count_affinity_terms(pod: api.Pod) -> int:
    """Number of (anti)affinity term rows this pod contributes to the [T, G]
    tables (empty-topology-key terms never become rows).  Shared by the
    build_static budget probe and the backend's segmenter so both always
    agree on what fits.  The raw branch mirrors the ``from_dict``
    topology-key default (absent key -> hostname -> counts)."""
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        a = spec_raw.get("affinity")
        if not a:
            return 0
        n = 0
        for fld in ("podAffinityRequired", "podAntiAffinityRequired"):
            for t in a.get(fld) or ():
                if t.get("topologyKey", api.HOSTNAME_LABEL):
                    n += 1
        for fld in ("podAffinityPreferred", "podAntiAffinityPreferred"):
            for wt in a.get(fld) or ():
                if (wt.get("podAffinityTerm") or {}).get(
                        "topologyKey", api.HOSTNAME_LABEL):
                    n += 1
        return n
    a = pod.spec.affinity
    if a is None:
        return 0
    return (
        sum(1 for t in a.pod_affinity_required if t.topology_key)
        + sum(1 for t in a.pod_anti_affinity_required if t.topology_key)
        + sum(1 for wt in a.pod_affinity_preferred if wt.term.topology_key)
        + sum(1 for wt in a.pod_anti_affinity_preferred if wt.term.topology_key)
    )


def _disk_refs(pod: api.Pod) -> list:
    """(disk_kind, disk_id, read_only) per direct-disk volume reference,
    raw first: the per-pod loops never decode a spec just to learn it has
    no volumes."""
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        return [(v.get("diskKind", ""), v.get("diskID", ""),
                 bool(v.get("readOnly", False)))
                for v in spec_raw.get("volumes") or () if v.get("diskID")]
    if not pod.spec.volumes:
        return []
    return [(v.disk_kind, v.disk_id, v.read_only)
            for v in pod.spec.volumes if v.disk_id]


def pod_disk_vols(pod: api.Pod) -> set:
    """Distinct (disk_kind, disk_id) identities the pod references — the
    per-pod volume-slot budget unit."""
    return {(kind, disk_id) for kind, disk_id, _ in _disk_refs(pod)}


@dataclass
class _AffinityTerm:
    """One flattened (anti)affinity term carried by a batch signature.

    The batch pods' own terms go to the device: each term becomes a
    row of the [T, G] match matrix, a row of the [T, N] topology-domain map,
    and entries in the symmetry/own weight tables the scan step reads
    (reference semantics: ``predicates.go:982,1065,1146``,
    ``interpod_affinity.go:119``)."""

    owner: int  # signature index
    kind: str  # RA | RAA | PA | PAA
    weight: int  # symmetry scoring weight (RA: hard weight, PA: +w, PAA: -w)
    term: api.PodAffinityTerm


_VOL_KINDS = list(VOLUME_COUNT_LIMITS)  # fixed kind axis for [K, N] counts

_NS_KEY = "\x00ns"  # namespace rides the label space as a reserved key


def _node_static_cols(rep, infos, js, is_best_effort, ref, images,
                      prefer_avoid_weight, image_weight,
                      out_ok, out_aff, out_taint, out_score) -> None:
    """Fill node columns ``js`` of one signature's static rows.

    ``ref`` is the interaction-key's controller-ref component: the actual
    ref when some node's prefer-avoid annotation names its uid, ``None``
    otherwise — so a cached row recomputed for a dirty column keeps the
    semantics of its interaction CLASS, not of the particular pod that
    first populated it."""
    # node-static predicate verdicts (CheckNodeSchedulable,
    # CheckNodeCondition, PodToleratesNodeTaints, the pressure checks and
    # the host/selector half of GeneralPredicates) folded into the [G, N]
    # mask the device step ANDs in
    for j in js:
        info = infos[j]
        node = info.node
        labels = node.meta.labels
        ok = not node.spec.unschedulable
        # Ready-condition gate (CheckNodeCondition)
        if ok:
            ready = node.status.condition(api.NODE_READY)
            ok = ready is None or ready.status == "True"
        # host match
        if ok and rep.spec.node_name:
            ok = rep.spec.node_name == node.meta.name
        # selector + required node affinity
        if ok and rep.spec.node_selector:
            ok = all(labels.get(k) == v for k, v in rep.spec.node_selector.items())
        if ok and rep.spec.affinity is not None and rep.spec.affinity.node_affinity_required is not None:
            ok = rep.spec.affinity.node_affinity_required.matches(labels)
        # taints (NoSchedule/NoExecute)
        if ok:
            for taint in node.spec.taints:
                if taint.effect not in (api.NO_SCHEDULE, api.NO_EXECUTE):
                    continue
                if not any(t.tolerates(taint) for t in rep.spec.tolerations):
                    ok = False
                    break
        # pressure conditions
        if ok and is_best_effort and info.memory_pressure:
            ok = False
        if ok and info.disk_pressure:
            ok = False
        out_ok[j] = ok

        # preferred node affinity raw weight
        if rep.spec.affinity is not None:
            cnt = 0
            for pt in rep.spec.affinity.node_affinity_preferred:
                if pt.weight > 0 and pt.preference.matches(labels):
                    cnt += pt.weight
            out_aff[j] = cnt
        # intolerable PreferNoSchedule taints
        cnt = 0
        for taint in node.spec.taints:
            if taint.effect != api.PREFER_NO_SCHEDULE:
                continue
            if not any(t.tolerates(taint) for t in rep.spec.tolerations):
                cnt += 1
        out_taint[j] = cnt

        # absolute (non-normalized) priorities folded into one array
        score = 0
        if prefer_avoid_weight:
            avoided = False
            if ref is not None and ref.kind in ("ReplicaSet", "ReplicationController"):
                ann = node.meta.annotations.get(PREFER_AVOID_PODS_ANNOTATION, "")
                avoided = ref.uid in [u.strip() for u in ann.split(",") if u.strip()]
            score += prefer_avoid_weight * (0 if avoided else 10)
        if image_weight:
            total_mib = 0
            for img in node.status.images:
                if any(nm in images for nm in img.get("names", [])):
                    total_mib += int(img.get("sizeBytes", 0)) // (2**20)
            if total_mib < _MIN_IMG_MIB:
                iscore = 0
            elif total_mib > _MAX_IMG_MIB:
                iscore = 10
            else:
                iscore = ((total_mib - _MIN_IMG_MIB) * 10) // (_MAX_IMG_MIB - _MIN_IMG_MIB)
            score += image_weight * iscore
        out_score[j] = score


def _pod_content_key(pod: api.Pod) -> tuple:
    """Content identity of a pod as the host state sees it (labels +
    namespace + disk refs), memoized on the pod object under the same
    immutability contract as ``pod_signature_key``; lazy pods read the
    wire dict (the same tuples, by the round-trip argument)."""
    cached = getattr(pod, "_hbs_key", None)
    if cached is not None:
        return cached
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        disks = None
        vols = spec_raw.get("volumes")
        if vols:
            disks = tuple(sorted(
                (v.get("diskKind", ""), v.get("diskID", ""),
                 bool(v.get("readOnly", False)))
                for v in vols if v.get("diskID")))
        labels, ns = lazy_mod.labels_ns_of(pod)
        key = (ns, tuple(sorted(labels.items())), disks)
    else:
        disks = None
        if pod.spec.volumes:
            disks = tuple(sorted(
                (v.disk_kind, v.disk_id, v.read_only)
                for v in pod.spec.volumes if v.disk_id))
        key = (pod.meta.namespace, tuple(sorted(pod.meta.labels.items())), disks)
    try:
        object.__setattr__(pod, "_hbs_key", key)
    except AttributeError:
        pass
    return key


class HostBatchState:
    """Incremental host-side cluster state shared by every kernel segment
    of one batch — and, via ``reconcile``, ACROSS batches.

    Without it, ``initial_state`` rebuilds its selector-match corpus and
    volume occupancy by scanning EVERY pod on EVERY node once per
    segment — O(existing-pods × segments), the dominant host cost at
    150k-pod scale.  Within a batch it is updated per placed pod;
    between batches ``reconcile`` diffs only the nodes whose NodeInfo
    generation moved (the copy-on-write counters of ``cache.go:79``
    carried through the snapshot clones), so a steady-state churn wave
    pays O(pods on touched nodes), not O(cluster).

    Pod label content and spread/term selectors are content-interned:
    wave after wave of template-stamped pods reuses the same labelmap/
    selector ids, which bounds engine growth.

    The node order is the same sorted order ``build_static`` uses, so
    node indices agree across the batch."""

    # engine compaction threshold: rebuild the match corpus when more
    # than this many interned labelmaps have no live pod AND the dead
    # outnumber the live (churn with per-rollout-unique labels would
    # otherwise grow the engine for the process lifetime)
    MAX_DEAD_CONTENT = 4096

    def __init__(self, node_info_map: dict[str, "NodeInfo"]):
        self.eng = MatchEngine()
        self._lid_memo: dict[tuple, int] = {}
        self._sel_memo: dict[tuple, int] = {}
        self._content_rc: dict[tuple, int] = {}  # live pods per labelmap
        self._kind_pos = {k: i for i, k in enumerate(_VOL_KINDS)}
        self.last_dirty: list[int] = []  # node_j's touched by the last reconcile
        self._rebuild(node_info_map)

    def _rebuild(self, node_info_map: dict[str, "NodeInfo"]) -> None:
        # live-content refcounts restart with the pod arrays (interned
        # labelmaps persist in the engine; rc==0 entries are the garbage
        # the compaction threshold watches)
        self._content_rc = {}
        self.node_names = sorted(
            n for n, i in node_info_map.items() if i.node is not None
        )
        self.node_index = {n: j for j, n in enumerate(self.node_names)}
        self.node_gen: dict[str, int] = {}
        self.pod_lids: list[int] = []
        self.pod_node_j: list[int] = []
        self.pod_keys: list[str] = []
        self.pod_content: list[tuple] = []
        self.pod_disks: list[Optional[list]] = []
        # per node_j: pod key -> index into the parallel arrays
        self.node_pods: list[dict[str, int]] = [
            {} for _ in self.node_names
        ]
        self._node_j_cache: Optional[np.ndarray] = None
        # (kind, id) -> {node_j: [refcount, non-sharable refcount]}
        self.disk_locations: dict[tuple, dict[int, list]] = {}
        # distinct limited-kind disks per node: [K, N_real]
        self.nk_counts = np.zeros(
            (len(_VOL_KINDS), len(self.node_names)), dtype=np.int32)
        for name in self.node_names:
            j = self.node_index[name]
            info = node_info_map[name]
            for q in info.pods:
                self._ingest(q, j)
            self.node_gen[name] = info.generation

    def reconcile(self, node_info_map: dict[str, "NodeInfo"]) -> None:
        """Bring the state up to date with a fresh snapshot: nodes whose
        generation is unchanged are skipped wholesale; changed nodes are
        diffed by pod key + content.  A changed node SET falls back to a
        full rebuild (node add/remove is rare and re-indexes the axis).

        ``last_dirty`` records the node positions whose generation moved
        (cache assume/forget and informer deliveries both bump it via the
        CoW counters)."""
        names = sorted(
            n for n, i in node_info_map.items() if i.node is not None
        )
        dead = sum(1 for rc in self._content_rc.values() if rc <= 0)
        if dead > self.MAX_DEAD_CONTENT and dead > len(self._content_rc) - dead:
            # compact: the engine has no labelmap removal, so a
            # corpus dominated by dead content is rebuilt from scratch
            self.eng.close()
            self.eng = MatchEngine()
            self._lid_memo.clear()
            self._sel_memo.clear()
            self._content_rc.clear()
            self._rebuild(node_info_map)
            self.last_dirty = list(range(len(self.node_names)))
            return
        if names != self.node_names:
            self._rebuild(node_info_map)
            self.last_dirty = list(range(len(self.node_names)))
            return
        self.last_dirty = []
        for name in names:
            info = node_info_map[name]
            if self.node_gen.get(name) == info.generation:
                continue
            j = self.node_index[name]
            self.last_dirty.append(j)
            mine = self.node_pods[j]
            current: dict[str, api.Pod] = {q.meta.key: q for q in info.pods}
            for key in [k for k in mine if k not in current]:
                self._remove(mine[key])
            for key, q in current.items():
                idx = mine.get(key)
                if idx is None:
                    self._ingest(q, j)
                elif self.pod_content[idx] != _pod_content_key(q):
                    self._remove(idx)
                    self._ingest(q, j)
            self.node_gen[name] = info.generation

    @property
    def mounted_disks(self):
        """Membership view over every (kind, id) mounted anywhere."""
        return self.disk_locations

    def add_pod(self, pod: api.Pod, node_name: str) -> None:
        j = self.node_index.get(node_name)
        if j is None:
            return
        key = pod.meta.key
        if key not in self.node_pods[j]:
            self._ingest(pod, j, key)

    def selector_id(self, reqs: list[tuple]) -> int:
        """Content-interned ``eng.add_selector``: per-segment spread and
        term selectors repeat across segments and batches (same services/
        controllers), so the selector corpus stays bounded."""
        key = tuple((k, op, tuple(vs)) for k, op, vs in reqs)
        sid = self._sel_memo.get(key)
        if sid is None:
            sid = self.eng.add_selector(reqs)
            self._sel_memo[key] = sid
        return sid

    def _ingest(self, pod: api.Pod, j: int, key: "str | None" = None) -> None:
        if key is None:
            key = pod.meta.key
        content = _pod_content_key(pod)
        lid = self._lid_memo.get(content[:2])
        if lid is None:
            labels, ns = lazy_mod.labels_ns_of(pod)
            lid = self.eng.add_labelmap({**labels, _NS_KEY: ns})
            self._lid_memo[content[:2]] = lid
        self._content_rc[content[:2]] = self._content_rc.get(content[:2], 0) + 1
        idx = len(self.pod_lids)
        self.pod_lids.append(lid)
        self.pod_node_j.append(j)
        self.pod_keys.append(key)
        self.pod_content.append(content)
        self.node_pods[j][key] = idx
        self._node_j_cache = None
        disks = None
        vol_refs = _disk_refs(pod)
        if vol_refs:
            per_pod: dict[tuple, bool] = {}  # all-refs-read-only per disk
            for kind, disk_id, read_only in vol_refs:
                key = (kind, disk_id)
                per_pod[key] = per_pod.get(key, True) and read_only
            if per_pod:
                disks = []
                for key, all_ro in per_pod.items():
                    ns = not (key[0] in _READONLY_SHARED_KINDS and all_ro)
                    disks.append((key, ns))
                    self._disk_add(key, j, ns)
        self.pod_disks.append(disks)

    def _disk_add(self, key: tuple, j: int, ns: bool) -> None:
        locs = self.disk_locations.setdefault(key, {})
        rc = locs.get(j)
        if rc is None:
            locs[j] = [1, 1 if ns else 0]
            pos = self._kind_pos.get(key[0])
            if pos is not None:
                self.nk_counts[pos, j] += 1
        else:
            rc[0] += 1
            if ns:
                rc[1] += 1

    def _disk_sub(self, key: tuple, j: int, ns: bool) -> None:
        locs = self.disk_locations.get(key)
        if locs is None:
            return
        rc = locs.get(j)
        if rc is None:
            return
        rc[0] -= 1
        if ns:
            rc[1] -= 1
        if rc[0] <= 0:
            del locs[j]
            pos = self._kind_pos.get(key[0])
            if pos is not None:
                self.nk_counts[pos, j] -= 1
            if not locs:
                del self.disk_locations[key]

    def _remove(self, idx: int) -> None:
        """Swap-remove entry ``idx`` so the parallel arrays stay dense
        (matching never needs an alive mask)."""
        j = self.pod_node_j[idx]
        del self.node_pods[j][self.pod_keys[idx]]
        content2 = self.pod_content[idx][:2]
        rc = self._content_rc.get(content2, 0) - 1
        self._content_rc[content2] = rc  # rc==0 marks engine garbage
        disks = self.pod_disks[idx]
        if disks:
            for key, ns in disks:
                self._disk_sub(key, j, ns)
        last = len(self.pod_lids) - 1
        if idx != last:
            self.pod_lids[idx] = self.pod_lids[last]
            self.pod_node_j[idx] = self.pod_node_j[last]
            self.pod_keys[idx] = self.pod_keys[last]
            self.pod_content[idx] = self.pod_content[last]
            self.pod_disks[idx] = self.pod_disks[last]
            self.node_pods[self.pod_node_j[idx]][self.pod_keys[idx]] = idx
        self.pod_lids.pop()
        self.pod_node_j.pop()
        self.pod_keys.pop()
        self.pod_content.pop()
        self.pod_disks.pop()
        self._node_j_cache = None

    def node_j_array(self) -> np.ndarray:
        if self._node_j_cache is None:
            self._node_j_cache = np.asarray(self.pod_node_j, dtype=np.int64)
        return self._node_j_cache

    def close(self) -> None:
        self.eng.close()


class NodeStaticRows:
    """Cross-wave cache of the per-signature node-static rows
    (``static_ok`` / ``node_aff_raw`` / ``taint_intol_raw`` /
    ``static_score``) keyed by the signature's node-interaction identity.

    The rows depend only on NODE OBJECTS (labels, taints, conditions,
    annotations, images) — never on pod placements — so in steady-state
    churn, where waves of template-stamped pods repeat the same
    interaction keys against an unchanged fleet, every wave after the
    first reuses the rows outright instead of paying the [G, N] Python
    sweep (the dominant host cost of ``build_static`` at 5k nodes).

    Invalidation is per NODE COLUMN: ``sync`` diffs the node-object
    identity per axis position (``set_node`` always installs a fresh
    object, so identity diffing is exact) and eagerly recomputes exactly
    the dirty columns of every cached row.  A changed node SET or a
    changed weight configuration flushes the cache (new axis epoch).
    The (nonce, epoch, version) token and the dirty column list ride the
    produced ``BatchStatic`` so the device-side cache
    (``ops.node_cache.DeviceNodeCache``) can mirror the same
    only-upload-dirty-columns discipline for the node-axis tensors."""

    _NONCE = itertools.count(1)

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._axis: Optional[tuple] = None
        self._node_refs: list = []
        self._weights_key = None
        # instance nonce: tokens from DIFFERENT NodeStaticRows instances
        # must never compare equal (a swapped-in tensorizer restarts at
        # epoch 1 / version 0, which would alias a stale device cache)
        self._nonce = next(NodeStaticRows._NONCE)
        self.epoch = 0
        self.version = 0
        self.last_dirty: list[int] = []
        # interaction_key -> (rep, is_best_effort, ref, images, rows)
        self._rows: dict = {}
        self.stats = {"hits": 0, "misses": 0, "flushes": 0,
                      "dirty_nodes": 0, "dirty_recomputes": 0}

    def sync(self, node_names: list[str], infos: list, weights_key: tuple,
             row_fn) -> None:
        """Bring the cache in line with the current node axis.  ``row_fn``
        recomputes one cached entry's columns: called as
        ``row_fn(entry, js)`` for each cached row when columns are dirty."""
        axis = tuple(node_names)
        if axis != self._axis or weights_key != self._weights_key:
            self._rows.clear()
            self.epoch += 1
            self.version = 0
            self._axis = axis
            self._weights_key = weights_key
            self._node_refs = [info.node for info in infos]
            self.last_dirty = []
            self.stats["flushes"] += 1
            return
        dirty = [j for j, info in enumerate(infos)
                 if info.node is not self._node_refs[j]]
        if not dirty:
            self.last_dirty = []
            return
        self._node_refs = [info.node for info in infos]
        self.version += 1
        self.last_dirty = dirty
        self.stats["dirty_nodes"] += len(dirty)
        if len(dirty) > max(8, len(infos) // 4):
            # a mostly-dirty axis: recomputing every cached row column by
            # column costs more than letting the rows rebuild on miss
            self._rows.clear()
            return
        for entry in self._rows.values():
            row_fn(entry, dirty)
            self.stats["dirty_recomputes"] += 1

    def get(self, key: tuple):
        entry = self._rows.get(key)
        if entry is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return entry[4]

    def put(self, key: tuple, rep, is_best_effort: bool, ref, images,
            rows: tuple) -> None:
        if len(self._rows) >= self.max_entries:
            self._rows.clear()  # wholesale: keys churn together (rollouts)
            self.stats["flushes"] += 1
        self._rows[key] = (rep, is_best_effort, ref, images, rows)

    def token(self) -> tuple:
        return (self._nonce, self.epoch, self.version)


@dataclass
class BatchStatic:
    """Host-computed static arrays for one kernel segment (numpy)."""

    # node axis
    node_names: list[str]  # length N_real (pre-padding)
    n_pad: int  # padded N
    node_exists: np.ndarray  # [N] bool
    node_alloc: np.ndarray  # [N, R] int32
    node_alloc_pods: np.ndarray  # [N] int32
    node_zone: np.ndarray  # [N] int32, -1 = no zone
    num_zones: int

    # signatures
    group_of_pod: np.ndarray  # [P] int32
    pod_names: list[str]
    # per-signature static masks / scores [G, N]
    static_ok: np.ndarray  # bool
    node_aff_raw: np.ndarray  # int32 (preferred node affinity weights)
    taint_intol_raw: np.ndarray  # int32 (PreferNoSchedule intolerable count)
    static_score: np.ndarray  # int32 (weight-scaled absolute priorities)
    # per-signature resources
    g_request: np.ndarray  # [G, R] int32
    g_nonzero: np.ndarray  # [G, 2] int32
    # ports
    g_ports: np.ndarray  # [G, Pv] bool
    port_vocab: list[tuple[str, int]]
    # spreading
    g_has_spread: np.ndarray  # [G] bool (has matching selectors)
    spread_inc: np.ndarray  # [G, G] int32: landing of sig h bumps counts of sig g
    # inter-pod affinity contributions from EXISTING pods (static: existing
    # pods do not move during the batch):
    interpod_raw: np.ndarray  # [G, N] int32 (scoring symmetry, may be negative)

    # -- phase B: the batch pods' own (anti)affinity terms on device --------
    # T >= 1 (padded with an inert term when the batch carries none)
    terms: "list[_AffinityTerm]" = field(default_factory=list)
    term_matches_sig: np.ndarray = None  # [T, G] bool: sig-g pod in term t's scope
    sym_w: np.ndarray = None  # [T] int32 symmetry scoring weight
    own_w: np.ndarray = None  # [G, T] int32 own soft-term weight (PA +w / PAA -w)
    own_ra: np.ndarray = None  # [G, T] bool own required-affinity terms
    own_raa: np.ndarray = None  # [G, T] bool own required-anti terms
    own_all: np.ndarray = None  # [G, T] bool any term owned by sig
    is_raa: np.ndarray = None  # [T] bool required anti (symmetry forbids)
    self_match: np.ndarray = None  # [T] bool owner matches own term (first-pod rule)
    node_domain: np.ndarray = None  # [T, N] int32 domain id (trash where key absent)
    dom_valid: np.ndarray = None  # [T, N] bool node carries the topology key

    # -- phase B: volumes on device ----------------------------------------
    # Per-POD slot lists: each pod references <= W distinct (kind, id) disks;
    # slot s holds an index into the [V, N] dynamic occupancy arrays
    # (sentinel = v_state-1, an always-empty row for unused slots).  Keeping
    # volume identity off the signature axis keeps G independent of how many
    # distinct disks the batch carries, and makes the per-step device cost
    # O(W·N) instead of O(V·N).
    vol_vocab: list = field(default_factory=list)
    v_state: int = 1  # padded row count of the dynamic [V, N] arrays
    pod_vol_ids: np.ndarray = None  # [P, W] int32 (sentinel for unused slots)
    pod_vol_valid: np.ndarray = None  # [P, W] bool
    pod_vol_ro_ok: np.ndarray = None  # [P, W] bool (all refs ro AND kind sharable)
    pod_vol_kind: np.ndarray = None  # [P, W] int32 (K = kind without a count limit)
    # conflict-free disks: valid for MaxVolumeCount, no occupancy identity
    # (they read the sentinel row and are masked out of the state write)
    pod_vol_count_only: np.ndarray = None  # [P, W] bool
    use_vols: bool = False  # compile-time flag: any volume slot in segment
    vol_limits: np.ndarray = None  # [K] int32

    # scoring mode flags
    weights: dict = field(default_factory=dict)

    # node-axis identity for the device-resident node-state cache
    # (ops.node_cache.DeviceNodeCache): (nonce, epoch, version) from
    # NodeStaticRows plus the columns dirtied since version-1.  A compacted
    # frontier view carries None (see compact_segment).
    node_token: Optional[tuple] = None
    node_dirty: Optional[list] = None

    # compile-time flag: any host port in the segment (no ports → the
    # kernel skips the [N, Pv] port logic and carry write entirely)
    use_ports: bool = True


@dataclass
class InitialState:
    """Dynamic scan state extracted from the NodeInfo map (numpy)."""

    requested: np.ndarray  # [N, R] int32
    nonzero_requested: np.ndarray  # [N, 2] int32
    pod_count: np.ndarray  # [N] int32
    ports_used: np.ndarray  # [N, Pv] bool
    spread_counts: np.ndarray  # [G, N] int32
    round_robin: int
    # phase B dynamic state
    # Affinity-domain state is kept EXPANDED over the node axis — dm[t, j] is
    # the count of pods matching term t in node j's topology domain (0 where
    # the node lacks the key).  The expansion trades a little memory for
    # scatter/gather-free steps: reads are plain rows and the placement
    # update is an elementwise same-domain mask.
    dm: np.ndarray = None  # [T, N] int32: pods matching term t, per node's domain
    downer: np.ndarray = None  # [T, N] int32: placed owners of term t, per node's domain
    total_match: np.ndarray = None  # [T] int32: pods matching term t anywhere
    vol_any: np.ndarray = None  # [V, N] bool volume instance present
    vol_ns: np.ndarray = None  # [V, N] bool non-sharable instance present
    nk: np.ndarray = None  # [K, N] int32 distinct limited-kind disks on node
    # frontier mode: step-0 monotone feasibility per signature (seeded by
    # ``frontier_seed``); becomes the scan's still_ok carry plane
    still_ok: np.ndarray = None  # [G, N] bool


def _pad_to(n: int, multiple: int) -> int:
    if multiple <= 1:
        return max(n, 1)
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


# -- frontier scan: tensorize-time prefilter + host-side compaction ---------

# BatchStatic / InitialState fields carrying a node axis → axis position
# (shared by compact_segment; the device-side twin is
# ops.frontier.gather_node_axis)
_STATIC_NODE_FIELDS = {
    "node_exists": 0, "node_alloc": 0, "node_alloc_pods": 0, "node_zone": 0,
    "static_ok": 1, "node_aff_raw": 1, "taint_intol_raw": 1,
    "static_score": 1, "interpod_raw": 1, "node_domain": 1, "dom_valid": 1,
}
_INIT_NODE_FIELDS = {
    "requested": 0, "nonzero_requested": 0, "pod_count": 0, "ports_used": 0,
    "spread_counts": 1, "dm": 1, "downer": 1, "vol_any": 1, "vol_ns": 1,
    "nk": 1, "still_ok": 1,
}


def monotone_plane(static: BatchStatic, requested: np.ndarray,
                   pod_count: np.ndarray, ports_used: np.ndarray,
                   dm: "np.ndarray | None" = None,
                   downer: "np.ndarray | None" = None) -> np.ndarray:
    """The MONOTONE feasibility plane [G, N] at an arbitrary dynamic
    state: the plane builder shared by :func:`frontier_seed` (step-0
    state) and the tests of the scan's chunk-end ``still_ok`` refresh
    (whose tensor twin is ``ops.scan_ref.monotone_plane`` and whose kernel
    is ``ops/csrc/frontier_refresh.cu``).

    Only components that can never improve as the carry grows belong
    here: resource fit, pod-count, ports, placed-owner symmetric
    required-anti hits (``downer > 0``), and own required-anti hits
    (``dm > 0``).  The own required-AFFINITY terms and the first-pod
    rule are non-monotone (a landing pod can turn them ON) and are
    deliberately excluded: the plane must over-approximate every
    FUTURE pod's feasibility, never under."""
    g_request = static.g_request
    fit = np.all(
        (requested[None, :, :] + g_request[:, None, :]
         <= static.node_alloc[None, :, :]) | (g_request[:, None, :] <= 0),
        axis=2)  # [G, N]
    pods_ok = pod_count + 1 <= static.node_alloc_pods  # [N]
    mono = static.static_ok & static.node_exists[None, :] & fit & pods_ok[None, :]
    if static.use_ports:
        ports_bad = (ports_used[None, :, :]
                     & static.g_ports[:, None, :]).any(axis=2)  # [G, N]
        mono &= ~ports_bad
    if static.terms and dm is not None:
        # own required-anti terms violated by matching pods already in
        # the node's domain
        raa_bad = static.own_raa.astype(np.int32) @ (dm > 0).astype(np.int32) > 0
        mono &= ~raa_bad
    if static.terms and downer is not None:
        # placed owners' symmetric required-anti terms forbid their
        # domains for every matching signature (predicates.go:1146)
        sym = (static.term_matches_sig & static.is_raa[:, None]).astype(np.int32)
        mono &= ~(sym.T @ (downer > 0).astype(np.int32) > 0)
    return mono


def frontier_seed(static: BatchStatic, init: InitialState) -> np.ndarray:
    """Compute the step-0 MONOTONE feasibility plane [G, N] and seed
    ``init.still_ok`` with it; returns the G-union alive mask [N].

    A column False here for signature g can never become feasible for g
    within the segment: static_ok never changes, requested/pod_count/
    ports_used only grow (fit/pods/ports only get worse), and the
    required-anti-affinity hit (``dm > 0`` on an own-RAA term) is
    monotone because placements only add matching pods.  A column
    False for EVERY signature is therefore provably inert: every
    normalization, tie set, and n_feasible in the scan ranges over
    feasible columns only, so dropping it is bit-exact."""
    # downer is omitted: it starts at zero (placed-owner symmetry cannot
    # have fired before the segment's first step)
    mono = monotone_plane(
        static, init.requested, init.pod_count, init.ports_used,
        dm=init.dm if static.terms and init.dm is not None else None)
    init.still_ok = mono
    return mono.any(axis=0)


def compact_segment(static: BatchStatic, init: InitialState,
                    js: np.ndarray, width: int
                    ) -> tuple[BatchStatic, InitialState]:
    """Host-side node-axis compaction (the tensorize-time prefilter's
    second half): keep columns ``js`` (full-axis order preserved: the
    round-robin tie-break walks the axis in order) padded to ``width``.
    ``node_names`` becomes the kept subset, so chosen indices map back
    through it and the backend's commit path needs no change.
    ``node_token`` is cleared: a compacted view must never alias a
    full-width DeviceNodeCache entry."""
    k = len(js)
    assert width >= k

    def take(arr, axis):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, width - k)
        return np.pad(np.take(arr, js, axis=axis), pad)

    s_fields = {f: take(getattr(static, f), ax)
                for f, ax in _STATIC_NODE_FIELDS.items()}
    s_fields["node_exists"][k:] = False
    cstatic = dataclasses.replace(
        static,
        # js past the named range are pre-existing pad columns (the name
        # list covers real nodes only); they keep node_exists False and
        # can never be chosen, so dropping their (nonexistent) names is
        # safe: chosen indices always land inside the named prefix
        node_names=[static.node_names[j] for j in js
                    if j < len(static.node_names)],
        n_pad=width,
        node_token=None,
        node_dirty=None,
        **s_fields,
    )
    i_fields = {f: take(getattr(init, f), ax)
                for f, ax in _INIT_NODE_FIELDS.items()
                if getattr(init, f) is not None}
    cinit = dataclasses.replace(init, **i_fields)
    return cstatic, cinit


def pad_segment_to_multiple(static: BatchStatic, init: InitialState,
                            multiple: int
                            ) -> tuple[BatchStatic, InitialState]:
    """Pad the node axis up to the next multiple of ``multiple`` (the
    sharded loop needs every shard to own an equal slice).  Identity when
    it already divides.  Padding rides ``compact_segment`` with the full
    identity column set, so the padded columns are born dead:
    ``node_exists`` and ``still_ok`` are False there, and no reduce of the
    scan can see them as feasible."""
    n = int(static.n_pad)
    m = max(int(multiple), 1)
    if n % m == 0:
        return static, init
    width = -(-n // m) * m
    return compact_segment(static, init, np.arange(n), width)


class Tensorizer:
    def __init__(
        self,
        pad_multiple: int = 128,
        max_groups: int = 512,
        max_terms: int = 128,
        max_vols: int = 1024,
        vols_per_pod: int = 8,
        group_multiple: int = 32,
        term_multiple: int = 4,
        vol_multiple: int = 32,
        port_multiple: int = 8,
        sticky_buckets: bool = True,
    ):
        # Every shape-determining axis is padded to a bucket multiple, the
        # same buckets as the JAX package's tensorizer, so both packages
        # produce arrays of identical shape from the same snapshot.  The
        # term/vol multiples are deliberately tight: padded [T, N] / [V, N]
        # rows cost per-step device time.
        self.pad_multiple = pad_multiple
        self.max_groups = max_groups
        self.max_terms = max_terms
        self.max_vols = max_vols
        self.vols_per_pod = vols_per_pod
        self.group_multiple = group_multiple
        self.term_multiple = term_multiple
        self.vol_multiple = vol_multiple
        self.port_multiple = port_multiple
        # Sticky shape buckets: each padded axis remembers its high-water
        # bucket and never shrinks, so successive waves keep one shape.
        # Padding UP is always semantically inert.
        self.sticky_buckets = sticky_buckets
        self._sticky: dict[str, int] = {}
        # Cross-wave node-static row cache (see NodeStaticRows).
        self._node_rows = NodeStaticRows()

    def _bucket(self, axis: str, n: int, multiple: int) -> int:
        return self._sticky_pad(axis, _pad_to(n, multiple))

    def _sticky_pad(self, axis: str, pad: int) -> int:
        """One high-water discipline for every axis — including the vols
        axis, whose natural pad has its own empty-vocab floor."""
        if not self.sticky_buckets:
            return pad
        pad = max(pad, self._sticky.get(axis, 0))
        self._sticky[axis] = pad
        return pad

    # -- static ------------------------------------------------------------
    def build_static(
        self,
        pods: list[api.Pod],
        node_info_map: dict[str, NodeInfo],
        pctx: PriorityContext,
        least_requested_weight: int = 0,
        most_requested_weight: int = 0,
        balanced_weight: int = 1,
        spread_weight: int = 1,
        node_affinity_weight: int = 1,
        taint_weight: int = 1,
        prefer_avoid_weight: int = 10000,
        image_weight: int = 0,
        interpod_weight: int = 1,
        mounted_disks: Optional[set] = None,
    ) -> Optional[BatchStatic]:
        node_names = sorted(n for n, i in node_info_map.items() if i.node is not None)
        n_real = len(node_names)
        if n_real == 0 or not pods:
            return None
        n_pad = _pad_to(n_real, self.pad_multiple)
        infos = [node_info_map[n] for n in node_names]

        # signatures
        sig_to_gid: dict[str, int] = {}
        group_of_pod = np.empty(len(pods), dtype=np.int32)
        reps: list[api.Pod] = []  # representative pod per group
        for i, pod in enumerate(pods):
            key = pod_signature_key(pod)
            gid = sig_to_gid.get(key)
            if gid is None:
                gid = len(reps)
                if gid >= self.max_groups:
                    return None  # caller falls back to oracle for this segment
                sig_to_gid[key] = gid
                reps.append(pod)
            group_of_pod[i] = gid
        G = len(reps)

        # cheap tensor-budget probes BEFORE the expensive [G, N] loops: the
        # backend's split fallback re-tensorizes each piece, so an
        # over-budget segment must be rejected for near-free.
        #
        # Only CONFLICT-CAPABLE disks need identity rows in the [V, N]
        # occupancy state: a disk referenced by exactly one pod in the
        # segment and mounted nowhere can never trip NoDiskConflict — by
        # the time a later segment references it again it is mounted and
        # re-enters the vocab there.  Everything else becomes a
        # "count-only" slot (MaxVolumeCount still sees it; see phase B).
        n_terms = sum(count_affinity_terms(rep) for rep in reps)
        if mounted_disks is None:
            mounted_disks = set()
            for info in infos:
                for q in info.pods:
                    mounted_disks |= pod_disk_vols(q)
        seen_once: set[tuple[str, str]] = set()
        conflict_vols: set[tuple[str, str]] = set()
        w_used = 0  # max distinct disks any ONE pod carries (slot axis)
        for pod in pods:
            per_pod = pod_disk_vols(pod)
            if len(per_pod) > self.vols_per_pod:
                return None  # caller falls back to oracle for this pod
            if len(per_pod) > w_used:
                w_used = len(per_pod)
            for d in per_pod:
                if d in mounted_disks or d in seen_once:
                    conflict_vols.add(d)
                else:
                    seen_once.add(d)
        if n_terms > self.max_terms or len(conflict_vols) > self.max_vols:
            return None

        # node-side basics
        node_exists = np.zeros(n_pad, dtype=bool)
        node_exists[:n_real] = True
        node_alloc = np.zeros((n_pad, NUM_RESOURCES), dtype=np.int32)
        node_alloc_pods = np.zeros(n_pad, dtype=np.int32)
        zone_vocab: dict[str, int] = {}
        node_zone = np.full(n_pad, -1, dtype=np.int32)
        for j, info in enumerate(infos):
            node_alloc[j] = info.allocatable.units
            node_alloc_pods[j] = info.allocatable_pods
            zk = _zone_key(info.node)
            if zk:
                if zk not in zone_vocab:
                    zone_vocab[zk] = len(zone_vocab)
                node_zone[j] = zone_vocab[zk]
        num_zones = max(len(zone_vocab), 1)

        # port vocab over the batch
        port_vocab: dict[tuple[str, int], int] = {}
        for rep in reps:
            for port in rep.host_ports():
                if port not in port_vocab:
                    port_vocab[port] = len(port_vocab)
        pv = self._bucket("ports", len(port_vocab), self.port_multiple)
        g_ports = np.zeros((G, pv), dtype=bool)
        for g, rep in enumerate(reps):
            for port in rep.host_ports():
                g_ports[g, port_vocab[port]] = True

        # per-signature resources
        g_request = np.zeros((G, NUM_RESOURCES), dtype=np.int32)
        g_nonzero = np.zeros((G, 2), dtype=np.int32)
        for g, rep in enumerate(reps):
            g_request[g] = pod_request_vec(rep).units
            nz = pod_nonzero_request_vec(rep)
            g_nonzero[g, 0] = nz[CPU_MILLI]
            g_nonzero[g, 1] = nz[MEM_MIB]
        # static per-(signature, node) masks & raw scores.  Signatures that
        # differ only in resources/ports/pod-labels interact with every
        # node IDENTICALLY, so the expensive per-node sweep is deduped by
        # the signature's node-interaction identity (node_name, selector,
        # node affinity, tolerations, QoS, controller ref, images): at
        # north scale ~512 signatures × 5k nodes collapses from 2.5M
        # Python iterations per segment to a handful of [N] sweeps —
        # the dominant host cost of build_static.  The sweep itself lives
        # in _node_static_cols; the rows survive ACROSS segments and waves
        # in NodeStaticRows, invalidated per dirty node column.
        static_ok = np.zeros((G, n_pad), dtype=bool)
        node_aff_raw = np.zeros((G, n_pad), dtype=np.int32)
        taint_intol_raw = np.zeros((G, n_pad), dtype=np.int32)
        static_score = np.zeros((G, n_pad), dtype=np.int32)
        # the controller ref only influences the sweep when some node's
        # prefer-avoid annotation NAMES its uid — precompute that uid set
        # once so unannotated clusters dedupe across controllers (keying
        # on every distinct ReplicaSet uid would fragment the cache)
        avoided_uids: set[str] = set()
        if prefer_avoid_weight:
            for info in infos:
                ann = info.node.meta.annotations.get(PREFER_AVOID_PODS_ANNOTATION, "")
                avoided_uids.update(u.strip() for u in ann.split(",") if u.strip())

        # cross-wave persistent rows: validate the cache against the node
        # axis and eagerly refresh dirty columns of every cached entry
        # (each entry recomputes with its interaction CLASS's keyed ref)
        rows_cache = self._node_rows

        def _refresh(entry, js):
            e_rep, e_be, e_ref, e_images, e_rows = entry
            _node_static_cols(e_rep, infos, js, e_be, e_ref, e_images,
                              prefer_avoid_weight, image_weight, *e_rows)

        rows_cache.sync(node_names, infos,
                        (prefer_avoid_weight, image_weight), _refresh)
        node_token = rows_cache.token()
        node_dirty = list(rows_cache.last_dirty)

        all_js = range(n_real)
        for g, rep in enumerate(reps):
            is_best_effort = rep.qos_class() == api.BEST_EFFORT
            ref = rep.meta.controller_ref()
            images = {c.image for c in rep.spec.containers if c.image}
            aff = rep.spec.affinity
            # the keyed ref: None unless some node's prefer-avoid
            # annotation names this controller (see _node_static_cols)
            keyed_ref = (ref if ref is not None and ref.uid in avoided_uids
                         else None)
            interaction_key = (
                rep.spec.node_name,
                tuple(sorted(rep.spec.node_selector.items()))
                if rep.spec.node_selector else (),
                repr(aff.node_affinity_required) if aff is not None else "",
                repr(aff.node_affinity_preferred) if aff is not None else "",
                tuple(sorted(repr(t) for t in rep.spec.tolerations)),
                is_best_effort,
                (keyed_ref.kind, keyed_ref.uid) if keyed_ref is not None else None,
                tuple(sorted(images)) if image_weight else (),
            )
            cached = rows_cache.get(interaction_key)
            if cached is not None:
                static_ok[g] = cached[0]
                node_aff_raw[g] = cached[1]
                taint_intol_raw[g] = cached[2]
                static_score[g] = cached[3]
                continue
            rows = (np.zeros(n_pad, dtype=bool), np.zeros(n_pad, dtype=np.int32),
                    np.zeros(n_pad, dtype=np.int32), np.zeros(n_pad, dtype=np.int32))
            _node_static_cols(rep, infos, all_js, is_best_effort, keyed_ref,
                              images, prefer_avoid_weight, image_weight, *rows)
            static_ok[g] = rows[0]
            node_aff_raw[g] = rows[1]
            taint_intol_raw[g] = rows[2]
            static_score[g] = rows[3]
            # the cache owns the row arrays: dirty-column syncs update them
            # in place, later gets return them directly
            rows_cache.put(interaction_key, rep, is_best_effort, keyed_ref,
                           images, rows)

        # inter-pod affinity interactions with EXISTING pods.  Phase-A batch
        # pods have no (anti)affinity terms of their own, but existing pods'
        # terms still act on them (the symmetry rules):
        #  - required anti-affinity of an existing pod matching the incoming
        #    pod FORBIDS its topology domain (predicates.go:1146) -> static_ok;
        #  - required/preferred affinity (+ preferred anti) of existing pods
        #    matching the incoming pod contribute interpod priority weight
        #    (interpod_affinity.go:160-186) -> interpod_raw.
        interpod_raw = np.zeros((G, n_pad), dtype=np.int32)
        # Existing pods' (anti)affinity terms, grouped by scheduling
        # signature: _pod_matches_term depends only on (candidate,
        # owner namespace, term) — identical for every pod of a
        # signature — so a template-stamped fleet collapses thousands of
        # per-pod matcher calls per segment into one per (rep, group,
        # term), with per-node instance COUNTS scaling the weights.
        # Contributions are bitwise identical (weights are additive).
        aff_groups: dict = {}  # sig -> [q_rep, {node_name|None: [qinfo, count]}]
        for qinfo in node_info_map.values():
            for q in qinfo.pods_with_affinity:
                sig = pod_signature_key(q)
                entry = aff_groups.get(sig)
                if entry is None:
                    entry = aff_groups[sig] = [q, {}]
                nkey = qinfo.node.meta.name if qinfo.node is not None else None
                loc = entry[1].get(nkey)
                if loc is None:
                    entry[1][nkey] = [qinfo, 1]
                else:
                    loc[1] += 1
        if aff_groups:
            # (topology key, value) -> weight accumulations per signature
            for g, rep in enumerate(reps):
                topo_weights: dict[tuple[str, str], int] = {}
                forbidden: list[tuple[str, str]] = []  # (key, value) domains

                def _add(node: Optional[api.Node], key: str, weight: int) -> None:
                    if node is None or not key:
                        return
                    value = node.meta.labels.get(key)
                    if value is None:
                        return
                    topo_weights[(key, value)] = topo_weights.get((key, value), 0) + weight

                for q_rep, locs in aff_groups.values():
                    qaff = q_rep.spec.affinity
                    for term in qaff.pod_anti_affinity_required:
                        if _pod_matches_term(rep, q_rep, term):
                            for qinfo, _cnt in locs.values():
                                qnode = qinfo.node
                                if qnode is not None and term.topology_key:
                                    value = qnode.meta.labels.get(term.topology_key)
                                    if value is not None:
                                        forbidden.append((term.topology_key, value))
                                else:
                                    forbidden.append(("", ""))  # malformed term: always blocks
                    if pctx.hard_pod_affinity_weight > 0:
                        for term in qaff.pod_affinity_required:
                            if _pod_matches_term(rep, q_rep, term):
                                for qinfo, cnt in locs.values():
                                    _add(qinfo.node, term.topology_key,
                                         pctx.hard_pod_affinity_weight * cnt)
                    for wt in qaff.pod_affinity_preferred:
                        if _pod_matches_term(rep, q_rep, wt.term):
                            for qinfo, cnt in locs.values():
                                _add(qinfo.node, wt.term.topology_key,
                                     wt.weight * cnt)
                    for wt in qaff.pod_anti_affinity_preferred:
                        if _pod_matches_term(rep, q_rep, wt.term):
                            for qinfo, cnt in locs.values():
                                _add(qinfo.node, wt.term.topology_key,
                                     -wt.weight * cnt)

                if topo_weights or forbidden:
                    # group by topology KEY before the node sweep: a node
                    # matches at most one value per key, so the sweep is
                    # one label get per key — the pairwise loop was
                    # O(placed-owners x N) under required-anti-affinity
                    # fan-out (one forbidden entry per placed owner) and
                    # dominated steady-state build_static
                    w_by_key: dict[str, dict[str, int]] = {}
                    for (key, value), w in topo_weights.items():
                        w_by_key.setdefault(key, {})[value] = w
                    forb_by_key: dict[str, set] = {}
                    always_block = False
                    for key, value in forbidden:
                        if not key:
                            always_block = True  # malformed term: blocks all
                        else:
                            forb_by_key.setdefault(key, set()).add(value)
                    if always_block:
                        static_ok[g, :] = False
                    for j, info in enumerate(infos):
                        labels = info.node.meta.labels
                        total = 0
                        for key, vmap in w_by_key.items():
                            w = vmap.get(labels.get(key))
                            if w:
                                total += w
                        interpod_raw[g, j] = total
                        if static_ok[g, j]:
                            for key, vals in forb_by_key.items():
                                if labels.get(key) in vals:
                                    static_ok[g, j] = False
                                    break

        # -- phase B: the batch's own (anti)affinity terms ------------------
        # Flatten every term carried by a signature into one table; empty
        # topology keys on REQUIRED terms make the owner statically
        # infeasible everywhere (predicates.go:1181 "empty topologyKey is
        # not allowed"), and soft terms with empty keys never contribute
        # (interpod_affinity.go add() skips them) so both drop from the
        # table after marking.
        terms: list[_AffinityTerm] = []
        hard_w = pctx.hard_pod_affinity_weight
        for g, rep in enumerate(reps):
            a = rep.spec.affinity
            if a is None:
                continue
            for t in a.pod_affinity_required:
                if not t.topology_key:
                    static_ok[g, :] = False
                    continue
                terms.append(_AffinityTerm(g, "RA", hard_w, t))
            for t in a.pod_anti_affinity_required:
                if not t.topology_key:
                    static_ok[g, :] = False
                    continue
                terms.append(_AffinityTerm(g, "RAA", 0, t))
            for wt in a.pod_affinity_preferred:
                if wt.term.topology_key:
                    terms.append(_AffinityTerm(g, "PA", wt.weight, wt.term))
            for wt in a.pod_anti_affinity_preferred:
                if wt.term.topology_key:
                    terms.append(_AffinityTerm(g, "PAA", -wt.weight, wt.term))
        T = self._bucket("terms", len(terms), self.term_multiple)  # padded rows stay inert

        term_matches_sig = np.zeros((T, G), dtype=bool)
        sym_w = np.zeros(T, dtype=np.int32)
        own_w = np.zeros((G, T), dtype=np.int32)
        own_ra = np.zeros((G, T), dtype=bool)
        own_raa = np.zeros((G, T), dtype=bool)
        own_all = np.zeros((G, T), dtype=bool)
        is_raa = np.zeros(T, dtype=bool)
        self_match = np.zeros(T, dtype=bool)
        for t, at in enumerate(terms):
            owner_rep = reps[at.owner]
            own_all[at.owner, t] = True
            for g, rep in enumerate(reps):
                term_matches_sig[t, g] = _pod_matches_term(rep, owner_rep, at.term)
            self_match[t] = term_matches_sig[t, at.owner]
            if at.kind == "RA":
                own_ra[at.owner, t] = True
                sym_w[t] = at.weight
            elif at.kind == "RAA":
                own_raa[at.owner, t] = True
                is_raa[t] = True
            else:  # PA / PAA soft terms
                own_w[at.owner, t] = at.weight
                sym_w[t] = at.weight

        # topology domains: per distinct key, enumerate label values over the
        # node axis once; each term gets its own global domain-id range so
        # the flat [D+1] count arrays stay per-term (last slot = trash for
        # nodes missing the key — never read unmasked)
        key_vals: dict[str, tuple[np.ndarray, int]] = {}
        for at in terms:
            key = at.term.topology_key
            if key in key_vals:
                continue
            vocab: dict[str, int] = {}
            arr = np.full(n_pad, -1, dtype=np.int32)
            for j, info in enumerate(infos):
                v = info.node.meta.labels.get(key)
                if v is not None:
                    arr[j] = vocab.setdefault(v, len(vocab))
            key_vals[key] = (arr, len(vocab))
        node_domain = np.zeros((T, n_pad), dtype=np.int32)
        dom_valid = np.zeros((T, n_pad), dtype=bool)
        offset = 0
        for t, at in enumerate(terms):
            arr, count = key_vals[at.term.topology_key]
            dom_valid[t] = arr >= 0
            node_domain[t] = np.where(arr >= 0, offset + arr, 0)  # trash fixed below
            offset += count
        trash = offset
        node_domain[~dom_valid] = trash
        if not terms:
            dom_valid[:] = False
            node_domain[:] = trash

        # -- phase B: volumes (per-pod slot lists) --------------------------
        # Volume identity lives on the pod axis, not the signature axis:
        # each pod gets <= W slots pointing into the [V, N] occupancy arrays.
        K = len(_VOL_KINDS)
        # volume-SLOT axis tightening: size the per-pod slot axis to the
        # segment's real maximum (power-of-two, sticky so the compiled
        # [W, N] shapes never shrink mid-run) instead of the worst-case
        # vols_per_pod.  Slots past a pod's real disks are invalid on
        # every pod, so the kernel's per-step [W, N] gathers and the
        # commit scatter shrink with zero semantic change (vols_per_pod
        # stays the segmentation budget bound).
        w_nat = 1
        while w_nat < max(w_used, 1):
            w_nat *= 2
        W = max(min(self._sticky_pad("volslots", w_nat), self.vols_per_pod),
                w_used)
        P = len(pods)
        vol_vocab: dict[tuple[str, str], int] = {}
        pod_vol_ids = np.zeros((P, W), dtype=np.int32)
        pod_vol_valid = np.zeros((P, W), dtype=bool)
        pod_vol_ro_ok = np.zeros((P, W), dtype=bool)
        pod_vol_kind = np.zeros((P, W), dtype=np.int32)
        any_count_only = False
        for i, pod in enumerate(pods):
            vol_refs = _disk_refs(pod)  # raw-first: no [P]-wide spec decode
            if not vol_refs:
                continue
            per_pod: dict[tuple[str, str], bool] = {}  # all-refs-read-only
            for kind, disk_id, read_only in vol_refs:
                key = (kind, disk_id)
                per_pod[key] = per_pod.get(key, True) and read_only
            for s, (key, all_ro) in enumerate(per_pod.items()):
                if key in conflict_vols:
                    v = vol_vocab.setdefault(key, len(vol_vocab))
                    pod_vol_ids[i, s] = v
                else:
                    # count-only: no conflict identity — reads the
                    # always-empty sentinel row (never blocked, always
                    # "new" for MaxVolumeCount) and is excluded from the
                    # occupancy write (kernel masks it out)
                    pod_vol_ids[i, s] = -1  # fixed up to sentinel below
                    any_count_only = True
                pod_vol_valid[i, s] = True
                pod_vol_ro_ok[i, s] = all_ro and key[0] in _READONLY_SHARED_KINDS
                pod_vol_kind[i, s] = (
                    _VOL_KINDS.index(key[0]) if key[0] in VOLUME_COUNT_LIMITS else K
                )
        # volume-less segments keep a tiny (never-touched) state footprint;
        # the kernel's use_vols flag skips the volume logic entirely.
        # The vocab holds conflict-capable disks only, so its bucketed pad
        # is small and stable across random workload mixes — shape-bucket
        # stability is what lets one warm-up compile cover every segment.
        use_vols = bool(vol_vocab) or any_count_only
        v_state = self._sticky_pad(
            "vols",
            8 if not vol_vocab else _pad_to(len(vol_vocab) + 1, self.vol_multiple))
        pod_vol_count_only = pod_vol_valid & (pod_vol_ids < 0)
        pod_vol_ids[~pod_vol_valid | pod_vol_count_only] = v_state - 1  # sentinel row
        vol_limits = np.array([VOLUME_COUNT_LIMITS[k] for k in _VOL_KINDS], dtype=np.int32)

        # PVC-backed volumes: zone / PV-node-affinity constraints are static
        # per (signature, node) — PVC↔PV bindings do not change mid-batch —
        # so they fold into static_ok (oracle: no_volume_zone_conflict /
        # no_volume_node_conflict, predicates.go:402,1323)
        # kernel: implements NoVolumeZoneConflict, NoVolumeNodeConflict
        for g, rep in enumerate(reps):
            pvc_vols = [v for v in rep.spec.volumes if v.pvc_name]
            if not pvc_vols:
                continue
            pv_zones: list[str] = []
            pv_sels: list = []
            unresolved = False
            for vol in pvc_vols:
                pvc = pctx.pvcs.get(f"{rep.meta.namespace}/{vol.pvc_name}")
                pv = pctx.pvs.get(pvc.volume_name) if pvc is not None and pvc.volume_name else None
                if pv is None:
                    unresolved = True
                    break
                if pv.zone:
                    pv_zones.append(pv.zone)
                if pv.node_affinity is not None:
                    pv_sels.append(pv.node_affinity)
            if unresolved:
                static_ok[g, :] = False
                continue
            if pv_zones or pv_sels:
                for j, info in enumerate(infos):
                    if not static_ok[g, j]:
                        continue
                    labels = info.node.meta.labels
                    node_zone_label = labels.get(api.ZONE_LABEL, "")
                    if any(z != node_zone_label for z in pv_zones):
                        static_ok[g, j] = False
                        continue
                    if any(not sel.matches(labels) for sel in pv_sels):
                        static_ok[g, j] = False

        # spreading: selectors per signature; inc matrix between signatures
        ssp = SelectorSpreadPriority()
        g_selectors = [ssp._selectors_for_pod(rep, pctx) for rep in reps]
        g_has_spread = np.array([len(s) > 0 for s in g_selectors], dtype=bool)
        spread_inc = np.zeros((G, G), dtype=np.int32)
        for g in range(G):
            if not g_has_spread[g]:
                continue
            for h in range(G):
                if reps[h].meta.namespace != reps[g].meta.namespace:
                    continue
                if ssp._matches_any(g_selectors[g], reps[h]):
                    spread_inc[g, h] = 1

        # -- bucket-pad the signature axis ----------------------------------
        # Padded rows are never referenced (group_of_pod < G) but keep the
        # compiled kernel's shapes stable across batches.
        Gp = self._bucket("groups", G, self.group_multiple)
        if Gp != G:
            pad_g = Gp - G
            static_ok = np.pad(static_ok, ((0, pad_g), (0, 0)))
            node_aff_raw = np.pad(node_aff_raw, ((0, pad_g), (0, 0)))
            taint_intol_raw = np.pad(taint_intol_raw, ((0, pad_g), (0, 0)))
            static_score = np.pad(static_score, ((0, pad_g), (0, 0)))
            interpod_raw = np.pad(interpod_raw, ((0, pad_g), (0, 0)))
            g_request = np.pad(g_request, ((0, pad_g), (0, 0)))
            g_nonzero = np.pad(g_nonzero, ((0, pad_g), (0, 0)))
            g_ports = np.pad(g_ports, ((0, pad_g), (0, 0)))
            g_has_spread = np.pad(g_has_spread, (0, pad_g))
            spread_inc = np.pad(spread_inc, ((0, pad_g), (0, pad_g)))
            term_matches_sig = np.pad(term_matches_sig, ((0, 0), (0, pad_g)))
            own_w = np.pad(own_w, ((0, pad_g), (0, 0)))
            own_ra = np.pad(own_ra, ((0, pad_g), (0, 0)))
            own_raa = np.pad(own_raa, ((0, pad_g), (0, 0)))
            own_all = np.pad(own_all, ((0, pad_g), (0, 0)))

        return BatchStatic(
            node_names=node_names,
            n_pad=n_pad,
            node_exists=node_exists,
            node_alloc=node_alloc,
            node_alloc_pods=node_alloc_pods,
            node_zone=node_zone,
            num_zones=num_zones,
            group_of_pod=group_of_pod,
            pod_names=[p.meta.key for p in pods],
            static_ok=static_ok,
            node_aff_raw=node_aff_raw,
            taint_intol_raw=taint_intol_raw,
            static_score=static_score,
            g_request=g_request,
            g_nonzero=g_nonzero,
            g_ports=g_ports,
            port_vocab=list(port_vocab),
            g_has_spread=g_has_spread,
            spread_inc=spread_inc,
            interpod_raw=interpod_raw,
            terms=terms,
            term_matches_sig=term_matches_sig,
            sym_w=sym_w,
            own_w=own_w,
            own_ra=own_ra,
            own_raa=own_raa,
            own_all=own_all,
            is_raa=is_raa,
            self_match=self_match,
            node_domain=node_domain,
            dom_valid=dom_valid,
            vol_vocab=list(vol_vocab),
            v_state=v_state,
            pod_vol_ids=pod_vol_ids,
            pod_vol_valid=pod_vol_valid,
            pod_vol_ro_ok=pod_vol_ro_ok,
            pod_vol_kind=pod_vol_kind,
            pod_vol_count_only=pod_vol_count_only,
            use_vols=use_vols,
            vol_limits=vol_limits,
            node_token=node_token,
            node_dirty=node_dirty,
            use_ports=bool(port_vocab),
            weights={
                "least": least_requested_weight,
                "most": most_requested_weight,
                "balanced": balanced_weight,
                "spread": spread_weight,
                "node_affinity": node_affinity_weight,
                "taint": taint_weight,
                "interpod": interpod_weight,
            },
        )

    # -- dynamic state -----------------------------------------------------
    def initial_state(
        self,
        static: BatchStatic,
        node_info_map: dict[str, NodeInfo],
        pctx: PriorityContext,
        pods: list[api.Pod],
        round_robin: int = 0,
        host_state: Optional[HostBatchState] = None,
    ) -> InitialState:
        n_pad = static.n_pad
        G = static.static_ok.shape[0]
        requested = np.zeros((n_pad, NUM_RESOURCES), dtype=np.int32)
        nonzero = np.zeros((n_pad, 2), dtype=np.int32)
        pod_count = np.zeros(n_pad, dtype=np.int32)
        ports_used = np.zeros((n_pad, static.g_ports.shape[1]), dtype=bool)
        port_idx = {p: i for i, p in enumerate(static.port_vocab)}
        spread_counts = np.zeros((G, n_pad), dtype=np.int32)

        ssp = SelectorSpreadPriority()
        # representative pod per group for selector extraction
        reps: dict[int, api.Pod] = {}
        for i, gid in enumerate(static.group_of_pod):
            reps.setdefault(int(gid), pods[i])
        g_selectors = {g: ssp._selectors_for_pod(rep, pctx) for g, rep in reps.items()}

        for j, name in enumerate(static.node_names):
            info = node_info_map[name]
            requested[j] = info.requested.units
            nonzero[j, 0] = info.nonzero_requested[CPU_MILLI]
            nonzero[j, 1] = info.nonzero_requested[MEM_MIB]
            pod_count[j] = len(info.pods)
            for port in info.used_ports:
                if port in port_idx:
                    ports_used[j, port_idx[port]] = True

        # existing matching-pod counts per spread group and per affinity
        # term (zone sums are recomputed in-step from these, over the
        # feasible mask).  This is (groups + terms) x existing-pods selector
        # matching, deduplicated by interned labelmap content in the match
        # engine; namespace scoping rides along as a reserved pseudo-label.
        groups_with_sels = {g: sels for g, sels in g_selectors.items() if sels}
        T = static.term_matches_sig.shape[0]
        # per-term flat domain counts, expanded to [T, N] after the fill
        # (trash id = node_domain.max() where the key is absent — its counts
        # vanish in the expansion because dom_valid masks them)
        n_dom = int(static.node_domain.max()) + 1 if static.terms else 1
        dom_match = np.zeros(n_dom, dtype=np.int32)
        total_match = np.zeros(T, dtype=np.int32)
        matchable_terms = [
            (t, at) for t, at in enumerate(static.terms) if at.term.selector is not None
        ]
        if groups_with_sels or matchable_terms:
            # the engine + labelmap corpus: batch-persistent when a
            # HostBatchState is supplied (selectors are per-segment either
            # way); scratch-built and torn down otherwise
            if host_state is not None:
                eng = host_state.eng
                add_selector = host_state.selector_id
            else:
                eng = MatchEngine()
                add_selector = eng.add_selector
            NS_KEY = _NS_KEY
            sel_ids: dict[int, list[int]] = {}
            for g, sels in groups_with_sels.items():
                ns_req = (NS_KEY, "Eq", [reps[g].meta.namespace])
                ids = []
                for kind, sel in sels:
                    if kind == "simple":
                        reqs = [ns_req] + [(k, "Eq", [str(v)]) for k, v in sel.items()]
                    else:
                        reqs = (
                            [ns_req]
                            + [(k, "Eq", [str(v)]) for k, v in sel.match_labels.items()]
                            + [(r.key, r.operator, list(r.values)) for r in sel.match_expressions]
                        )
                    ids.append(add_selector(reqs))
                sel_ids[g] = ids
            # one selector per affinity term: namespace-scope ∈ term
            # namespaces (empty → owner's namespace) AND the term selector
            term_sids: list[int] = []
            for t, at in matchable_terms:
                namespaces = at.term.namespaces or [reps[at.owner].meta.namespace]
                sel = at.term.selector
                reqs = (
                    [(NS_KEY, "In", [str(n) for n in namespaces])]
                    + [(k, "Eq", [str(v)]) for k, v in sel.match_labels.items()]
                    + [(r.key, r.operator, list(r.values)) for r in sel.match_expressions]
                )
                term_sids.append(add_selector(reqs))
            if host_state is not None:
                pod_lids = host_state.pod_lids
                node_j = host_state.node_j_array()
            else:
                pod_lids = []
                pod_node_j: list[int] = []
                for j, name in enumerate(static.node_names):
                    for q in node_info_map[name].pods:
                        pod_lids.append(
                            eng.add_labelmap({**q.meta.labels, NS_KEY: q.meta.namespace})
                        )
                        pod_node_j.append(j)
                node_j = np.asarray(pod_node_j, dtype=np.int64)
            if pod_lids:
                # content-interned lids repeat heavily (template-stamped
                # pods share one labelmap), so match each DISTINCT lid
                # once and broadcast: probes go from O(L × sels)
                # to O(distinct × sels) + numpy O(L)
                lids_arr = np.asarray(pod_lids, dtype=np.int64)
                uniq, inverse = np.unique(lids_arr, return_inverse=True)
                for g, ids in sel_ids.items():
                    hits = eng.match_any(ids, uniq)[inverse]
                    np.add.at(spread_counts[g], node_j[hits], 1)
                if matchable_terms:
                    tm = eng.match_matrix(term_sids, uniq)  # [T_real, U]
                    for row, (t, _at) in enumerate(matchable_terms):
                        hits = tm[row][inverse]
                        total_match[t] = int(hits.sum())
                        np.add.at(dom_match, static.node_domain[t, node_j[hits]], 1)
            if host_state is None:
                eng.close()
        dm = (dom_match[static.node_domain] * static.dom_valid).astype(np.int32)

        # volume occupancy from existing pods: instance presence and
        # non-sharable presence per batch-vocab volume, plus distinct
        # limited-kind disk counts per node (NoDiskConflict /
        # MaxVolumeCount dynamic state)
        V = static.v_state
        K = len(_VOL_KINDS)
        vol_any = np.zeros((V, n_pad), dtype=bool)
        vol_ns = np.zeros((V, n_pad), dtype=bool)
        nk = np.zeros((K, n_pad), dtype=np.int32)
        if host_state is not None:
            # O(vocab): the disk-location dicts already aggregate the world
            for v, key in enumerate(static.vol_vocab):
                for j, rc in host_state.disk_locations.get(key, {}).items():
                    vol_any[v, j] = True
                    if rc[1] > 0:
                        vol_ns[v, j] = True
            nk[:, : host_state.nk_counts.shape[1]] = host_state.nk_counts
        else:
            vol_idx = {key: v for v, key in enumerate(static.vol_vocab)}
            kind_pos = {k: i for i, k in enumerate(_VOL_KINDS)}
            for j, name in enumerate(static.node_names):
                seen: dict[str, set] = {}
                for q in node_info_map[name].pods:
                    if not q.spec.volumes:
                        continue
                    for vol in q.spec.volumes:
                        if not vol.disk_id:
                            continue
                        if vol.disk_kind in kind_pos:
                            seen.setdefault(vol.disk_kind, set()).add(vol.disk_id)
                        v = vol_idx.get((vol.disk_kind, vol.disk_id))
                        if v is not None:
                            vol_any[v, j] = True
                            if not (vol.disk_kind in _READONLY_SHARED_KINDS and vol.read_only):
                                vol_ns[v, j] = True
                for kind, ids in seen.items():
                    nk[kind_pos[kind], j] = len(ids)

        return InitialState(
            requested=requested,
            nonzero_requested=nonzero,
            pod_count=pod_count,
            ports_used=ports_used,
            spread_counts=spread_counts,
            round_robin=round_robin,
            dm=dm,
            downer=np.zeros((T, n_pad), dtype=np.int32),
            total_match=total_match,
            vol_any=vol_any,
            vol_ns=vol_ns,
            nk=nk,
        )
