"""Priority preemption: make room for important pods by evicting less
important ones.

The reference has NO scheduler preemption (SURVEY.md §2.4 known-absent;
only kubelet critical-pod preemption exists, ``preemption.go:66``) but
BASELINE.json demands the modern ``DefaultPreemption`` PostFilter
capability, so this is designed fresh rather than ported:

- candidate nodes: where the pod would fit if every strictly-lower-priority
  pod were gone (a vectorizable mask — ``ops/preemption_kernel`` computes
  it over the node axis for whole failed cohorts);
- per-candidate victim selection: start from "all lower-priority pods
  evicted", then *reprieve* victims back highest-priority-first while the
  pod still fits — yielding a minimal victim set biased toward sparing
  important pods;
- node choice (deterministic spec): (1) lowest maximum victim priority,
  (2) fewest victims, (3) smallest total victim request, (4) node order.

Two execution paths share ``_evaluate_node`` (the exact per-node victim
selection), so their decisions are identical by construction:

- ``find_preemption_target``: the oracle — evaluate every node (the
  correctness reference, and the fallback when no prefilter state is
  available);
- ``find_preemption_target_fast``: evaluate only prefiltered candidates
  in ascending bound order (branch-and-bound).  The prefilter bound —
  the smallest priority level v such that evicting every pod with
  priority < v frees enough *resources* — is a true lower bound on the
  exact max-victim-priority (any feasible victim set must free enough
  resources, and resources are monotone in eviction even where affinity
  is not), so stopping once ``bound > best.max_prio`` provably never
  changes the chosen target.

Execution model: victims are deleted through the API (the disruption-aware
eviction subresource when it lands), the preemptor is requeued immediately
with its backoff reset — in this store victims vanish synchronously, so
the retry schedules into the freed space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api import types as api
from .nodeinfo import NodeInfo
from .predicates import (
    DEFAULT_PREDICATES,
    PredicateContext,
    compute_metadata,
    pod_fits_on_node,
)
from .units import (
    CPU_MILLI,
    GPU_COUNT,
    MEM_MIB,
    NUM_RESOURCES,
    STORAGE_MIB,
    pod_request_vec,
)


@dataclass
class PreemptionTarget:
    node_name: str
    victims: list[api.Pod]


def _fits_without(pod, meta, info: NodeInfo, removed: list[api.Pod], ctx, predicates) -> bool:
    """Feasibility of `pod` on `info` with `removed` pods taken out."""
    trial = info.clone()
    for v in removed:
        trial.remove_pod(v)
    ok, _ = pod_fits_on_node(pod, meta, trial, ctx, predicates)
    return ok


def _evaluate_node(
    pod: api.Pod, meta, name: str, info: NodeInfo, ctx, predicates
) -> Optional[tuple[tuple, PreemptionTarget]]:
    """Exact victim selection on ONE node (None if preemption there cannot
    make the pod schedulable).  Returns (rank, target); rank is the
    deterministic node-choice key."""
    lower = [q for q in info.pods if q.spec.priority < pod.spec.priority]
    if not lower:
        return None
    if not _fits_without(pod, meta, info, lower, ctx, predicates):
        return None  # even evicting everything below doesn't help
    # reprieve loop: starting from "evict all", try to re-admit victims
    # highest-priority-first; whoever cannot be re-admitted stays a victim
    victims = sorted(lower, key=lambda q: (-q.spec.priority, q.meta.key))
    for q in list(victims):
        trial = [v for v in victims if v is not q]
        if _fits_without(pod, meta, info, trial, ctx, predicates):
            victims = trial  # q reprieved
    if not victims:
        return None  # nothing actually needed evicting (shouldn't happen)
    max_prio = max(v.spec.priority for v in victims)
    total_req = [0] * NUM_RESOURCES
    for v in victims:
        vec = pod_request_vec(v)
        for r in range(NUM_RESOURCES):
            total_req[r] += vec[r]
    rank = (max_prio, len(victims), sum(total_req), name)
    return rank, PreemptionTarget(node_name=name, victims=victims)


def find_preemption_target(
    pod: api.Pod,
    node_info_map: dict[str, NodeInfo],
    predicates=None,
    pvcs=None,
    pvs=None,
) -> Optional[PreemptionTarget]:
    """The oracle: exact evaluation over EVERY node."""
    ctx = PredicateContext(node_info_map, pvcs=pvcs, pvs=pvs)
    meta = compute_metadata(pod, ctx)
    candidates: list[tuple[tuple, PreemptionTarget]] = []
    for name in sorted(n for n, i in node_info_map.items() if i.node is not None):
        got = _evaluate_node(pod, meta, name, node_info_map[name], ctx, predicates)
        if got is not None:
            candidates.append(got)
    if not candidates:
        return None
    candidates.sort(key=lambda t: t[0])
    return candidates[0][1]


def _fast_eligible(pod: api.Pod, predicates) -> bool:
    """True when every victim-DEPENDENT predicate for this preemptor is
    exactly {resources, pod count}: no host ports, no volumes, no own
    required (anti)affinity pod terms, no pinned nodeName, default
    predicate set.  All other default predicates read only node-static
    facts or the pre-eviction metadata, so the reprieve loop's
    per-trial ``pod_fits_on_node`` collapses to prefix arithmetic."""
    if predicates is not None and (
        set(predicates.keys()) != set(DEFAULT_PREDICATES.keys())
        # identity, not just names: a custom predicate registered under a
        # default key must not be silently skipped by the arithmetic path
        or any(predicates[k] is not DEFAULT_PREDICATES[k] for k in predicates)
    ):
        return False
    if pod.spec.node_name or pod.spec.volumes:
        return False
    if pod.host_ports():
        return False
    a = pod.spec.affinity
    if a is not None and (a.pod_affinity_required or a.pod_anti_affinity_required):
        return False
    return True


_CHECKED_SLOTS = (CPU_MILLI, MEM_MIB, STORAGE_MIB, GPU_COUNT)


def _greedy_rank(
    pod: api.Pod, meta, name: str, info: NodeInfo,
    vec_cache: Optional[dict] = None,
) -> Optional[tuple[tuple, list[api.Pod]]]:
    """Exact (rank, victims) for a fast-eligible preemptor — the closed
    form of ``_evaluate_node``'s reprieve loop when every victim-dependent
    check is resources+count: same victim order, same reprieve decisions,
    no NodeInfo clones.  Excludes only the node-static gate (checked once
    by the caller on the winner)."""
    p = pod.spec.priority
    lower = [q for q in info.pods if q.spec.priority < p]
    if not lower:
        return None
    req = meta.pod_request
    need = [(s, info.requested[s] + req[s] - info.allocatable[s])
            for s in _CHECKED_SLOTS if req[s] > 0]
    need_cnt = len(info.pods) + 1 - info.allocatable_pods
    if vec_cache is None:
        vecs = [pod_request_vec(q) for q in lower]
    else:
        # cohort-scoped memo: the same resident pods are re-ranked for
        # every preemptor of the cohort, and the quantity re-parse was
        # the dominant cost at fleet scale.  Entries hold the pod object
        # so id() keys stay unique for the cache's lifetime.
        vecs = []
        for q in lower:
            hit = vec_cache.get(id(q))
            if hit is None:
                hit = vec_cache[id(q)] = (q, pod_request_vec(q))
            vecs.append(hit[1])
    freed = {s: sum(v[s] for v in vecs) for s, _ in need}
    if any(freed[s] < n for s, n in need) or len(lower) < need_cnt:
        return None  # even evicting everything below doesn't free enough
    order = sorted(range(len(lower)),
                   key=lambda i: (-lower[i].spec.priority, lower[i].meta.key))
    victim = [True] * len(lower)
    nvict = len(lower)
    for i in order:
        v = vecs[i]
        if nvict - 1 >= need_cnt and all(freed[s] - v[s] >= n for s, n in need):
            victim[i] = False  # reprieved
            nvict -= 1
            for s, _ in need:
                freed[s] -= v[s]
    victims = [lower[i] for i in range(len(lower)) if victim[i]]
    if not victims:
        return None
    max_prio = max(v.spec.priority for v in victims)
    total = sum(sum(vecs[i].units) for i in range(len(lower)) if victim[i])
    return (max_prio, len(victims), total, name), victims


def find_preemption_target_fast(
    pod: api.Pod,
    node_info_map: dict[str, NodeInfo],
    candidates: list[tuple[int, str]],
    predicates=None,
    pvcs=None,
    pvs=None,
    static_cache: Optional[dict] = None,
    vec_cache: Optional[dict] = None,
    state=None,
    recheck_nodes: Optional[list] = None,
) -> Optional[PreemptionTarget]:
    """Exact selection over PREFILTERED candidates.

    ``candidates``: (bound, node_name) pairs from
    ``ops.preemption_kernel`` — bound is the resource-only lower bound on
    the node's max victim priority; the list must contain every node the
    oracle could pick (the prefilter keeps all resource-feasible nodes).

    Fast-eligible preemptors (the common template-stamped case) get exact
    ranks for every candidate from ``_greedy_rank`` prefix arithmetic and
    walk them in rank order, paying the full-predicate node-static gate
    (one clone) only until the first pass — with ``static_cache``
    memoizing that gate per node across a cohort of same-signature
    preemptors.  Everyone else gets branch-and-bound over
    ``_evaluate_node``: ascending (bound, name) order, stopping once no
    remaining bound can beat or tie the best exact criterion (1).
    Either way the chosen target equals ``find_preemption_target``'s.
    """
    ctx = PredicateContext(node_info_map, pvcs=pvcs, pvs=pvs)
    meta = compute_metadata(pod, ctx)

    if recheck_nodes:
        # earlier cohort evictions freed space on exactly these nodes —
        # the only ones that can have become feasible since the batch
        # proved this pod unschedulable.  Entries are (name, shadow_info)
        # where the shadow carries BOTH the evictions and the claims of
        # previously-granted cohort members (otherwise every preemptor
        # double-claims the same freed capacity).  A full-predicate fit
        # there means NO eviction is needed: signalled by empty victims;
        # the caller records the claim in the shadow.
        for name, info in recheck_nodes:
            if info is None or info.node is None:
                continue
            fits, _ = pod_fits_on_node(pod, meta, info, ctx, predicates)
            if fits:
                return PreemptionTarget(node_name=name, victims=[])

    if _fast_eligible(pod, predicates):
        if state is not None:
            # vectorized exact ranks over ALL nodes at once (the
            # ops/preemption_kernel greedy): rank order assembled by
            # lexsort, victims materialized only for gate-checked winners
            import numpy as np

            ok, max_prio, n_vict, total, victim = state.rank_arrays(
                meta.pod_request.units, pod.spec.priority, node_info_map)
            idx = np.flatnonzero(ok)
            # node_names is sorted, so index order IS the name tie-break
            order = idx[np.lexsort((idx, total[idx], n_vict[idx],
                                    max_prio[idx]))]
            ranked = (
                ((int(max_prio[j]), int(n_vict[j]), int(total[j]),
                  state.node_names[j]),
                 [q for c, q in enumerate(state.pp_pods[j])
                  if victim[j, c]])
                for j in order
            )
        else:
            got_all = []
            for _, name in candidates:
                info = node_info_map.get(name)
                if info is None or info.node is None:
                    continue
                got = _greedy_rank(pod, meta, name, info, vec_cache)
                if got is not None:
                    got_all.append(got)
            got_all.sort(key=lambda t: t[0])
            ranked = iter(got_all)
        for rank, victims in ranked:
            name = rank[3]
            info = node_info_map.get(name)
            if info is None or info.node is None:
                continue  # vanished mid-cohort (stale state row)
            ok = None
            if static_cache is not None:
                hit = static_cache.get(name)
                # generation-checked: a node whose pods/labels moved since
                # the gate ran re-evaluates (evictions bump the generation,
                # but the gate's resource part is re-proven by _greedy_rank,
                # and its static part only depends on the node object —
                # still, stale entries must never outlive a node UPDATE)
                if hit is not None and hit[0] == info.generation:
                    ok = hit[1]
            if ok is None:
                lower = [q for q in info.pods if q.spec.priority < pod.spec.priority]
                ok = _fits_without(pod, meta, info, lower, ctx, predicates)
                if static_cache is not None:
                    static_cache[name] = (info.generation, ok)
            if ok:
                return PreemptionTarget(node_name=name, victims=victims)
        return None

    best: Optional[tuple[tuple, PreemptionTarget]] = None
    for bound, name in sorted(candidates):
        if best is not None and bound > best[0][0]:
            break  # no remaining candidate can beat or tie criterion (1)
        info = node_info_map.get(name)
        if info is None or info.node is None:
            continue
        got = _evaluate_node(pod, meta, name, info, ctx, predicates)
        if got is not None and (best is None or got[0] < best[0]):
            best = got
    return best[1] if best else None
