"""The oracle scheduling algorithm: filter → score → select.

Capability of ``plugin/pkg/scheduler/core/generic_scheduler.go``:
``Schedule :88`` = snapshot → ``findNodesThatFit :163`` →
``PrioritizeNodes :285`` → ``selectHost :144``.

This is the sequential-greedy CPU oracle the batch backend must match
binding-for-binding.  Its determinism spec (shared with the kernels):

- nodes are evaluated in **sorted-by-name order** (the canonical node axis
  order, also the tensor row order);
- ``select_host`` breaks score ties round-robin with a persistent counter
  over the tied nodes in node-axis order (reference ``lastNodeIndex``);
- all scores are fixed-point integers (see ``priorities.py``), so
  argmax+tiebreak is exact on both paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api import types as api
from .nodeinfo import NodeInfo
from .predicates import (
    DEFAULT_PREDICATES,
    PredicateContext,
    compute_metadata,
    fast_fit_nodes,
    pod_fits_on_node,
)
from .priorities import PriorityContext, default_priorities


class FitError(Exception):
    """No node fits (reference core/generic_scheduler.go:46 FitError)."""

    def __init__(self, pod: api.Pod, failed_predicates: dict[str, list[str]]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        super().__init__(
            f"pod {pod.meta.key} failed to fit on {len(failed_predicates)} node(s)"
        )


@dataclass
class ScheduleResult:
    node_name: str
    feasible_nodes: int
    evaluated_nodes: int
    scores: dict[str, int] = field(default_factory=dict)


class GenericScheduler:
    def __init__(
        self,
        predicates=None,
        priorities=None,
        extenders: Optional[list] = None,
    ):
        self.predicates = predicates if predicates is not None else dict(DEFAULT_PREDICATES)
        self.priorities = priorities if priorities is not None else default_priorities()
        self.extenders = extenders or []
        self._round_robin = 0  # selectHost tie-break counter (lastNodeIndex)

    # -- the three phases --------------------------------------------------
    def find_nodes_that_fit(
        self,
        pod: api.Pod,
        node_names: list[str],
        node_info_map: dict[str, NodeInfo],
        ctx: PredicateContext,
    ) -> tuple[list[str], dict[str, list[str]]]:
        """(``:163``) feasibility over the node axis.  The reference
        parallelizes with 16 workers (P1); the oracle stays sequential —
        the node axis is exactly what the device scan vectorizes instead."""
        meta = compute_metadata(pod, ctx)
        if self.predicates == DEFAULT_PREDICATES:
            from ..models.snapshot import pod_signature_key

            # fused inline pass — identical feasibility, first-fail reasons
            # the sig key engages the per-NodeInfo equivalence cache
            feasible, failures = fast_fit_nodes(
                pod, meta, node_names, node_info_map, ctx,
                sig_key=pod_signature_key(pod),
            )
        else:
            feasible = []
            failures = {}
            for name in node_names:
                ok, reasons = pod_fits_on_node(
                    pod, meta, node_info_map[name], ctx, self.predicates
                )
                if ok:
                    feasible.append(name)
                else:
                    failures[name] = reasons
        for ext in self.extenders:
            if not feasible:
                break
            feasible, ext_failures = ext.filter(pod, feasible)
            failures.update(ext_failures)
        return feasible, failures

    def prioritize_nodes(
        self,
        pod: api.Pod,
        feasible: list[str],
        node_info_map: dict[str, NodeInfo],
        pctx: PriorityContext,
    ) -> list[tuple[str, int]]:
        """(``:285``) integer weighted sum of per-priority 0..10 scores."""
        infos = [node_info_map[n] for n in feasible]
        totals = [0] * len(feasible)
        for prio, weight in self.priorities:
            scores = prio.compute_all(pod, infos, pctx)
            for i, s in enumerate(scores):
                totals[i] += weight * s
        for ext in self.extenders:
            ext_scores = ext.prioritize(pod, feasible)
            for i, s in enumerate(ext_scores):
                totals[i] += s
        return list(zip(feasible, totals))

    def select_host(self, priority_list: list[tuple[str, int]]) -> str:
        """(``:144``) argmax with round-robin tie-break in node-axis order."""
        if not priority_list:
            raise ValueError("empty priority list")
        max_score = max(s for _, s in priority_list)
        ties = [n for n, s in priority_list if s == max_score]
        idx = self._round_robin % len(ties)
        self._round_robin += 1
        return ties[idx]

    # -- entry point -------------------------------------------------------
    def schedule(
        self,
        pod: api.Pod,
        node_info_map: dict[str, NodeInfo],
        pctx: Optional[PriorityContext] = None,
    ) -> ScheduleResult:
        node_names = sorted(n for n, i in node_info_map.items() if i.node is not None)
        if not node_names:
            raise FitError(pod, {})
        pctx = pctx or PriorityContext(node_info_map)
        ctx = PredicateContext(node_info_map, pvcs=pctx.pvcs, pvs=pctx.pvs,
                               services=pctx.services)
        feasible, failures = self.find_nodes_that_fit(pod, node_names, node_info_map, ctx)
        if not feasible:
            raise FitError(pod, failures)
        if len(feasible) == 1:
            return ScheduleResult(feasible[0], 1, len(node_names))
        prioritized = self.prioritize_nodes(pod, feasible, node_info_map, pctx)
        host = self.select_host(prioritized)
        return ScheduleResult(
            host, len(feasible), len(node_names), scores=dict(prioritized)
        )
