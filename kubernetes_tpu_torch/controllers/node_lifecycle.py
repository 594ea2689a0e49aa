"""Node lifecycle controller: failure detection and pod eviction.

Capability of ``pkg/controller/node`` (3,192 LoC;
``node_controller.go:189,468 monitorNodeStatus``, zone-aware eviction
queues in ``node/scheduler/rate_limited_queue.go``, ``zoneStates :170``):

- kubelet heartbeats refresh the Ready condition; staleness past
  ``grace_period`` marks the node Unknown (the controller, not the
  kubelet, declares death — level-triggered from observed state);
- pods on dead nodes are evicted (deleted) after ``pod_eviction_timeout``
  through a **per-zone token bucket**, with the reference's zone-outage
  damping: when more than ``unhealthy_zone_threshold`` of a zone is down,
  the zone is treated as partitioned and evictions slow/stop — a network
  partition must not mass-delete every workload (SURVEY.md §5.2).

Driven by an explicit ``monitor()`` tick with an injected clock, so every
timing behavior is deterministic under test (the reference's fake-clock
pattern)."""

from __future__ import annotations

import logging
from typing import Callable, Optional

from ..api import types as api
from ..store.store import NotFoundError
from .base import Controller

logger = logging.getLogger("kubernetes_tpu_torch.controllers.node")

ZONE_NORMAL = "Normal"
ZONE_PARTIAL = "PartialDisruption"
ZONE_FULL = "FullDisruption"


class RateLimiter:
    """Token bucket (the reference's flowcontrol.NewTokenBucketRateLimiter)."""

    def __init__(self, qps: float, burst: int, clock: Callable[[], float]):
        self.qps = qps
        self.burst = burst
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def try_accept(self) -> bool:
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def set_qps(self, qps: float) -> None:
        self.qps = qps


class NodeLifecycleController(Controller):
    name = "node-lifecycle"

    def __init__(
        self,
        clientset,
        informers=None,
        grace_period: float = 40.0,
        pod_eviction_timeout: float = 300.0,
        eviction_qps: float = 0.1,
        secondary_eviction_qps: float = 0.01,
        unhealthy_zone_threshold: float = 0.55,
        large_zone_size: int = 50,
        use_taint_based_evictions: bool = False,
        **kw,
    ):
        super().__init__(clientset, informers, **kw)
        self.use_taint_based_evictions = use_taint_based_evictions
        self.grace_period = grace_period
        self.pod_eviction_timeout = pod_eviction_timeout
        self.eviction_qps = eviction_qps
        self.secondary_eviction_qps = secondary_eviction_qps
        self.unhealthy_zone_threshold = unhealthy_zone_threshold
        self.large_zone_size = large_zone_size
        self._zone_limiters: dict[str, RateLimiter] = {}
        self._not_ready_since: dict[str, float] = {}
        self.zone_states: dict[str, str] = {}
        self.informers.informer("Node")
        # by-node pod index (fieldSelector analogue) so eviction is
        # O(pods-on-node), not O(cluster-pods) per dead node per tick
        from ..client.informer import PodNodeIndex

        self._pod_index = PodNodeIndex(self.informers.informer("Pod"))

    def sync(self, key: str) -> None:  # queue unused; monitor() drives
        pass

    # -- the monitor tick --------------------------------------------------
    def monitor(self) -> dict:
        """One monitorNodeStatus pass; returns a summary for observability."""
        self.informers.pump_all()
        now = self.clock()
        nodes = self.informer("Node").list()
        summary = {"marked_unknown": 0, "evicted_pods": 0, "zones": {}}

        # 1. staleness -> Ready=Unknown
        for node in nodes:
            ready = node.status.condition(api.NODE_READY)
            hb = ready.heartbeat_time if ready else 0.0
            if ready is None or (ready.status == "True" and now - hb > self.grace_period):
                self._mark_unknown(node, now)
                summary["marked_unknown"] += 1

        # 2. zone census
        self.informers.pump_all()
        nodes = self.informer("Node").list()
        zone_members: dict[str, list[api.Node]] = {}
        for node in nodes:
            zone = node.meta.labels.get(api.ZONE_LABEL, "")
            zone_members.setdefault(zone, []).append(node)
        for zone, members in zone_members.items():
            not_ready = [n for n in members if not self._is_ready(n)]
            frac = len(not_ready) / len(members) if members else 0.0
            if frac >= 1.0:
                state = ZONE_FULL
            elif frac >= self.unhealthy_zone_threshold:
                state = ZONE_PARTIAL
            else:
                state = ZONE_NORMAL
            self.zone_states[zone] = state
            summary["zones"][zone] = state
            limiter = self._zone_limiters.get(zone)
            if limiter is None:
                limiter = RateLimiter(self.eviction_qps, burst=1, clock=self.clock)
                self._zone_limiters[zone] = limiter
            # reference zoneStates damping: partial outage in a large zone →
            # slow eviction; small zone or full outage → stop entirely
            if state == ZONE_NORMAL:
                limiter.set_qps(self.eviction_qps)
            elif state == ZONE_PARTIAL and len(members) > self.large_zone_size:
                limiter.set_qps(self.secondary_eviction_qps)
            else:
                limiter.set_qps(0.0)

        # 3. evictions — either direct pod deletes after the grace window,
        # or (taint mode) NoExecute taints applied at once: the taint
        # manager then enforces each pod's own tolerationSeconds instead of
        # one controller-wide timeout (taint_controller.go)
        for zone, members in zone_members.items():
            limiter = self._zone_limiters[zone]
            for node in members:
                if self._is_ready(node):
                    self._not_ready_since.pop(node.meta.name, None)
                    if self.use_taint_based_evictions:
                        self._set_failure_taints(node, ready=True)
                    continue
                if limiter.qps <= 0.0:
                    continue  # zone damped: leave state as-is
                if self.use_taint_based_evictions:
                    if limiter.try_accept():
                        self._set_failure_taints(node, ready=False)
                        summary["tainted"] = summary.get("tainted", 0) + 1
                    continue
                since = self._not_ready_since.setdefault(node.meta.name, now)
                if now - since < self.pod_eviction_timeout:
                    continue
                summary["evicted_pods"] += self._evict_pods(node, limiter)
        return summary

    def _set_failure_taints(self, node: api.Node, ready: bool) -> None:
        """Reconcile the notReady/unreachable NoExecute taints to the
        node's observed condition (reference ``zoneNoExecuteTainer``)."""
        from .taint import TAINT_NOT_READY, TAINT_UNREACHABLE

        cond = node.status.condition(api.NODE_READY)
        status = cond.status if cond else "Unknown"
        want_key = None
        if not ready:
            want_key = TAINT_UNREACHABLE if status == "Unknown" else TAINT_NOT_READY
        ours = {TAINT_NOT_READY, TAINT_UNREACHABLE}
        have = {t.key for t in node.spec.taints if t.key in ours}
        if have == ({want_key} if want_key else set()):
            return

        def _mutate(cur: api.Node) -> api.Node:
            cur.spec.taints = [t for t in cur.spec.taints if t.key not in ours]
            if want_key:
                cur.spec.taints.append(api.Taint(key=want_key, effect=api.NO_EXECUTE))
            return cur

        try:
            self.clientset.nodes.guaranteed_update(node.meta.name, _mutate, "")
        except NotFoundError:
            pass

    # -- helpers -----------------------------------------------------------
    def _is_ready(self, node: api.Node) -> bool:
        c = node.status.condition(api.NODE_READY)
        return c is not None and c.status == "True"

    def _mark_unknown(self, node: api.Node, now: float) -> None:
        def _mutate(cur: api.Node) -> api.Node:
            c = cur.status.condition(api.NODE_READY)
            if c is None:
                c = api.NodeCondition(type=api.NODE_READY)
                cur.status.conditions.append(c)
            c.status = "Unknown"
            return cur

        try:
            self.clientset.nodes.guaranteed_update(node.meta.name, _mutate, "")
        except NotFoundError:
            pass

    def _evict_pods(self, node: api.Node, limiter: RateLimiter) -> int:
        evicted = 0
        for pod in self._pod_index.pods_on(node.meta.name):
            if not limiter.try_accept():
                break
            try:
                self.clientset.pods.delete(pod.meta.name, pod.meta.namespace)
                evicted += 1
            except NotFoundError:
                continue
        return evicted
