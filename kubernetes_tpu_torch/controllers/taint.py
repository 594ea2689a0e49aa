"""NoExecute taint manager: timed, toleration-aware evictions.

Capability of the reference's ``NoExecuteTaintManager``
(``pkg/controller/node/scheduler/taint_controller.go`` +
``timed_workers.go``):

- a pod on a node carrying NoExecute taints is evicted **immediately**
  if it does not tolerate every such taint;
- if it tolerates them all but some toleration carries
  ``tolerationSeconds``, a timed eviction fires at the MINIMUM such
  value (``getMinTolerationTime``), measured from when the taint was
  first observed for that pod;
- tolerating with no ``tolerationSeconds`` means it stays forever;
- removing the taints (or deleting the pod / moving the node back to
  Ready) cancels the pending timer (``timed_workers.go CancelWork``).

The companion piece is taint-based failure marking: with
``use_taint_based_evictions``, ``NodeLifecycleController`` applies the
era's ``node.alpha.kubernetes.io/notReady`` / ``unreachable`` NoExecute
taints instead of deleting pods itself, and the DefaultTolerationSeconds
admission plugin (``admission/plugins.py``) gives every pod the 300s
grace the reference does — so this manager is what actually enforces
those timers.

Time is an injected clock + explicit ``tick()`` (the reference's timed
workers collapsed into a deterministic heap scan)."""

from __future__ import annotations

import heapq
import logging
import threading
from typing import Callable, Optional

from ..api import types as api
from ..store.store import NotFoundError
from .base import Controller

logger = logging.getLogger("kubernetes_tpu_torch.controllers.taint")

# single-sourced from the API package (shared with the
# DefaultTolerationSeconds admission plugin)
TAINT_NOT_READY = api.TAINT_NODE_NOT_READY
TAINT_UNREACHABLE = api.TAINT_NODE_UNREACHABLE


def _no_execute_taints(node: api.Node) -> list[api.Taint]:
    return [t for t in node.spec.taints if t.effect == api.NO_EXECUTE]


def min_toleration_seconds(pod: api.Pod, taints: list[api.Taint]) -> Optional[float]:
    """None = evict now; float('inf') = tolerated forever; else seconds.

    Reference ``getMatchingTolerations`` + ``getMinTolerationTime``: the
    pod must tolerate EVERY NoExecute taint; the timer is the minimum
    ``tolerationSeconds`` across the tolerations used."""
    if not taints:
        return float("inf")
    used: list[api.Toleration] = []
    for taint in taints:
        match = next((tol for tol in pod.spec.tolerations if tol.tolerates(taint)), None)
        if match is None:
            return None
        used.append(match)
    secs = [t.toleration_seconds for t in used if t.toleration_seconds is not None]
    if not secs:
        return float("inf")
    return float(max(0, min(secs)))


class NoExecuteTaintManager(Controller):
    name = "taint-manager"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("Node", key_fn=lambda n: f"node/{n.meta.name}")
        self.watch("Pod", key_fn=self._pod_key)
        from ..client.informer import PodNodeIndex

        self._pod_index = PodNodeIndex(self.informers.informer("Pod"))
        # pod key -> (deadline, node_name); a heap mirrors the deadlines.
        # Guarded by _mu: sync() runs on run_workers() threads while tick()
        # pumps the heap from the manager loop (ktpu-analyze RL303).
        self._mu = threading.Lock()
        self._pending: dict[str, tuple[float, str]] = {}
        self._heap: list[tuple[float, str]] = []
        self.stats = {"evicted_now": 0, "evicted_timed": 0, "cancelled": 0}

    def _pod_key(self, pod: api.Pod):
        return f"pod/{pod.meta.key}" if pod.spec.node_name else None

    # -- reconcile ---------------------------------------------------------
    def sync(self, key: str) -> None:
        kind, _, rest = key.partition("/")
        if kind == "node":
            self._sync_node(rest)
        else:
            self._sync_pod(rest)

    def _sync_node(self, name: str) -> None:
        node = self.informer("Node").get(name)
        taints = _no_execute_taints(node) if node is not None else []
        if not taints:
            # taint gone (or node gone): cancel every timer for this node
            with self._mu:
                for pod_key, (_, node_name) in list(self._pending.items()):
                    if node_name == name:
                        del self._pending[pod_key]
                        self.stats["cancelled"] += 1
            return
        for pod in self._pod_index.pods_on(name):
            self._process(pod, taints)

    def _sync_pod(self, pod_key: str) -> None:
        pod = self.informer("Pod").get(pod_key)
        if pod is None or not pod.spec.node_name:
            with self._mu:
                if self._pending.pop(pod_key, None) is not None:
                    self.stats["cancelled"] += 1
            return
        node = self.informer("Node").get(pod.spec.node_name)
        taints = _no_execute_taints(node) if node is not None else []
        self._process(pod, taints)

    def _process(self, pod: api.Pod, taints: list[api.Taint]) -> None:
        key = pod.meta.key
        wait = min_toleration_seconds(pod, taints)
        if wait is None:
            with self._mu:
                self._pending.pop(key, None)
            self._evict(pod.meta.name, pod.meta.namespace, timed=False)
            return
        if wait == float("inf"):
            with self._mu:
                if self._pending.pop(key, None) is not None:
                    self.stats["cancelled"] += 1
            return
        deadline = self.clock() + wait
        with self._mu:
            cur = self._pending.get(key)
            if cur is not None and cur[1] == pod.spec.node_name:
                return  # timer already armed from first observation; keep it
            self._pending[key] = (deadline, pod.spec.node_name)
            heapq.heappush(self._heap, (deadline, key))

    # -- the timer pump ----------------------------------------------------
    def tick(self) -> int:
        """Fire due evictions (timed_workers collapsed to a heap scan)."""
        self.informers.pump_all()
        while self.sync_once():
            pass
        now = self.clock()
        # drain due keys under the lock, evict outside it (the delete is an
        # API round-trip; holding _mu across it would stall sync workers)
        due: list[tuple[str, str]] = []  # (pod key, node name)
        with self._mu:
            while self._heap and self._heap[0][0] <= now:
                deadline, key = heapq.heappop(self._heap)
                cur = self._pending.get(key)
                if cur is None or cur[0] != deadline:
                    continue  # cancelled or re-armed
                del self._pending[key]
                due.append((key, cur[1]))
        fired = 0
        for key, node_name in due:
            ns, _, name = key.partition("/")
            try:
                self._evict(name, ns, timed=True)
            except Exception:  # noqa: BLE001 - transient API failure
                # re-arm as already-due so the NEXT tick retries; without
                # this a failed delete mid-batch would silently drop every
                # drained timer (they are gone from _pending and _heap)
                with self._mu:
                    self._pending[key] = (now, node_name)
                    heapq.heappush(self._heap, (now, key))
            else:
                fired += 1
        return fired

    def _evict(self, name: str, namespace: str, timed: bool) -> None:
        try:
            self.clientset.pods.delete(name, namespace)
            with self._mu:
                self.stats["evicted_timed" if timed else "evicted_now"] += 1
        except NotFoundError:
            pass

    def pending_count(self) -> int:
        with self._mu:
            return len(self._pending)
