"""NodeInfo and the scheduler cache — the assume/bind protocol.

Capability of the reference's ``plugin/pkg/scheduler/schedulercache``
(``node_info.go:34 NodeInfo``, ``cache.go:38 New``, ``AssumePod :109``,
``FinishBinding :130``, ``ForgetPod :154``, expiry loop ``:346-379``):

- ``NodeInfo`` aggregates everything predicates and priorities read per
  node in canonical fixed-point units; it is also the struct the
  tensorizer flattens into the [N, R] arrays;
- the cache lets scheduling run ahead of binding: ``assume_pod`` commits
  resources locally before the bind lands; the watch confirms it
  (``add_pod``), or it expires after a TTL if the binding never shows up;
- generation counters give copy-on-write snapshots (``cache.go:79``): a
  refresh clones only the nodes whose generation moved.

Time is injected (``clock``) so the assume-expiry state machine is
deterministic under test.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..api import types as api
from .units import (
    ResourceVec,
    node_allocatable_pods,
    node_allocatable_vec,
    pod_nonzero_request_vec,
    pod_request_vec,
)


def _zone_key_of(node) -> str:
    """The region+zone label pair, cached on the NodeInfo because scoring
    reads it for every node on every pod."""
    if node is None:
        return ""
    labels = node.meta.labels
    region = labels.get(api.REGION_LABEL, "")
    zone = labels.get(api.ZONE_LABEL, "")
    if not region and not zone:
        return ""
    return f"{region}:{zone}"


def pod_has_affinity(pod: api.Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and bool(
        a.pod_affinity_required
        or a.pod_affinity_preferred
        or a.pod_anti_affinity_required
        or a.pod_anti_affinity_preferred
    )


def _containers_equal(a: api.Pod, b: api.Pod) -> bool:
    return a.spec.containers == b.spec.containers


class NodeInfo:
    """Aggregated per-node scheduling state (``node_info.go:34``)."""

    def __init__(self, node: Optional[api.Node] = None):
        self.node: Optional[api.Node] = node
        self.pods: list[api.Pod] = []
        self.pods_with_affinity: list[api.Pod] = []
        self.requested = ResourceVec()
        self.nonzero_requested = ResourceVec()
        self.allocatable = node_allocatable_vec(node) if node else ResourceVec()
        self.allocatable_pods = node_allocatable_pods(node) if node else 0
        self.used_ports: set[tuple[str, int]] = set()
        self.generation = 0
        self.zone_key = _zone_key_of(node)

    def set_node(self, node: api.Node) -> None:
        self.node = node
        self.allocatable = node_allocatable_vec(node)
        self.allocatable_pods = node_allocatable_pods(node)
        self.zone_key = _zone_key_of(node)
        self.generation += 1

    def remove_node(self) -> None:
        self.node = None
        self.zone_key = ""
        self.generation += 1

    def add_pod(self, pod: api.Pod) -> None:
        self.add_pod_counted(pod, pod_request_vec(pod), pod_nonzero_request_vec(pod))

    def add_pod_counted(self, pod: api.Pod, req_vec, nz_vec) -> None:
        """``add_pod`` with precomputed request vectors (the batch backend
        holds them per signature).  They MUST equal ``pod_request_vec(pod)``
        / ``pod_nonzero_request_vec(pod)``."""
        self.pods.append(pod)
        if pod_has_affinity(pod):
            self.pods_with_affinity.append(pod)
        self.requested.add(req_vec)
        self.nonzero_requested.add(nz_vec)
        for port in pod.host_ports():
            self.used_ports.add(port)
        self.generation += 1

    def replace_pod(self, old_pod: api.Pod, new_pod: api.Pod) -> bool:
        """Swap one resident pod object for a content-equivalent newer
        version without re-aggregating (same requests, ports and affinity;
        the caller asserts the equivalence).  The assume→watch-confirm swap
        is the caller: the confirmed object differs from the assumed one
        only by nodeName and resourceVersion."""
        key = new_pod.meta.key
        for i, p in enumerate(self.pods):
            if p is old_pod or p.meta.key == key:
                self.pods[i] = new_pod
                break
        else:
            return False
        for i, p in enumerate(self.pods_with_affinity):
            if p is old_pod or p.meta.key == key:
                self.pods_with_affinity[i] = new_pod
                break
        self.generation += 1
        return True

    def remove_pod(self, pod: api.Pod) -> bool:
        for i, p in enumerate(self.pods):
            if p.meta.key == pod.meta.key:
                del self.pods[i]
                break
        else:
            return False
        self.pods_with_affinity = [
            p for p in self.pods_with_affinity if p.meta.key != pod.meta.key
        ]
        self.requested.sub(pod_request_vec(pod))
        self.nonzero_requested.sub(pod_nonzero_request_vec(pod))
        # rebuilt from the remaining pods: two residents can hold one port
        self.used_ports = {p for q in self.pods for p in q.host_ports()}
        self.generation += 1
        return True

    def clone(self) -> "NodeInfo":
        c = NodeInfo()
        c.node = self.node
        c.zone_key = self.zone_key
        c.pods = list(self.pods)
        c.pods_with_affinity = list(self.pods_with_affinity)
        c.requested = self.requested.copy()
        c.nonzero_requested = self.nonzero_requested.copy()
        c.allocatable = self.allocatable.copy()
        c.allocatable_pods = self.allocatable_pods
        c.used_ports = set(self.used_ports)
        c.generation = self.generation
        return c

    @property
    def memory_pressure(self) -> bool:
        if self.node is None:
            return False
        c = self.node.status.condition(api.NODE_MEMORY_PRESSURE)
        return c is not None and c.status == "True"

    @property
    def disk_pressure(self) -> bool:
        if self.node is None:
            return False
        c = self.node.status.condition(api.NODE_DISK_PRESSURE)
        return c is not None and c.status == "True"


class SchedulerCache:
    """Assume/confirm/expire pod cache (``schedulercache/cache.go``)."""

    def __init__(self, ttl: float = 30.0, clock: Callable[[], float] = time.monotonic):
        self._mu = threading.RLock()
        self._nodes: dict[str, NodeInfo] = {}
        # pod key -> (pod, node_name, state); state ∈ {assumed, bound}
        self._pod_states: dict[str, tuple[api.Pod, str, str]] = {}
        self._assume_deadlines: dict[str, float] = {}
        self._ttl = ttl
        self._clock = clock

    # -- nodes -------------------------------------------------------------
    def add_node(self, node: api.Node) -> None:
        with self._mu:
            info = self._nodes.get(node.meta.name)
            if info is None:
                info = NodeInfo()
                self._nodes[node.meta.name] = info
            info.set_node(node)

    def update_node(self, node: api.Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        with self._mu:
            info = self._nodes.get(name)
            if info is None:
                return
            if info.pods:
                info.remove_node()  # keep pod aggregation until pods go away
            else:
                del self._nodes[name]

    # -- assume / confirm / forget ----------------------------------------
    def assume_pod(self, pod: api.Pod, node_name: str) -> None:
        self.assume_many([(pod, node_name)])

    def assume_many(self, pairs: list) -> None:
        """Batch assume under ONE lock acquisition + deadline read — the
        batch path lands a whole wave's assumptions at once and per-pod
        locking is measurable at that scale.  Same semantics as
        assume_pod per pair.

        Entries are (pod, node_name) or (pod, node_name, req_vec, nz_vec);
        the 4-tuple form carries the batch backend's per-signature request
        vectors so the aggregation skips the per-pod quantity parse (they
        MUST equal ``pod_request_vec(pod)``/``pod_nonzero_request_vec``,
        the ``add_pod_counted`` contract)."""
        deadline = self._clock() + self._ttl
        with self._mu:
            for entry in pairs:
                pod, node_name = entry[0], entry[1]
                key = pod.meta.key
                if key in self._pod_states:
                    raise ValueError(f"pod {key} already assumed/added")
                info = self._node_info(node_name)
                if len(entry) >= 4 and entry[2] is not None:
                    info.add_pod_counted(pod, entry[2], entry[3])
                else:
                    info.add_pod(pod)
                self._pod_states[key] = (pod, node_name, "assumed")
                self._assume_deadlines[key] = deadline

    def finish_binding(self, pod_key: str) -> None:
        """Binding RPC issued; start the expiry clock (``cache.go:130``)."""
        self.finish_binding_many([pod_key])

    def finish_binding_many(self, pod_keys: list) -> None:
        deadline = self._clock() + self._ttl
        with self._mu:
            for key in pod_keys:
                self._assume_deadlines[key] = deadline

    def forget_pod(self, pod: api.Pod) -> None:
        """Bind failed: roll the assumption back (``cache.go:154``)."""
        with self._mu:
            key = pod.meta.key
            st = self._pod_states.get(key)
            if st is None or st[2] != "assumed":
                return
            _, node_name, _ = st
            self._nodes[node_name].remove_pod(pod)
            del self._pod_states[key]
            self._assume_deadlines.pop(key, None)

    def add_pod(self, pod: api.Pod) -> None:
        """Watch-confirmed bound pod.  Confirms a matching assumption, or
        (re)inserts after expiry/restart."""
        with self._mu:
            key = pod.meta.key
            st = self._pod_states.get(key)
            if st is not None and st[2] == "assumed":
                assumed_pod, node_name, _ = st
                if node_name == pod.spec.node_name:
                    # confirm: swap the assumed object for the API truth.
                    # Every NodeInfo aggregate derives from
                    # spec.containers (requests, ports) and the affinity
                    # flag; when those are unchanged (the normal bind —
                    # only nodeName/resourceVersion moved) swap identity
                    # without re-aggregating.  A concurrent spec change
                    # falls back to remove+add.
                    info = self._nodes[node_name]
                    if not (_containers_equal(assumed_pod, pod)
                            and pod_has_affinity(assumed_pod) == pod_has_affinity(pod)
                            and info.replace_pod(assumed_pod, pod)):
                        info.remove_pod(assumed_pod)
                        info.add_pod(pod)
                    self._pod_states[key] = (pod, node_name, "bound")
                    self._assume_deadlines.pop(key, None)
                    return
                # bound somewhere else than assumed: trust the API
                self._nodes[node_name].remove_pod(assumed_pod)
                self._pod_states.pop(key, None)
                self._assume_deadlines.pop(key, None)
            if not pod.spec.node_name:
                return
            self._node_info(pod.spec.node_name).add_pod(pod)
            self._pod_states[key] = (pod, pod.spec.node_name, "bound")

    def update_pod(self, old: api.Pod, new: api.Pod) -> None:
        with self._mu:
            self.remove_pod(old)
            if new.spec.node_name:
                self.add_pod(new)

    def remove_pod(self, pod: api.Pod) -> None:
        with self._mu:
            key = pod.meta.key
            st = self._pod_states.pop(key, None)
            self._assume_deadlines.pop(key, None)
            if st is None:
                return
            cached_pod, node_name, _ = st
            info = self._nodes.get(node_name)
            if info is not None:
                info.remove_pod(cached_pod)
                if info.node is None and not info.pods:
                    del self._nodes[node_name]

    def is_assumed(self, pod_key: str) -> bool:
        with self._mu:
            st = self._pod_states.get(pod_key)
            return st is not None and st[2] == "assumed"

    def cleanup_expired(self) -> list[str]:
        """Expire assumed pods whose binding never confirmed
        (``cache.go:346-379``); returns expired keys."""
        with self._mu:
            now = self._clock()
            expired = [
                k
                for k, deadline in self._assume_deadlines.items()
                if deadline <= now and self._pod_states.get(k, (None, None, ""))[2] == "assumed"
            ]
            for key in expired:
                pod, node_name, _ = self._pod_states[key]
                self._nodes[node_name].remove_pod(pod)
                del self._pod_states[key]
                del self._assume_deadlines[key]
            return expired

    # -- snapshot ----------------------------------------------------------
    def _node_info(self, name: str) -> NodeInfo:
        info = self._nodes.get(name)
        if info is None:
            info = NodeInfo()
            self._nodes[name] = info
        return info

    def snapshot_into(self, out: dict[str, NodeInfo]) -> None:
        """Generation-checked copy-on-write snapshot refresh
        (``cache.go:79 UpdateNodeNameToInfoMap``): only clone nodes whose
        generation moved; drop vanished nodes."""
        with self._mu:
            for name, info in self._nodes.items():
                cur = out.get(name)
                if cur is None or cur.generation != info.generation:
                    out[name] = info.clone()
            for name in list(out.keys()):
                if name not in self._nodes:
                    del out[name]

    def node_names(self) -> list[str]:
        with self._mu:
            return [n for n, i in self._nodes.items() if i.node is not None]

    def pod_count(self) -> int:
        with self._mu:
            return len(self._pod_states)
