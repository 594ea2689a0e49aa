"""NodeInfo: the per-node aggregate every predicate and priority reads, in
canonical fixed-point units.  It is also the struct the tensorizer flattens
into the [N, R] arrays.  Generation counters mark every mutation, so a
snapshot consumer can tell which nodes moved."""

from __future__ import annotations

from typing import Optional

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


class NodeInfo:
    """Aggregated per-node scheduling state."""

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
