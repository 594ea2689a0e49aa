"""Pod garbage collector.

Capability of ``pkg/controller/podgc/gc_controller.go``: delete (a) the
oldest terminated pods beyond ``terminated_pod_threshold``, (b) pods bound
to nodes that no longer exist, (c) unscheduled pods already marked
deleting.  Driven by ``tick()`` (the reference runs it on a 20s timer)."""

from __future__ import annotations

from ..api import types as api
from ..store.store import NotFoundError
from .base import Controller


class PodGCController(Controller):
    name = "podgc"

    def __init__(self, clientset, informers=None, terminated_pod_threshold: int = 12500, **kw):
        super().__init__(clientset, informers, **kw)
        self.terminated_pod_threshold = terminated_pod_threshold
        # cache-fed scans: a GC pass must not LIST the cluster over the wire
        self.informers.informer("Pod")
        self.informers.informer("Node")

    def tick(self) -> int:
        """One GC pass; returns pods deleted."""
        self.informers.pump_all()  # no-op under threaded informers
        pods = self.informer("Pod").list()
        node_names = {n.meta.name for n in self.informer("Node").list()}
        deleted = 0

        terminated = [p for p in pods if p.status.phase in (api.SUCCEEDED, api.FAILED)]
        excess = len(terminated) - self.terminated_pod_threshold
        if excess > 0:
            oldest = sorted(terminated, key=lambda p: p.meta.creation_revision)[:excess]
            deleted += self._delete_all(oldest)

        orphaned = [p for p in pods
                    if p.spec.node_name and p.spec.node_name not in node_names]
        deleted += self._delete_all(orphaned)

        unscheduled_terminating = [
            p for p in pods
            if not p.spec.node_name and p.meta.deletion_revision is not None
        ]
        deleted += self._delete_all(unscheduled_terminating)
        return deleted

    def sync(self, key: str) -> None:  # queue-driven path just re-ticks
        self.tick()

    def _delete_all(self, pods: list[api.Pod]) -> int:
        n = 0
        for p in pods:
            try:
                self.clientset.pods.delete(p.meta.name, p.meta.namespace)
                n += 1
            except NotFoundError:
                continue
        return n
