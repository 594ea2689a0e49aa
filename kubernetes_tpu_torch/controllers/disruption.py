"""Disruption controller: maintain PodDisruptionBudget status.

Capability of ``pkg/controller/disruption`` (765 LoC): for each PDB, count
healthy (Running) pods matching its selector, compute
``disruptionsAllowed = max(0, healthy - minAvailable)``, and keep the
counts fresh so the eviction subresource can gate voluntary evictions."""

from __future__ import annotations

from ..api import types as api
from ..api.cluster import PodDisruptionBudget
from ..store.store import NotFoundError
from .base import Controller


class DisruptionController(Controller):
    name = "disruption"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("PodDisruptionBudget")
        from ..client.informer import Handler

        # old labels requeue too (label moved off a PDB's selector)
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._pod_event,
            on_update=lambda old, new: (self._pod_event(old), self._pod_event(new)),
            on_delete=self._pod_event,
        ))

    def _pod_event(self, pod: api.Pod) -> None:
        for pdb in self.informer("PodDisruptionBudget").list():
            if pdb.meta.namespace == pod.meta.namespace and pdb.selector.matches(pod.meta.labels):
                self.queue.add(pdb.meta.key)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            pdb = self.clientset.poddisruptionbudgets.get(name, namespace)
        except NotFoundError:
            return
        matching = [p for p in self.clientset.pods.list(namespace)[0]
                    if pdb.selector.matches(p.meta.labels)
                    and p.status.phase not in (api.SUCCEEDED, api.FAILED)]
        healthy = sum(1 for p in matching if p.status.phase == api.RUNNING)
        expected = len(matching)
        desired = pdb.min_available
        allowed = max(0, healthy - desired)

        def _status(cur: PodDisruptionBudget) -> PodDisruptionBudget:
            cur.status_current_healthy = healthy
            cur.status_desired_healthy = desired
            cur.status_expected_pods = expected
            cur.status_disruptions_allowed = allowed
            return cur

        self.clientset.poddisruptionbudgets.guaranteed_update(name, _status, namespace)
