"""ResourceQuota controller: full usage recalculation.

Capability of ``pkg/controller/resourcequota`` (632 LoC): periodically (and
on watched-object churn) recompute each quota's ``status.used`` from the
live objects in its namespace using the shared evaluators, healing any
drift from admission-time charge leaks (failed writes, out-of-band
deletes) — the reference's ``resource_quota_controller.go`` replenishment
loop."""

from __future__ import annotations

from ..admission import quota as quotalib
from ..api.cluster import ResourceQuota
from ..api.quantity import Quantity
from ..store.store import NotFoundError
from .base import Controller


class ResourceQuotaController(Controller):
    name = "resourcequota"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("ResourceQuota")
        from ..client.informer import Handler

        # churn on tracked kinds re-syncs the namespace's quotas
        # (the reference's replenishment controller watches the same set)
        for kind in ("Pod", *quotalib.COUNTED_KINDS):
            self.informers.informer(kind).add_handler(Handler(
                on_add=lambda obj: self._object_event(obj),
                on_update=lambda old, new: self._object_event(new),
                on_delete=lambda obj: self._object_event(obj),
            ))

    def _object_event(self, obj) -> None:
        for rq in self.informer("ResourceQuota").list():
            if rq.meta.namespace == obj.meta.namespace:
                self.queue.add(rq.meta.key)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            rq = self.clientset.resourcequotas.get(name, namespace)
        except NotFoundError:
            return
        scopes = rq.scopes
        used: dict[str, Quantity] = {}
        for kind in ("Pod", *quotalib.COUNTED_KINDS):
            for obj in self.clientset.store.list(kind, namespace)[0]:
                if not quotalib.matches_scopes(scopes, kind, obj):
                    continue
                used = quotalib.add_usage(used, quotalib.usage_for(kind, obj))
        # only report resources the quota constrains (reference behavior)
        tracked = {k: used.get(k, Quantity(0)) for k in rq.hard}

        if tracked != rq.used:
            def _update(cur: ResourceQuota) -> ResourceQuota:
                cur.used = tracked
                return cur

            self.clientset.resourcequotas.guaranteed_update(name, _update, namespace)
