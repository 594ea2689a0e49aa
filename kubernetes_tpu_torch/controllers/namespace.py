"""Namespace controller: cascading teardown of terminating namespaces.

Capability of ``pkg/controller/namespace`` (796 LoC): when a namespace is
marked deleting, flip it to Terminating, discovery-walk every namespaced
kind, delete all contained resources, and only then clear the
``kubernetes`` finalizer so the store finishes the delete
(``namespace/deletion/namespaced_resources_deleter.go``).

Discovery here is the type registry (``KINDS`` minus cluster-scoped) —
the same role the reference's discovery client plays, so CRD-registered
kinds are swept too."""

from __future__ import annotations

from ..api.cluster import Namespace
from ..api.types import CLUSTER_SCOPED_KINDS, KINDS
from ..store.store import NotFoundError
from .base import Controller

FINALIZER = "kubernetes"


class NamespaceController(Controller):
    name = "namespace"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("Namespace", key_fn=lambda ns: ns.meta.name)

    def sync(self, key: str) -> None:
        try:
            ns = self.clientset.namespaces.get(key)
        except NotFoundError:
            return
        if ns.meta.deletion_revision is None:
            # live namespace: make sure the finalizer is armed so a future
            # delete is gated on our sweep
            if FINALIZER not in ns.meta.finalizers:
                def _arm(cur: Namespace) -> Namespace:
                    if FINALIZER not in cur.meta.finalizers:
                        cur.meta.finalizers.append(FINALIZER)
                    return cur

                self.clientset.namespaces.guaranteed_update(key, _arm)
            return

        # deleting: phase -> Terminating (admission now refuses new content)
        if ns.phase != "Terminating":
            def _term(cur: Namespace) -> Namespace:
                cur.phase = "Terminating"
                return cur

            self.clientset.namespaces.guaranteed_update(key, _term)

        remaining = self._delete_contents(key)
        if remaining:
            # try again on a later sync (informer events from the deletes
            # will not requeue us, so self-requeue like the reference's
            # rate-limited retry)
            self.queue.add_rate_limited(key)
            return

        def _finish(cur: Namespace) -> Namespace:
            cur.meta.finalizers = [f for f in cur.meta.finalizers if f != FINALIZER]
            cur.spec_finalizers = [f for f in cur.spec_finalizers if f != FINALIZER]
            return cur

        try:
            self.clientset.namespaces.guaranteed_update(key, _finish)
        except NotFoundError:
            pass  # someone else finished it

    def _delete_contents(self, namespace: str) -> int:
        """Delete every namespaced object; returns how many still remain."""
        remaining = 0
        for kind in KINDS:
            if kind in CLUSTER_SCOPED_KINDS or kind == "Namespace":
                continue
            objs, _ = self.clientset.store.list(kind, namespace)
            for obj in objs:
                meta = obj.get("metadata") or {}
                try:
                    self.clientset.store.delete(kind, namespace, meta.get("name", ""))
                except NotFoundError:
                    continue
                if meta.get("finalizers"):
                    remaining += 1  # delete only marked it; wait for owners
        return remaining
