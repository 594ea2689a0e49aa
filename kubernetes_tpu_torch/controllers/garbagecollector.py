"""Garbage collector: ownerReference graph + cascading deletion.

Capability of ``pkg/controller/garbagecollector`` (2,748 LoC):

- the owner graph spans EVERY kind in the type registry
  (``graph_builder.go:317`` builds from discovery + dynamic watches; here
  the registry is the discovery source), so Job→Pod, StatefulSet→Pod, or
  any CRD-style late-registered kind participates with no per-kind code;
- **background cascading deletion**: a dependent whose owners are ALL
  gone is deleted; a dependent with a mix of live and dangling owners
  gets the dangling references patched away (``attemptToDeleteItem``);
- UID-checked: an owner deleted and recreated under the same name does
  NOT keep old dependents alive;
- **orphan propagation**: deleting an owner that carries the ``orphan``
  finalizer makes the GC strip its ownerReferences from all dependents
  and then remove the finalizer (releasing the tombstoned delete) —
  dependents survive ownerless (``orphanDependents``, the
  DeleteOptions.propagationPolicy=Orphan path).

A reverse index (owner → dependents) makes owner-deletion wakeups
O(dependents-of-owner), not O(cluster)."""

from __future__ import annotations

import logging
import threading

from ..api import types as api
from ..client.informer import Handler
from ..store.store import ConflictError, NotFoundError
from .base import Controller

logger = logging.getLogger("kubernetes_tpu_torch.controllers.gc")

ORPHAN_FINALIZER = "orphan"

# kinds that never own or get owned usefully and churn at high volume
_EXCLUDED_KINDS = {"Event"}


def _owner_index_key(ref: api.OwnerReference, dependent_namespace: str) -> tuple:
    ns = "" if ref.kind in api.CLUSTER_SCOPED_KINDS else dependent_namespace
    return (ref.kind, ns, ref.name, ref.uid)


class GarbageCollector(Controller):
    name = "garbagecollector"

    def __init__(self, clientset, informers=None, kinds=None, **kw):
        super().__init__(clientset, informers, **kw)
        self._fixed_kinds = list(kinds) if kinds is not None else None
        # Graph state is written by per-kind watch threads and read by
        # workers; the reference serializes all graph changes through one
        # graph-builder goroutine — a lock is the equivalent here.
        self._graph_mu = threading.Lock()
        # owner identity -> {(dependent kind, dependent key)}
        self._dependents: dict[tuple, set[tuple[str, str]]] = {}
        # dependent (kind, key) -> owner identities it is indexed under
        self._owners_of: dict[tuple[str, str], set[tuple]] = {}
        self.kinds: list[str] = []
        self.refresh_kinds()

    def refresh_kinds(self) -> None:
        """Wire handlers for every registry kind not yet watched — called
        at construction and again whenever a CRD establishes a new kind,
        so late-registered kinds join the owner graph."""
        wanted = self._fixed_kinds if self._fixed_kinds is not None else list(api.KINDS)
        for kind in wanted:
            # membership check + append under the graph lock: this runs
            # from informer callbacks (CRD establishment) as well as the
            # constructing thread, and a check-then-act race would wire
            # duplicate handlers (= duplicate graph events per object)
            with self._graph_mu:
                if kind in self.kinds or kind in _EXCLUDED_KINDS:
                    continue
                # handler wiring is permanent by design (shared informers
                # are never unwired in the reference either)
                # bounded: one entry per registry/CRD kind ever established
                self.kinds.append(kind)
            self.informers.informer(kind).add_handler(Handler(
                on_add=lambda obj, k=kind: self._observe(k, obj),
                on_update=lambda old, new, k=kind: self._observe(k, new),
                on_delete=lambda obj, k=kind: self._observe_delete(k, obj),
            ))

    # -- graph maintenance (graph_builder processGraphChanges) --------------
    def _observe(self, kind: str, obj) -> None:
        if kind == "CustomResourceDefinition":
            # a CRD may have just established a new kind: wire it in
            self.refresh_kinds()
        dep = (kind, obj.meta.key)
        new_idx = {
            _owner_index_key(ref, obj.meta.namespace)
            for ref in obj.meta.owner_references
        }
        with self._graph_mu:
            old_idx = self._owners_of.get(dep, set())
            for gone in old_idx - new_idx:
                members = self._dependents.get(gone)
                if members:
                    members.discard(dep)
                    if not members:
                        del self._dependents[gone]
            for added in new_idx - old_idx:
                self._dependents.setdefault(added, set()).add(dep)
            if new_idx:
                self._owners_of[dep] = new_idx
            else:
                self._owners_of.pop(dep, None)
        if new_idx:
            self.queue.add(f"dep|{kind}|{obj.meta.key}")
        if obj.meta.deletion_revision is not None and ORPHAN_FINALIZER in obj.meta.finalizers:
            self.queue.add(f"orphan|{kind}|{obj.meta.key}")

    def _observe_delete(self, kind: str, obj) -> None:
        dep = (kind, obj.meta.key)
        ns = "" if kind in api.CLUSTER_SCOPED_KINDS else obj.meta.namespace
        idx = (kind, ns, obj.meta.name, obj.meta.uid)
        with self._graph_mu:
            for owner_idx in self._owners_of.pop(dep, set()):
                members = self._dependents.get(owner_idx)
                if members:
                    members.discard(dep)
                    if not members:
                        del self._dependents[owner_idx]
            # this object may have been an owner: wake exactly its dependents
            waiters = list(self._dependents.get(idx, ()))
        for dkind, dkey in waiters:
            self.queue.add(f"dep|{dkind}|{dkey}")

    # -- liveness ------------------------------------------------------------
    def _owner_alive(self, namespace: str, ref: api.OwnerReference) -> bool:
        if ref.kind not in api.KINDS:
            return True  # unregistered kinds are never collected against
        ns = "" if ref.kind in api.CLUSTER_SCOPED_KINDS else namespace
        inf = self.informers.informer(ref.kind) if ref.kind in self.kinds else None
        if inf is not None:
            owner = inf.get(f"{ns}/{ref.name}" if ns else ref.name)
            if owner is not None and owner.meta.uid == ref.uid:
                # a deleting owner with the orphan finalizer will release
                # its dependents; treat as alive until the orphan pass runs
                return True
        # Informer caches race in threaded mode (a dependent's add can land
        # before its owner's add on a different watch thread).  Absence must
        # be confirmed against the LIVE API before deleting — the reference
        # GC does the same quarantine re-check.
        try:
            live = self.clientset.client_for(ref.kind).get(ref.name, ns)
            return live.meta.uid == ref.uid
        except NotFoundError:
            return False

    # -- reconcile (attemptToDeleteItem / orphanDependents) ------------------
    def sync(self, key: str) -> None:
        mode, kind, obj_key = key.split("|", 2)
        if mode == "orphan":
            self._sync_orphan(kind, obj_key)
            return
        obj = self.informers.informer(kind).get(obj_key)
        if obj is None or not obj.meta.owner_references:
            return
        dangling = [
            ref for ref in obj.meta.owner_references
            if not self._owner_alive(obj.meta.namespace, ref)
        ]
        if not dangling:
            return
        client = self.clientset.client_for(kind)
        if len(dangling) == len(obj.meta.owner_references):
            logger.info("gc: deleting %s %s (all owners gone)", kind, obj_key)
            try:
                client.delete(obj.meta.name, obj.meta.namespace)
            except NotFoundError:
                pass
            return
        # mixed: live owners keep the object; dangling refs are patched away
        gone_uids = {ref.uid for ref in dangling}

        def _strip(cur):
            cur.meta.owner_references = [
                r for r in cur.meta.owner_references if r.uid not in gone_uids
            ]
            return cur

        try:
            client.guaranteed_update(obj.meta.name, _strip, obj.meta.namespace)
        except NotFoundError:
            pass

    def _sync_orphan(self, kind: str, obj_key: str) -> None:
        """Strip this deleting owner's refs from every dependent, then drop
        the orphan finalizer so the tombstoned delete completes."""
        obj = self.informers.informer(kind).get(obj_key)
        if obj is None:
            return
        ns = "" if kind in api.CLUSTER_SCOPED_KINDS else obj.meta.namespace
        idx = (kind, ns, obj.meta.name, obj.meta.uid)
        with self._graph_mu:
            dependents = list(self._dependents.get(idx, ()))
        for dkind, dkey in dependents:
            dclient = self.clientset.client_for(dkind)
            dns, _, dname = dkey.rpartition("/")

            def _strip(cur, uid=obj.meta.uid):
                cur.meta.owner_references = [
                    r for r in cur.meta.owner_references if r.uid != uid
                ]
                return cur

            try:
                dclient.guaranteed_update(dname, _strip, dns)
            except NotFoundError:
                continue

        def _drop_finalizer(cur):
            cur.meta.finalizers = [
                f for f in cur.meta.finalizers if f != ORPHAN_FINALIZER
            ]
            return cur

        try:
            self.clientset.client_for(kind).guaranteed_update(
                obj.meta.name, _drop_finalizer, obj.meta.namespace
            )
        except (NotFoundError, ConflictError):
            pass
