"""Typed client layer over the store.

The capability of the reference's generated clientsets
(``staging/src/k8s.io/client-go/kubernetes``): typed create/get/list/
update/delete/watch per kind, plus the verbs the scheduler commits with:

- ``PodClient.bind`` — the Binding subresource
  (``pkg/registry/core/pod/storage/storage.go:128 BindingREST``): a CAS
  update that sets ``spec.nodeName`` and fails if the pod is already bound
  to a different node;
- ``PodClient.bind_many`` — one store transaction for a whole wave.

Everything passes through the wire form (``to_dict``/``from_dict``), so
callers never share an object with the store.  Store responses decode to
lazy views (``api/lazy.py``) while ``lazy.ENABLED`` holds, eagerly
otherwise; ``list_lazy``/``list_columns`` are the informer's LIST paths.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Type

from ..api import lazy as lazy_mod
from ..api import types as api
from ..store.store import Store, Watch


class BindConflictError(Exception):
    pass


class TypedClient:
    def __init__(self, store: Store, kind: str, cls: Type):
        self._store = store
        self.kind = kind
        self._cls = cls
        self.default_namespace = "" if kind in api.CLUSTER_SCOPED_KINDS else "default"

    def _ns(self, namespace: Optional[str]) -> str:
        """The effective namespace.  Cluster-scoped kinds ignore any
        caller or object namespace: the kind's scope, not the caller,
        decides the key shape."""
        if self.default_namespace == "":
            return ""
        return self.default_namespace if namespace is None else namespace

    def _to_wire(self, obj) -> dict:
        d = obj.to_dict()
        meta = d.setdefault("metadata", {})
        meta["namespace"] = self._ns(meta.get("namespace"))
        return d

    def _decode(self, d: dict):
        """A store response as a lazy view (a caller that never reads it
        pays nothing), or the eager typed decode with lazy decode off."""
        if lazy_mod.ENABLED:
            return lazy_mod.lazy_class(self._cls)(d)
        return self._cls.from_dict(d)

    def create(self, obj):
        # to_dict output is private to this call: the store may keep it
        return self._decode(self._store.create(self.kind, self._to_wire(obj), _trusted=True))

    def create_nowait(self, obj) -> None:
        """``create`` without decoding the stored object back, for
        fire-and-forget writers (the event sink)."""
        self._store.create(self.kind, self._to_wire(obj), _trusted=True)

    def _create_many_raw(self, objs) -> list:
        return self._store.create_many(self.kind, [self._to_wire(o) for o in objs],
                                       _trusted=True)

    def create_many(self, objs) -> list:
        """Batch create in one store txn; one decoded object (or None for
        an item that failed) per input, in order."""
        return [self._decode(d) if d is not None else None
                for d in self._create_many_raw(objs)]

    def create_many_nowait(self, objs) -> None:
        """Batch create with no return decode (the event sink's drained
        chunk, an arrival wave)."""
        self._create_many_raw(objs)

    def get(self, name: str, namespace: Optional[str] = None):
        return self._decode(self._store.get(self.kind, self._ns(namespace), name))

    def list(self, namespace: Optional[str] = None):
        if namespace is not None:
            namespace = self._ns(namespace)
        dicts, rev = self._store.list(self.kind, namespace)
        return [self._cls.from_dict(d) for d in dicts], rev

    def list_lazy(self, namespace: Optional[str] = None):
        """LIST into decode-on-access views: the same objects, with
        ``from_dict`` deferred until a field is read."""
        if namespace is not None:
            namespace = self._ns(namespace)
        dicts, rev = self._store.list(self.kind, namespace)
        cls = lazy_mod.lazy_class(self._cls)
        return [cls(d) for d in dicts], rev

    def list_columns(self):
        """A packed column batch (``store/columns.py``) for the kinds that
        have one (Pod, Node), else None: callers fall back to
        :meth:`list_lazy`/:meth:`list`."""
        return self._store.list_columns(self.kind)

    def update(self, obj):
        return self._decode(self._store.update(self.kind, self._to_wire(obj)))

    def guaranteed_update(self, name: str, mutate: Callable, namespace: Optional[str] = None):
        """``mutate`` receives a typed object and returns the new one."""
        namespace = self._ns(namespace)

        def _mutate_dict(d: dict) -> dict:
            return mutate(self._cls.from_dict(d)).to_dict()

        return self._cls.from_dict(
            self._store.guaranteed_update(self.kind, namespace, name, _mutate_dict)
        )

    def update_status(self, obj):
        """Write only .status, preserving concurrent spec/label changes,
        like the /status subresource."""
        status = obj.to_dict().get("status")

        def _mutate(cur):
            d = cur.to_dict()
            d["status"] = copy.deepcopy(status)
            return self._cls.from_dict(d)

        return self.guaranteed_update(obj.meta.name, _mutate, obj.meta.namespace)

    def delete(self, name: str, namespace: Optional[str] = None):
        return self._cls.from_dict(self._store.delete(self.kind, self._ns(namespace), name))

    def watch(self, from_revision: Optional[int] = None, frames: bool = False) -> Watch:
        """``frames=True``: one ``WatchFrame`` a correlated store txn
        instead of its events (for frame-aware consumers: the informer)."""
        if frames:
            return self._store.watch(self.kind, from_revision, frames=True)
        return self._store.watch(self.kind, from_revision)


class PodClient(TypedClient):
    def __init__(self, store: Store):
        super().__init__(store, "Pod", api.Pod)

    def bind(self, binding: api.Binding) -> None:
        """Commit one placement (BindingREST.Create → assignPod,
        ``storage.go:141,157,191``), at the wire-dict level: no typed
        round trip on the scheduler's hottest write."""

        def _assign(d: dict) -> dict:
            cur = (d.get("spec") or {}).get("nodeName", "")
            if cur and cur != binding.node_name:
                raise BindConflictError(
                    f"pod {binding.pod_namespace}/{binding.pod_name} already bound to {cur}"
                )
            d.setdefault("spec", {})["nodeName"] = binding.node_name
            return d

        self._store.guaranteed_update(
            "Pod", binding.pod_namespace, binding.pod_name, _assign
        )

    def bind_many(self, bindings: list[api.Binding]) -> list[Optional[str]]:
        """Batch placement commit (one store txn); per-item error or None."""
        return self._store.bind_many(
            [(b.pod_namespace, b.pod_name, b.node_name) for b in bindings]
        )


class Clientset:
    """One typed client per registered kind (``clientset.Interface``),
    under the kind's plural name (``cs.pods``, ``cs.nodes``, ...);
    ``client_for(kind)`` reaches the same clients by kind."""

    def __init__(self, store: Store):
        self.store = store
        self.pods = PodClient(store)
        self._by_kind: dict[str, TypedClient] = {"Pod": self.pods}
        for kind, cls in api.KINDS.items():
            if kind == "Pod":
                continue
            client = TypedClient(store, kind, cls)
            self._by_kind[kind] = client
            setattr(self, api.KIND_PLURALS[kind], client)

    def client_for(self, kind: str) -> TypedClient:
        return self._by_kind[kind]
