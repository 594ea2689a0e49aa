"""Admission framework: mutating+validating plugin chain on the write path.

Capability equivalent of the reference's admission machinery
(``staging/src/k8s.io/apiserver/pkg/admission`` — ``Interface``/
``MutationInterface``/``ValidationInterface`` and the chain in
``chain.go``), wired the way the reference wires it: inside the write
handlers *before* storage (``endpoints/handlers/rest.go:388`` runs
``admit.Admit`` then ``Validate`` before ``registry.Store.Create``).

Here the seam is ``AdmittedStore``, a ``Store`` subclass whose
create/update/delete run the chain first.  Both the in-process
``Clientset`` and the wire ``APIServer`` take any Store, so admission
slots under either without touching callers.

Kept as the JAX package has them: ``create_many`` is not overridden, so a
batch create (``POST /api/v1/{resource}:batch``) skips the chain, and
binds (``bind_many``) skip it by design.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from ..store.store import Store

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"


class AdmissionDenied(Exception):
    """Request rejected by a plugin (HTTP 403 Forbidden analogue)."""

    def __init__(self, plugin: str, message: str):
        super().__init__(f"admission denied by {plugin}: {message}")
        self.plugin = plugin
        self.message = message


@dataclass
class Attributes:
    """What a plugin may inspect (reference ``admission.Attributes``).

    ``obj`` is the incoming wire dict (mutable during the mutate phase);
    ``old_obj`` is the stored object on UPDATE/DELETE.  ``store`` gives
    plugins read access to cluster state (the reference hands plugins
    informers; one in-proc store plays that role here).  ``user`` is the
    authenticated username (empty until the auth stack fills it)."""

    operation: str
    kind: str
    namespace: str
    name: str
    obj: Optional[dict] = None
    old_obj: Optional[dict] = None
    store: Optional[Store] = None
    user: str = ""
    extras: dict = field(default_factory=dict)


class AdmissionPlugin:
    """Base plugin; override ``admit`` (mutate) and/or ``validate``."""

    name = "Plugin"
    # which operations the plugin cares about (reference Handles())
    operations = (CREATE, UPDATE)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.operation in self.operations

    def admit(self, attrs: Attributes) -> None:  # mutate phase
        pass

    def validate(self, attrs: Attributes) -> None:  # validate phase
        pass

    def deny(self, message: str):
        raise AdmissionDenied(self.name, message)


class AdmissionChain:
    """Runs every plugin's mutate pass, then every plugin's validate pass
    (reference ``chainAdmissionHandler`` — mutators before validators)."""

    def __init__(self, plugins: list[AdmissionPlugin]):
        self.plugins = list(plugins)
        # Reentrancy guard: writes a plugin itself issues against the store
        # (e.g. the quota plugin's CAS on ResourceQuota.status) must not
        # re-enter the chain.
        self._local = threading.local()

    def run(self, attrs: Attributes) -> None:
        if getattr(self._local, "depth", 0) > 0:
            return
        self._local.depth = 1
        try:
            for p in self.plugins:
                if p.handles(attrs):
                    p.admit(attrs)
            for p in self.plugins:
                if p.handles(attrs):
                    p.validate(attrs)
        finally:
            self._local.depth = 0


class AdmittedStore(Store):
    """Store with an admission chain on the write path.

    ``guaranteed_update`` and typed-client writes route through ``update``,
    so every mutation passes the chain; binds (``bind_many``) are the
    scheduler's commit path and bypass admission exactly as the reference's
    BindingREST does (no admission on subresources in this era)."""

    def __init__(self, chain: Optional[AdmissionChain] = None, **kwargs):
        super().__init__(**kwargs)
        self.chain = chain or AdmissionChain([])
        # per-request identity, set by the apiserver's auth filter; thread-
        # local because ThreadingHTTPServer handles requests concurrently
        self._user_local = threading.local()

    @property
    def user(self) -> str:
        return getattr(self._user_local, "name", "")

    @user.setter
    def user(self, name: str) -> None:
        self._user_local.name = name

    def _attrs(self, op: str, kind: str, obj: Optional[dict], old: Optional[dict],
               namespace: str, name: str) -> Attributes:
        return Attributes(
            operation=op, kind=kind, namespace=namespace, name=name,
            obj=obj, old_obj=old, store=self, user=self.user,
        )

    def create(self, kind: str, obj: dict, _trusted: bool = False) -> dict:
        """``_trusted`` passes through to ``Store.create``: the apiserver
        hands over the body it parsed for this request, which the chain
        mutates in place and the store may keep."""
        meta = obj.get("metadata") or {}
        self.chain.run(self._attrs(
            CREATE, kind, obj, None,
            meta.get("namespace", "default"), meta.get("name", ""),
        ))
        return super().create(kind, obj, _trusted=_trusted)

    def update(self, kind: str, obj: dict, expect_rev=None, _trusted: bool = False) -> dict:
        meta = obj.get("metadata") or {}
        namespace = meta.get("namespace", "default")
        name = meta.get("name", "")
        try:
            old = super().get(kind, namespace, name)
        except KeyError:
            old = None
        self.chain.run(self._attrs(UPDATE, kind, obj, old, namespace, name))
        return super().update(kind, obj, expect_rev=expect_rev, _trusted=_trusted)

    def delete(self, kind: str, namespace: str, name: str, expect_rev=None) -> dict:
        try:
            old = super().get(kind, namespace, name)
        except KeyError:
            old = None
        self.chain.run(self._attrs(DELETE, kind, None, old, namespace, name))
        return super().delete(kind, namespace, name, expect_rev=expect_rev)
