"""Dynamic resource registration: the CRD analogue.

Capability of ``staging/src/k8s.io/apiextensions-apiserver``: a
``CustomResourceDefinition`` object names a new kind; once registered,
that kind is a first-class citizen of the one type registry: typed
clients (``Clientset.client_for``), informers, and the wire apiserver's
per-request resource lookup pick it up with no further wiring.

Custom objects are schema-less wire dicts (the era's CRDs had no
validation schema either): ``DynamicObject`` keeps the raw dict and
exposes the standard ``meta`` / ``to_dict`` / ``from_dict`` surface every
component expects.

``register_custom_kind`` establishes a definition and
``unregister_custom_kind`` removes its kind; the controller that calls
them as CRD objects come and go (the apiextensions establish loop) is not
part of this package yet."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from .meta import ObjectMeta
from .types import (
    CLUSTER_SCOPED_KINDS,
    KIND_PLURALS,
    KINDS,
    register_cluster_scoped,
)


@dataclass
class DynamicObject:
    """A schema-less custom object: ObjectMeta + opaque payload."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    raw: dict = field(default_factory=dict)  # everything except kind/metadata

    KIND = "DynamicObject"  # overridden per registered class

    def to_dict(self) -> dict:
        d = copy.deepcopy(self.raw)
        d["kind"] = self.KIND
        d["metadata"] = self.meta.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DynamicObject":
        raw = {k: copy.deepcopy(v) for k, v in d.items() if k not in ("kind", "metadata")}
        return cls(meta=ObjectMeta.from_dict(d.get("metadata") or {}), raw=raw)


def make_dynamic_kind(kind: str) -> type:
    """Mint a DynamicObject subclass whose KIND is ``kind``."""
    return type(kind, (DynamicObject,), {"KIND": kind})


@register_cluster_scoped
@dataclass
class CustomResourceDefinition:
    """The definition object (reference ``apiextensions/v1beta1.
    CustomResourceDefinition``): names.kind + names.plural + scope."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    kind_name: str = ""  # the custom kind, e.g. "Widget"
    plural: str = ""  # REST resource segment, e.g. "widgets"
    scope: str = "Namespaced"  # Namespaced | Cluster
    established: bool = False  # status: accepted + registered

    KIND = "CustomResourceDefinition"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "names": {"kind": self.kind_name, "plural": self.plural},
                "scope": self.scope,
            },
            "status": {"established": self.established},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CustomResourceDefinition":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        spec = d.get("spec") or {}
        names = spec.get("names") or {}
        return cls(
            meta=meta,
            kind_name=names.get("kind", ""),
            plural=names.get("plural", ""),
            scope=spec.get("scope", "Namespaced"),
            established=bool((d.get("status") or {}).get("established")),
        )


def register_custom_kind(crd: CustomResourceDefinition) -> Optional[type]:
    """Establish a CRD: add its kind to the live registry (idempotent).
    Returns the dynamic class, or None if the kind name collides with a
    built-in of a different shape."""
    if not crd.kind_name or not crd.plural:
        return None
    existing = KINDS.get(crd.kind_name)
    if existing is not None:
        return existing if issubclass(existing, DynamicObject) else None
    cls = make_dynamic_kind(crd.kind_name)
    KINDS[crd.kind_name] = cls
    KIND_PLURALS[crd.kind_name] = crd.plural
    if crd.scope == "Cluster":
        CLUSTER_SCOPED_KINDS.add(crd.kind_name)
    return cls


def unregister_custom_kind(kind_name: str) -> None:
    """CRD deleted: the kind disappears from the registry (custom objects
    themselves are cleaned up by the namespace/GC machinery as usual)."""
    cls = KINDS.get(kind_name)
    if cls is not None and issubclass(cls, DynamicObject):
        KINDS.pop(kind_name, None)
        KIND_PLURALS.pop(kind_name, None)
        CLUSTER_SCOPED_KINDS.discard(kind_name)
