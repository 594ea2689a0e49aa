"""Object metadata — the capability of the reference's ``metav1.ObjectMeta``
(``staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go``).

Every stored object carries name/namespace/uid/resourceVersion/labels/
annotations plus ownerReferences and deletion bookkeeping.  Serialization is
plain dicts (JSON-shaped); the store assigns ``uid`` and maintains
``resource_version`` the way etcd maintains ``mod_revision``.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Optional

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter):08d}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OwnerReference":
        return cls(
            kind=d.get("kind", ""),
            name=d.get("name", ""),
            uid=d.get("uid", ""),
            controller=bool(d.get("controller", False)),
        )


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    creation_revision: int = 0
    deletion_revision: Optional[int] = None  # tombstone for graceful deletion
    generation: int = 0
    # Deletion is blocked until every finalizer is removed (reference
    # registry/generic/registry/store.go:977 graceful deletion + finalizers;
    # used by the namespace controller and the garbage collector).
    finalizers: list[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        """namespace/name — the store key suffix (like etcd key paths)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    def controller_ref(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "resourceVersion": self.resource_version,
            "creationRevision": self.creation_revision,
            "generation": self.generation,
        }
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.owner_references:
            d["ownerReferences"] = [r.to_dict() for r in self.owner_references]
        if self.deletion_revision is not None:
            d["deletionRevision"] = self.deletion_revision
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid", ""),
            resource_version=int(d.get("resourceVersion", 0)),
            creation_revision=int(d.get("creationRevision", 0)),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            owner_references=[
                OwnerReference.from_dict(r) for r in d.get("ownerReferences") or []
            ],
            deletion_revision=d.get("deletionRevision"),
            generation=int(d.get("generation", 0)),
            finalizers=list(d.get("finalizers") or []),
        )
