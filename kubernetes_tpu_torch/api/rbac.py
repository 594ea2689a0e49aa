"""RBAC policy API types (reference ``pkg/apis/rbac/types.go``:
PolicyRule :47, Role :103, RoleBinding :118, ClusterRole :135,
ClusterRoleBinding :150; evaluated by
``plugin/pkg/auth/authorizer/rbac/rbac.go``).

Registered with the port's kind registry, so the store, the typed
clientset (``cs.clusterroles``, ``cs.rolebindings``, ...) and the wire
(``/api/v1/clusterrolebindings``) address them; ``auth.RBACAuthorizer``
reads them.  The wire form is the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta
from .types import register_cluster_scoped as _register_cluster_scoped, register_kind

ALL = "*"  # matches any verb/resource/name (reference rbac.APIGroupAll etc.)


@dataclass
class PolicyRule:
    verbs: list[str] = field(default_factory=list)
    resources: list[str] = field(default_factory=list)
    resource_names: list[str] = field(default_factory=list)

    def matches(self, verb: str, resource: str, name: str = "") -> bool:
        """Reference ``rbac.go RuleAllows`` semantics."""
        if ALL not in self.verbs and verb not in self.verbs:
            return False
        if ALL not in self.resources and resource not in self.resources:
            return False
        if self.resource_names and name not in self.resource_names:
            return False
        return True

    def to_dict(self) -> dict:
        return {
            "verbs": list(self.verbs),
            "resources": list(self.resources),
            "resourceNames": list(self.resource_names),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRule":
        return cls(
            verbs=list(d.get("verbs") or []),
            resources=list(d.get("resources") or []),
            resource_names=list(d.get("resourceNames") or []),
        )


@dataclass
class Subject:
    kind: str = "User"  # User | Group | ServiceAccount
    name: str = ""
    namespace: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "namespace": self.namespace}

    @classmethod
    def from_dict(cls, d: dict) -> "Subject":
        return cls(
            kind=d.get("kind", "User"),
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
        )


def _role_to_dict(self) -> dict:
    return {
        "kind": self.KIND,
        "metadata": self.meta.to_dict(),
        "rules": [r.to_dict() for r in self.rules],
    }


@register_kind
@dataclass
class Role:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    rules: list[PolicyRule] = field(default_factory=list)

    KIND = "Role"
    to_dict = _role_to_dict

    @classmethod
    def from_dict(cls, d: dict) -> "Role":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            rules=[PolicyRule.from_dict(r) for r in d.get("rules") or []],
        )


@_register_cluster_scoped
@dataclass
class ClusterRole:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    rules: list[PolicyRule] = field(default_factory=list)

    KIND = "ClusterRole"
    to_dict = _role_to_dict

    def __post_init__(self):
        self.meta.namespace = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterRole":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        return cls(
            meta=meta,
            rules=[PolicyRule.from_dict(r) for r in d.get("rules") or []],
        )


def _binding_to_dict(self) -> dict:
    return {
        "kind": self.KIND,
        "metadata": self.meta.to_dict(),
        "subjects": [s.to_dict() for s in self.subjects],
        "roleRef": {"kind": self.role_kind, "name": self.role_name},
    }


@register_kind
@dataclass
class RoleBinding:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: list[Subject] = field(default_factory=list)
    role_kind: str = "Role"  # Role | ClusterRole
    role_name: str = ""

    KIND = "RoleBinding"
    to_dict = _binding_to_dict

    @classmethod
    def from_dict(cls, d: dict) -> "RoleBinding":
        ref = d.get("roleRef") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            subjects=[Subject.from_dict(s) for s in d.get("subjects") or []],
            role_kind=ref.get("kind", "Role"),
            role_name=ref.get("name", ""),
        )


@_register_cluster_scoped
@dataclass
class ClusterRoleBinding:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: list[Subject] = field(default_factory=list)
    role_kind: str = "ClusterRole"
    role_name: str = ""

    KIND = "ClusterRoleBinding"
    to_dict = _binding_to_dict

    def __post_init__(self):
        self.meta.namespace = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterRoleBinding":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        ref = d.get("roleRef") or {}
        return cls(
            meta=meta,
            subjects=[Subject.from_dict(s) for s in d.get("subjects") or []],
            role_kind=ref.get("kind", "ClusterRole"),
            role_name=ref.get("name", ""),
        )
