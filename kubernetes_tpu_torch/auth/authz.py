"""Authorization (SURVEY.md §2.9): may this user do this verb on this
resource.

Capability equivalents of the reference's authorizer modes
(``pkg/kubeapiserver/authorizer/config.go`` union of: AlwaysAllow, ABAC,
RBAC (``plugin/pkg/auth/authorizer/rbac/rbac.go``), Node
(``plugin/pkg/auth/authorizer/node``), Webhook).  Decisions follow the
reference's tri-state: allow / deny-with-no-opinion (next authorizer in the
union gets a say) — a final no-opinion is a deny.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Callable, Optional

from ..store.store import Store
from .authn import UserInfo

ALLOW = "allow"
DENY = "deny"
NO_OPINION = "no-opinion"


@dataclass
class AuthzAttributes:
    """Reference ``authorization/authorizer.Attributes``."""

    user: UserInfo
    verb: str  # get|list|watch|create|update|delete|bind|…
    resource: str  # plural resource name ("" for non-resource paths)
    namespace: str = ""
    name: str = ""
    path: str = ""  # non-resource path (e.g. /healthz)


class Authorizer:
    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        """Returns (decision, reason)."""
        raise NotImplementedError


class AlwaysAllow(Authorizer):
    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        return ALLOW, "always-allow"


class RBACAuthorizer(Authorizer):
    """Evaluates Role/ClusterRole bindings stored in the cluster (reference
    ``plugin/pkg/auth/authorizer/rbac/rbac.go:74 Authorize`` — visit every
    binding that names the subject, test each rule)."""

    def __init__(self, store: Store):
        self.store = store

    def _subject_matches(self, subject: dict, user: UserInfo) -> bool:
        kind = subject.get("kind", "User")
        name = subject.get("name", "")
        if kind == "User":
            return name == user.name
        if kind == "Group":
            return name in user.groups
        if kind == "ServiceAccount":
            sa_user = f"system:serviceaccount:{subject.get('namespace', '')}:{name}"
            return sa_user == user.name
        return False

    def _rules_for(self, role_kind: str, role_name: str, namespace: str) -> list[dict]:
        try:
            if role_kind == "ClusterRole":
                role = self.store.get("ClusterRole", "", role_name)
            else:
                role = self.store.get("Role", namespace, role_name)
        except KeyError:
            return []
        return role.get("rules") or []

    def _rule_allows(self, rule: dict, attrs: AuthzAttributes) -> bool:
        verbs = rule.get("verbs") or []
        resources = rule.get("resources") or []
        names = rule.get("resourceNames") or []
        if "*" not in verbs and attrs.verb not in verbs:
            return False
        if "*" not in resources and attrs.resource not in resources:
            return False
        if names and attrs.name not in names:
            return False
        return True

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        # cluster-wide grants
        bindings, _ = self.store.list("ClusterRoleBinding", None)
        for b in bindings:
            if not any(self._subject_matches(s, attrs.user) for s in b.get("subjects") or []):
                continue
            ref = b.get("roleRef") or {}
            for rule in self._rules_for(ref.get("kind", "ClusterRole"), ref.get("name", ""), ""):
                if self._rule_allows(rule, attrs):
                    return ALLOW, f"ClusterRoleBinding {b['metadata']['name']}"
        # namespaced grants
        if attrs.namespace:
            bindings, _ = self.store.list("RoleBinding", attrs.namespace)
            for b in bindings:
                if not any(self._subject_matches(s, attrs.user) for s in b.get("subjects") or []):
                    continue
                ref = b.get("roleRef") or {}
                for rule in self._rules_for(
                    ref.get("kind", "Role"), ref.get("name", ""), attrs.namespace
                ):
                    if self._rule_allows(rule, attrs):
                        return ALLOW, f"RoleBinding {attrs.namespace}/{b['metadata']['name']}"
        return NO_OPINION, "no RBAC policy matched"


class NodeAuthorizer(Authorizer):
    """Scopes kubelet credentials to their own node's objects (reference
    ``plugin/pkg/auth/authorizer/node`` — a graph walk from node to the
    pods bound to it and the secrets/configmaps those pods reference)."""

    NODE_USER_PREFIX = "system:node:"

    def __init__(self, store: Store):
        self.store = store

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        if not attrs.user.name.startswith(self.NODE_USER_PREFIX):
            return NO_OPINION, "not a node user"
        node_name = attrs.user.name[len(self.NODE_USER_PREFIX):]
        # Out-of-scope checks return NO_OPINION (not DENY) so a union can
        # still consult RBAC for explicit grants to node identities — the
        # reference node authorizer never hard-denies.
        if attrs.resource == "nodes":
            if attrs.name in ("", node_name):
                return ALLOW, "node accessing own Node object"
            return NO_OPINION, f"node {node_name} has no default access to node {attrs.name}"
        if attrs.resource == "pods":
            if attrs.verb in ("list", "watch"):
                return ALLOW, "node watching pod assignments"
            if attrs.name:
                try:
                    pod = self.store.get("Pod", attrs.namespace, attrs.name)
                except KeyError:
                    return NO_OPINION, "pod not found"
                if (pod.get("spec") or {}).get("nodeName") == node_name:
                    return ALLOW, "pod is bound to this node"
                return NO_OPINION, f"pod not bound to node {node_name}"
        if attrs.resource in ("secrets", "configmaps"):
            # graph edge: secret/configmap referenced by a pod on this node
            pods, _ = self.store.list("Pod", attrs.namespace)
            for pod in pods:
                if (pod.get("spec") or {}).get("nodeName") != node_name:
                    continue
                for v in (pod.get("spec") or {}).get("volumes") or []:
                    if v.get("secretName") == attrs.name or v.get("configMapName") == attrs.name:
                        return ALLOW, "referenced by pod on this node"
            return NO_OPINION, f"{attrs.resource[:-1]} not referenced by any pod on {node_name}"
        if attrs.resource in ("events",):
            return ALLOW, "nodes may emit events"
        return NO_OPINION, "resource outside node scope"


class ABACAuthorizer(Authorizer):
    """Static policy list (reference ``pkg/auth/authorizer/abac`` — one
    JSON policy object per line; ``*`` wildcards)."""

    def __init__(self, policies: list[dict]):
        self.policies = list(policies)

    @classmethod
    def from_file(cls, path: str) -> "ABACAuthorizer":
        import json

        policies = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    policies.append(json.loads(line))
        return cls(policies)

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        for p in self.policies:
            spec = p.get("spec", p)  # tolerate both wrapped and bare policies
            user = spec.get("user", "")
            group = spec.get("group", "")
            if user and user != "*" and user != attrs.user.name:
                continue
            if group and group != "*" and group not in attrs.user.groups:
                continue
            if not fnmatch.fnmatch(attrs.resource, spec.get("resource", "*") or "*"):
                continue
            ns = spec.get("namespace", "*") or "*"
            if ns != "*" and ns != attrs.namespace:
                continue
            verb = spec.get("verb", "*") or "*"
            if verb != "*" and verb != attrs.verb:
                continue
            if spec.get("readonly") and attrs.verb not in ("get", "list", "watch"):
                continue
            return ALLOW, "ABAC policy matched"
        return NO_OPINION, "no ABAC policy matched"


class WebhookAuthorizer(Authorizer):
    """Delegates to a callable (reference ``plugin/pkg/auth/authorizer/webhook``
    posts a SubjectAccessReview; here the hook is any callable with the same
    contract)."""

    def __init__(self, hook: Callable[[AuthzAttributes], tuple[str, str]]):
        self.hook = hook

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        return self.hook(attrs)


class UnionAuthorizer(Authorizer):
    """First allow or deny wins; no-opinion falls through (reference
    ``authorization/union``)."""

    def __init__(self, *authorizers: Authorizer):
        self.authorizers = list(authorizers)

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        reasons = []
        for a in self.authorizers:
            decision, reason = a.authorize(attrs)
            if decision in (ALLOW, DENY):
                return decision, reason
            reasons.append(reason)
        return DENY, "; ".join(reasons) or "no authorizer had an opinion"


# privileged groups that bypass RBAC (reference bootstrap policy binds
# system:masters to cluster-admin)
MASTERS_GROUP = "system:masters"


class BootstrapPolicyAuthorizer(Authorizer):
    """system:masters → cluster-admin (reference
    ``plugin/pkg/auth/authorizer/rbac/bootstrappolicy``)."""

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        if MASTERS_GROUP in attrs.user.groups:
            return ALLOW, "system:masters"
        return NO_OPINION, "not a master"


class AuthenticatedOrDiscovery(Authorizer):
    """The cert-mode default for a self-hosted control plane: any
    AUTHENTICATED identity (client cert, token) is allowed; anonymous
    requests are scoped to exactly the join-discovery surface — reading
    kube-public configmaps (cluster-info) and /healthz — the effective
    grant kubeadm's RBAC bootstrap gives ``system:unauthenticated``."""

    def authorize(self, attrs: AuthzAttributes) -> tuple[str, str]:
        if attrs.user.authenticated:
            return ALLOW, "authenticated"
        if (attrs.verb in ("get", "list")
                and attrs.resource == "configmaps"
                and attrs.namespace == "kube-public"):
            return ALLOW, "anonymous discovery (cluster-info)"
        if attrs.verb == "get" and attrs.path in ("/healthz", "/version"):
            return ALLOW, "anonymous health"
        return DENY, "anonymous access is limited to join discovery"
