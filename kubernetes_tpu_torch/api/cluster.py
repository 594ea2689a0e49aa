"""The namespace, config, quota, storage, priority and policy kinds that
the default admission chain reads, or that a client must be able to POST
for it to read.

Capability equivalents of the reference internal types:

- Namespace, Secret, ServiceAccount: ``pkg/api/types.go`` (Namespace
  ~:3010, Secret ~:3330, ServiceAccount ~:2960);
- ResourceQuota / LimitRange: ``pkg/api/types.go`` (~:3180 / ~:3120),
  enforced by admission (``plugin/pkg/admission/resourcequota``,
  ``limitranger``);
- PodPreset: ``pkg/apis/settings/types.go``;
- StorageClass: ``pkg/apis/storage/types.go``;
- PriorityClass: ``pkg/apis/scheduling/types.go`` (PodPriority gate);
- PodSecurityPolicy: ``pkg/apis/extensions``;
- NetworkPolicy: ``pkg/apis/networking/types.go``.

Every kind registers under the JAX package's plural and scope, so
``kind_for_plural`` routes the same paths, and serializes to the same
wire dict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .meta import ObjectMeta
from .quantity import Quantity
from .selectors import LabelSelector
from .types import (
    _res_from_dict,
    _res_to_dict,
    register_cluster_scoped as _register_cluster_scoped,
    register_kind,
)

@_register_cluster_scoped
@dataclass
class Namespace:
    """Namespace with phase + finalizers (reference ``pkg/api/types.go``
    Namespace; lifecycle in ``pkg/controller/namespace``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    phase: str = "Active"  # Active | Terminating
    spec_finalizers: list[str] = field(default_factory=lambda: ["kubernetes"])

    KIND = "Namespace"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {"finalizers": list(self.spec_finalizers)},
            "status": {"phase": self.phase},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Namespace":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        return cls(
            meta=meta,
            phase=(d.get("status") or {}).get("phase", "Active"),
            spec_finalizers=list((d.get("spec") or {}).get("finalizers") or []),
        )


@register_kind
@dataclass
class Secret:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Opaque"
    data: dict[str, str] = field(default_factory=dict)  # values pre-encoded

    KIND = "Secret"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "type": self.type,
            "data": dict(self.data),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Secret":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            type=d.get("type", "Opaque"),
            data=dict(d.get("data") or {}),
        )


@register_kind
@dataclass
class ServiceAccount:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: list[str] = field(default_factory=list)  # token Secret names

    KIND = "ServiceAccount"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "secrets": list(self.secrets),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceAccount":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            secrets=list(d.get("secrets") or []),
        )


@register_kind
@dataclass
class ResourceQuota:
    """Per-namespace aggregate limits; ``hard`` is the ceiling, ``used`` is
    maintained by admission + the quota controller."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    hard: dict[str, Quantity] = field(default_factory=dict)
    used: dict[str, Quantity] = field(default_factory=dict)
    scopes: list[str] = field(default_factory=list)  # e.g. BestEffort, NotBestEffort

    KIND = "ResourceQuota"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {"hard": _res_to_dict(self.hard), "scopes": list(self.scopes)},
            "status": {"hard": _res_to_dict(self.hard), "used": _res_to_dict(self.used)},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ResourceQuota":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            hard=_res_from_dict(spec.get("hard")),
            used=_res_from_dict(status.get("used")),
            scopes=list(spec.get("scopes") or []),
        )


@dataclass
class LimitRangeItem:
    type: str = "Container"  # Container | Pod
    max: dict[str, Quantity] = field(default_factory=dict)
    min: dict[str, Quantity] = field(default_factory=dict)
    default: dict[str, Quantity] = field(default_factory=dict)  # default limits
    default_request: dict[str, Quantity] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "max": _res_to_dict(self.max),
            "min": _res_to_dict(self.min),
            "default": _res_to_dict(self.default),
            "defaultRequest": _res_to_dict(self.default_request),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LimitRangeItem":
        return cls(
            type=d.get("type", "Container"),
            max=_res_from_dict(d.get("max")),
            min=_res_from_dict(d.get("min")),
            default=_res_from_dict(d.get("default")),
            default_request=_res_from_dict(d.get("defaultRequest")),
        )


@register_kind
@dataclass
class PodPreset:
    """Pod injection policy (reference ``pkg/apis/settings/types.go``;
    applied by the PodPreset admission plugin to matching pods at
    create)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    env: dict = field(default_factory=dict)
    volumes: list = field(default_factory=list)  # wire-form volume dicts

    KIND = "PodPreset"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "selector": self.selector.to_dict(),
                "env": dict(self.env),
                "volumes": [dict(v) for v in self.volumes],
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PodPreset":
        spec = d.get("spec") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            env=dict(spec.get("env") or {}),
            volumes=[dict(v) for v in spec.get("volumes") or []],
        )


@register_kind
@dataclass
class LimitRange:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    limits: list[LimitRangeItem] = field(default_factory=list)

    KIND = "LimitRange"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {"limits": [l.to_dict() for l in self.limits]},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LimitRange":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            limits=[
                LimitRangeItem.from_dict(l)
                for l in (d.get("spec") or {}).get("limits") or []
            ],
        )


@_register_cluster_scoped
@dataclass
class StorageClass:
    """Dynamic-provisioning template (reference ``pkg/apis/storage/types.go``;
    consumed by the PV controller's provisioner and the DefaultStorageClass
    admission plugin)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""  # "" = no dynamic provisioning for this class
    reclaim_policy: str = "Delete"
    parameters: dict = field(default_factory=dict)
    is_default: bool = False  # reference: the is-default-class annotation

    KIND = "StorageClass"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "provisioner": self.provisioner,
            "reclaimPolicy": self.reclaim_policy,
            "parameters": dict(self.parameters),
            "isDefault": self.is_default,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StorageClass":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        return cls(
            meta=meta,
            provisioner=d.get("provisioner", ""),
            reclaim_policy=d.get("reclaimPolicy", "Delete"),
            parameters=dict(d.get("parameters") or {}),
            is_default=bool(d.get("isDefault")),
        )


@_register_cluster_scoped
@dataclass
class PriorityClass:
    """Named pod priority (reference ``pkg/apis/scheduling/types.go``;
    resolved into ``pod.spec.priority`` by the Priority admission plugin)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    description: str = ""

    KIND = "PriorityClass"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "value": self.value,
            "globalDefault": self.global_default,
            "description": self.description,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PriorityClass":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        return cls(
            meta=meta,
            value=int(d.get("value", 0)),
            global_default=bool(d.get("globalDefault", False)),
            description=d.get("description", ""),
        )


@dataclass
class PodSecurityPolicy:
    """Cluster-scoped pod security policy (reference
    ``pkg/apis/extensions`` PodSecurityPolicy; admission at
    ``plugin/pkg/admission/security/podsecuritypolicy``): what a pod may
    request — privilege, host namespaces, user ranges, volume kinds."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    privileged: bool = False
    host_pid: bool = False
    host_ipc: bool = False
    host_network: bool = False
    # {"rule": "RunAsAny"} or {"rule": "MustRunAs", "min": N, "max": M}
    run_as_user: dict = field(default_factory=lambda: {"rule": "RunAsAny"})
    # volume disk kinds a pod may mount; ["*"] = all
    allowed_volume_kinds: list = field(default_factory=lambda: ["*"])

    KIND = "PodSecurityPolicy"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "privileged": self.privileged,
                "hostPID": self.host_pid,
                "hostIPC": self.host_ipc,
                "hostNetwork": self.host_network,
                "runAsUser": dict(self.run_as_user),
                "allowedVolumeKinds": list(self.allowed_volume_kinds),
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PodSecurityPolicy":
        spec = d.get("spec") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            privileged=bool(spec.get("privileged", False)),
            host_pid=bool(spec.get("hostPID", False)),
            host_ipc=bool(spec.get("hostIPC", False)),
            host_network=bool(spec.get("hostNetwork", False)),
            run_as_user=dict(spec.get("runAsUser") or {"rule": "RunAsAny"}),
            allowed_volume_kinds=(list(spec["allowedVolumeKinds"])
                                  if spec.get("allowedVolumeKinds") is not None
                                  else ["*"]),
        )


register_kind(PodSecurityPolicy, cluster_scoped=True,
              plural="podsecuritypolicies")


@dataclass
class NetworkPolicyPort:
    """Port a rule allows traffic on (reference
    ``pkg/apis/networking/types.go:80 NetworkPolicyPort``): protocol
    defaults to TCP; port may be numeric, a named container port, or
    absent (all ports)."""

    protocol: str = "TCP"
    port: Optional[object] = None  # int | str (named) | None = all

    def to_dict(self) -> dict:
        d: dict = {"protocol": self.protocol}
        if self.port is not None:
            d["port"] = self.port
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkPolicyPort":
        return cls(protocol=d.get("protocol", "TCP"), port=d.get("port"))


@dataclass
class NetworkPolicyPeer:
    """Traffic source (``types.go:94 NetworkPolicyPeer``): exactly one of
    podSelector (same namespace) or namespaceSelector."""

    pod_selector: Optional[LabelSelector] = None
    namespace_selector: Optional[LabelSelector] = None

    def to_dict(self) -> dict:
        d: dict = {}
        if self.pod_selector is not None:
            d["podSelector"] = self.pod_selector.to_dict()
        if self.namespace_selector is not None:
            d["namespaceSelector"] = self.namespace_selector.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkPolicyPeer":
        return cls(
            pod_selector=(LabelSelector.from_dict(d["podSelector"])
                          if "podSelector" in d else None),
            namespace_selector=(LabelSelector.from_dict(d["namespaceSelector"])
                                if "namespaceSelector" in d else None),
        )


@dataclass
class NetworkPolicyIngressRule:
    """One allowed-traffic rule (``types.go:60``): empty ports = all
    ports; empty from = all sources; a rule matches ports AND from."""

    ports: list = field(default_factory=list)   # [NetworkPolicyPort]
    from_peers: list = field(default_factory=list)  # [NetworkPolicyPeer]

    def to_dict(self) -> dict:
        d: dict = {}
        if self.ports:
            d["ports"] = [p.to_dict() for p in self.ports]
        if self.from_peers:
            d["from"] = [p.to_dict() for p in self.from_peers]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkPolicyIngressRule":
        return cls(
            ports=[NetworkPolicyPort.from_dict(x) for x in d.get("ports") or []],
            from_peers=[NetworkPolicyPeer.from_dict(x) for x in d.get("from") or []],
        )


@dataclass
class NetworkPolicy:
    """Pod-traffic isolation policy (reference
    ``pkg/apis/networking/types.go:29``; REST storage
    ``pkg/registry/networking/networkpolicy``).  Like the reference era,
    the API object is the contract (enforcement was CNI-plugin-side
    there); selection semantics
    (podSelector picks the isolated pods; ingress rules are additive
    across policies; a selected pod with zero rules accepts nothing)
    are what the type carries."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    ingress: list = field(default_factory=list)  # [NetworkPolicyIngressRule]

    KIND = "NetworkPolicy"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "podSelector": self.pod_selector.to_dict(),
                "ingress": [r.to_dict() for r in self.ingress],
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkPolicy":
        spec = d.get("spec") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            pod_selector=LabelSelector.from_dict(spec.get("podSelector")),
            ingress=[NetworkPolicyIngressRule.from_dict(x)
                     for x in spec.get("ingress") or []],
        )

    # -- selection semantics ----------------------------------------------
    def selects(self, pod) -> bool:
        return self.pod_selector.matches(pod.meta.labels)

    def allows(self, from_pod, from_namespace_labels: dict,
               to_port: Optional[int] = None,
               to_port_name: str = "",
               protocol: str = "TCP") -> bool:
        """Does any ingress rule admit ``protocol`` traffic from
        ``from_pod``?  (``from_namespace_labels``: labels of the source
        namespace.)  A podSelector peer only selects pods in the
        policy's OWN namespace — cross-namespace sources must match a
        namespaceSelector peer."""
        for rule in self.ingress:
            if rule.ports:
                port_ok = any(
                    p.protocol == protocol
                    and ((p.port is None)
                         or (isinstance(p.port, int) and p.port == to_port)
                         or (isinstance(p.port, str) and p.port == to_port_name))
                    for p in rule.ports)
                if not port_ok:
                    continue
            if not rule.from_peers:
                return True
            for peer in rule.from_peers:
                if peer.pod_selector is not None:
                    if (from_pod.meta.namespace == self.meta.namespace
                            and peer.pod_selector.matches(from_pod.meta.labels)):
                        return True
                elif peer.namespace_selector is not None:
                    if peer.namespace_selector.matches(from_namespace_labels):
                        return True
        return False


register_kind(NetworkPolicy, plural="networkpolicies")
