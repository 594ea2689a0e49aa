"""The API kinds the batch scheduling path reads: Pod, Node and the objects
that shape scoring and filtering (Service, ReplicaSet,
ReplicationController, StatefulSet as spread owners; PersistentVolumeClaim
and PersistentVolume for the volume predicates).

Only the fields the scheduler's predicates, priorities and tensorizer read
are kept.  ``to_dict`` remains on the nested pod-spec kinds because the
scheduling-equivalence key (``models.snapshot.pod_signature_key``) freezes
their dict images.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .meta import ObjectMeta
from .quantity import Quantity
from .selectors import LabelSelector, NodeSelector

# -- resource names ---------------------------------------------------------
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
GPU = "nvidia.com/gpu"

# Taint effects
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Node condition types
NODE_READY = "Ready"
NODE_MEMORY_PRESSURE = "MemoryPressure"
NODE_DISK_PRESSURE = "DiskPressure"

# QoS classes
GUARANTEED = "Guaranteed"
BURSTABLE = "Burstable"
BEST_EFFORT = "BestEffort"

# Well-known label keys
HOSTNAME_LABEL = "kubernetes.io/hostname"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"


@dataclass
class ResourceRequirements:
    requests: dict[str, Quantity] = field(default_factory=dict)
    limits: dict[str, Quantity] = field(default_factory=dict)


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: list[ContainerPort] = field(default_factory=list)


@dataclass
class Volume:
    """Only what scheduling predicates consume.  ``disk_id`` is the
    exclusive-attachment id behind NoDiskConflict / MaxVolumeCount;
    ``pvc_name`` a persistentVolumeClaim reference (zone / volume-node
    predicates)."""

    name: str = ""
    disk_id: str = ""
    disk_kind: str = ""  # "gce-pd" | "aws-ebs" | "azure-disk" | "rbd" | "iscsi" | ""
    read_only: bool = False
    pvc_name: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "diskID": self.disk_id,
            "diskKind": self.disk_kind,
            "readOnly": self.read_only,
            "pvcName": self.pvc_name,
        }


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value

    def to_dict(self) -> dict:
        d = {
            "key": self.key,
            "operator": self.operator,
            "value": self.value,
            "effect": self.effect,
        }
        if self.toleration_seconds is not None:
            d["tolerationSeconds"] = self.toleration_seconds
        return d


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass
class PodAffinityTerm:
    """One (anti)affinity term: pods selected by ``selector`` in
    ``namespaces`` (empty → the term-owner pod's namespace), spread/packed
    over ``topology_key``."""

    selector: Optional[LabelSelector] = None
    topology_key: str = HOSTNAME_LABEL
    namespaces: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "labelSelector": self.selector.to_dict() if self.selector else None,
            "topologyKey": self.topology_key,
            "namespaces": list(self.namespaces),
        }


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)

    def to_dict(self) -> dict:
        return {"weight": self.weight, "podAffinityTerm": self.term.to_dict()}


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: object = None  # selectors.NodeSelectorTerm

    def to_dict(self) -> dict:
        return {"weight": self.weight, "preference": self.preference.to_dict()}


@dataclass
class Affinity:
    node_affinity_required: Optional[NodeSelector] = None
    node_affinity_preferred: list[PreferredSchedulingTerm] = field(default_factory=list)
    pod_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "nodeAffinityRequired": self.node_affinity_required.to_dict()
            if self.node_affinity_required
            else None,
            "nodeAffinityPreferred": [t.to_dict() for t in self.node_affinity_preferred],
            "podAffinityRequired": [t.to_dict() for t in self.pod_affinity_required],
            "podAffinityPreferred": [t.to_dict() for t in self.pod_affinity_preferred],
            "podAntiAffinityRequired": [t.to_dict() for t in self.pod_anti_affinity_required],
            "podAntiAffinityPreferred": [t.to_dict() for t in self.pod_anti_affinity_preferred],
        }


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)

    KIND = "Pod"

    def qos_class(self) -> str:
        """QoS class from cpu+mem requests and limits."""
        requests: dict[str, Quantity] = {}
        limits: dict[str, Quantity] = {}
        guaranteed = True
        for c in self.spec.containers:
            for name in (CPU, MEMORY):
                q = c.resources.requests.get(name)
                if q is not None and not q.is_zero():
                    requests[name] = requests.get(name, Quantity(0)) + q
                lim = c.resources.limits.get(name)
                if lim is not None and not lim.is_zero():
                    limits[name] = limits.get(name, Quantity(0)) + lim
                else:
                    guaranteed = False
        if not requests and not limits:
            return BEST_EFFORT
        if guaranteed and all(requests.get(n) == limits.get(n) for n in (CPU, MEMORY)):
            return GUARANTEED
        return BURSTABLE

    def host_ports(self) -> list[tuple[str, int]]:
        out = []
        for c in self.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    out.append((p.protocol, p.host_port))
        return out


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = ""
    status: str = "False"  # "True" | "False" | "Unknown"


@dataclass
class NodeSpec:
    taints: list[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    capacity: dict[str, Quantity] = field(default_factory=dict)
    allocatable: dict[str, Quantity] = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)
    images: list[dict] = field(default_factory=list)  # {"names": [...], "sizeBytes": N}

    def condition(self, ctype: str) -> Optional[NodeCondition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"


# ---------------------------------------------------------------------------
# Spread owners (SelectorSpreadPriority reads ``meta`` and ``selector``)
# ---------------------------------------------------------------------------


@dataclass
class Service:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict[str, str] = field(default_factory=dict)

    KIND = "Service"


@dataclass
class ReplicaSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)

    KIND = "ReplicaSet"


@dataclass
class ReplicationController:
    """ReplicaSet with a plain map selector; an empty selector defaults to
    the template labels."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector_labels: dict = field(default_factory=dict)
    template_labels: dict = field(default_factory=dict)

    KIND = "ReplicationController"

    @property
    def selector(self) -> LabelSelector:
        return LabelSelector.from_match_labels(
            self.selector_labels or self.template_labels)


@dataclass
class StatefulSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)

    KIND = "StatefulSet"


# ---------------------------------------------------------------------------
# Storage (NoVolumeZoneConflict / NoVolumeNodeConflict)
# ---------------------------------------------------------------------------


@dataclass
class PersistentVolume:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    zone: str = ""  # topology constraint (NoVolumeZoneConflict)
    node_affinity: Optional[NodeSelector] = None  # local-volume pinning

    KIND = "PersistentVolume"


@dataclass
class PersistentVolumeClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    volume_name: str = ""  # bound PV name

    KIND = "PersistentVolumeClaim"
