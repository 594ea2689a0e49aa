"""The core API kinds: Pod, Node, Binding, Event, the spread owners
(Service, ReplicaSet, ReplicationController), Deployment and the volume
kinds (PersistentVolumeClaim, PersistentVolume).  The other kinds live in
``apps``, ``cluster``, ``rbac`` and ``crd``, and register on import.

The wire form is JSON-shaped dicts (``to_dict``/``from_dict``), the
store's serialization unit; a kind gives the same dict as its counterpart
in the reference package.  ``register_kind`` records each stored kind for
the clientset (``KINDS``, ``KIND_PLURALS``, ``CLUSTER_SCOPED_KINDS``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from .meta import ObjectMeta
from .quantity import Quantity
from .selectors import LabelSelector, NodeSelector

# -- resource names (reference pkg/api/types.go ResourceName consts) --------
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
GPU = "nvidia.com/gpu"  # reference-era ResourceNvidiaGPU / accelerator

# Pod phases
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"

# Taint effects (reference pkg/api/types.go TaintEffect)
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# the era's node-failure taint keys (taint_controller.go): the node
# lifecycle controller applies them, DefaultTolerationSeconds tolerates them
TAINT_NODE_NOT_READY = "node.alpha.kubernetes.io/notReady"
TAINT_NODE_UNREACHABLE = "node.alpha.kubernetes.io/unreachable"

# stamped on ReplicaSets by the deployment controller; read by kubectl
# rollout history/undo (reference deployment/util annotation constants)
DEPLOYMENT_REVISION_ANNOTATION = "deployment.kubernetes.io/revision"

# Node condition types
NODE_READY = "Ready"
NODE_MEMORY_PRESSURE = "MemoryPressure"
NODE_DISK_PRESSURE = "DiskPressure"

# QoS classes (reference pkg/api/v1/helper/qos)
GUARANTEED = "Guaranteed"
BURSTABLE = "Burstable"
BEST_EFFORT = "BestEffort"

# Well-known label keys
HOSTNAME_LABEL = "kubernetes.io/hostname"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"

ResourceList = dict  # resource name -> Quantity


def _res_to_dict(r: dict[str, Quantity]) -> dict:
    return {k: str(v) for k, v in r.items()}


def _res_from_dict(d: Optional[dict]) -> dict[str, Quantity]:
    return {k: Quantity(v) for k, v in (d or {}).items()}


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""

    def to_dict(self) -> dict:
        return {
            "containerPort": self.container_port,
            "hostPort": self.host_port,
            "protocol": self.protocol,
            "hostIP": self.host_ip,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ContainerPort":
        return cls(
            container_port=int(d.get("containerPort", 0)),
            host_port=int(d.get("hostPort", 0)),
            protocol=d.get("protocol", "TCP"),
            host_ip=d.get("hostIP", ""),
        )


@dataclass
class ResourceRequirements:
    requests: dict[str, Quantity] = field(default_factory=dict)
    limits: dict[str, Quantity] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "requests": _res_to_dict(self.requests),
            "limits": _res_to_dict(self.limits),
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ResourceRequirements":
        d = d or {}
        return cls(
            requests=_res_from_dict(d.get("requests")),
            limits=_res_from_dict(d.get("limits")),
        )


@dataclass
class Probe:
    """Liveness/readiness probe (reference ``pkg/api/types.go`` Probe;
    executed by ``pkg/kubelet/prober``).  ``handler`` is "exec" | "http" |
    "tcp"; the fake runtime interprets it."""

    handler: str = "exec"
    initial_delay_seconds: int = 0
    period_seconds: int = 10
    failure_threshold: int = 3
    success_threshold: int = 1
    # exec handler's command (``ExecAction.Command``): when set and the
    # node runs real containers, the prober runs it via CRI ExecSync and
    # judges by exit code (``prober/prober.go:80 runProbe``)
    exec_command: list[str] = field(default_factory=list)
    # the reference's Probe.TimeoutSeconds (default 1): a hung probe
    # command is a FAILURE after this bound, never an unbounded wait
    timeout_seconds: int = 1

    def to_dict(self) -> dict:
        d = {
            "handler": self.handler,
            "initialDelaySeconds": self.initial_delay_seconds,
            "periodSeconds": self.period_seconds,
            "failureThreshold": self.failure_threshold,
            "successThreshold": self.success_threshold,
        }
        if self.exec_command:
            d["execCommand"] = list(self.exec_command)
        if self.timeout_seconds != 1:
            d["timeoutSeconds"] = self.timeout_seconds
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["Probe"]:
        if not d:
            return None
        return cls(
            handler=d.get("handler", "exec"),
            initial_delay_seconds=int(d.get("initialDelaySeconds", 0)),
            period_seconds=int(d.get("periodSeconds", 10)),
            failure_threshold=int(d.get("failureThreshold", 3)),
            success_threshold=int(d.get("successThreshold", 1)),
            exec_command=list(d.get("execCommand") or []),
            timeout_seconds=int(d.get("timeoutSeconds", 1)),
        )


@dataclass
class VolumeMount:
    """``VolumeMount``: where a pod volume appears in the container's
    rootfs (``pkg/api/types.go`` VolumeMount; materialized under the
    container's rootfs dir by the real-container runtime)."""

    name: str = ""
    mount_path: str = ""
    read_only: bool = False

    def to_dict(self) -> dict:
        return {"name": self.name, "mountPath": self.mount_path,
                "readOnly": self.read_only}

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeMount":
        return cls(name=d.get("name", ""), mount_path=d.get("mountPath", ""),
                   read_only=bool(d.get("readOnly", False)))


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: list[ContainerPort] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    env: dict[str, str] = field(default_factory=dict)  # injected by PodPreset
    image_pull_policy: str = ""  # "" | Always | IfNotPresent | Never
    privileged: bool = False  # securityContext.privileged essential
    run_as_user: Optional[int] = None  # securityContext.runAsUser (PSP ranges)
    # entrypoint (``Container.Command``/``Args`` collapsed): the real-
    # container runtime execs this; empty = the image's default (a pause
    # style sleep at this framework's depth)
    command: list[str] = field(default_factory=list)
    volume_mounts: list[VolumeMount] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "image": self.image,
            "resources": self.resources.to_dict(),
            "ports": [p.to_dict() for p in self.ports],
        }
        if self.command:
            d["command"] = list(self.command)
        if self.volume_mounts:
            d["volumeMounts"] = [m.to_dict() for m in self.volume_mounts]
        if self.liveness_probe:
            d["livenessProbe"] = self.liveness_probe.to_dict()
        if self.readiness_probe:
            d["readinessProbe"] = self.readiness_probe.to_dict()
        if self.env:
            d["env"] = dict(self.env)
        if self.image_pull_policy:
            d["imagePullPolicy"] = self.image_pull_policy
        if self.privileged or self.run_as_user is not None:
            sc: dict = {}
            if self.privileged:
                sc["privileged"] = True
            if self.run_as_user is not None:
                sc["runAsUser"] = self.run_as_user
            d["securityContext"] = sc
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Container":
        return cls(
            name=d.get("name", ""),
            image=d.get("image", ""),
            resources=ResourceRequirements.from_dict(d.get("resources")),
            ports=[ContainerPort.from_dict(p) for p in d.get("ports") or []],
            liveness_probe=Probe.from_dict(d.get("livenessProbe")),
            readiness_probe=Probe.from_dict(d.get("readinessProbe")),
            env=dict(d.get("env") or {}),
            image_pull_policy=d.get("imagePullPolicy", ""),
            privileged=bool((d.get("securityContext") or {}).get("privileged")),
            run_as_user=(d.get("securityContext") or {}).get("runAsUser"),
            command=list(d.get("command") or []),
            volume_mounts=[VolumeMount.from_dict(m)
                           for m in d.get("volumeMounts") or []],
        )


@dataclass
class Volume:
    """Simplified volume: only what scheduling predicates consume.

    ``disk_id`` models the exclusive-attachment id behind NoDiskConflict /
    Max*VolumeCount (GCEPersistentDisk pdName, AWSElasticBlockStore volumeID,
    RBD image, ISCSI iqn — reference ``predicates.go:121-183``).
    ``pvc_name`` models persistentVolumeClaim references (zone conflict /
    volume-node predicates).
    """

    name: str = ""
    disk_id: str = ""
    disk_kind: str = ""  # "gce-pd" | "aws-ebs" | "azure-disk" | "rbd" | "iscsi" | ""
    read_only: bool = False
    pvc_name: str = ""
    secret_name: str = ""  # secret-backed volume (kubelet mounts, node authz)
    config_map_name: str = ""
    # local volume types the real-container kubelet materializes on disk
    # (reference ``pkg/volume/{empty_dir,host_path,downwardapi}``)
    empty_dir: bool = False
    host_path: str = ""
    # downwardAPI: file name -> fieldRef path ("metadata.name",
    # "metadata.namespace", "metadata.labels['k']", "metadata.annotations['k']")
    downward_api: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "diskID": self.disk_id,
            "diskKind": self.disk_kind,
            "readOnly": self.read_only,
            "pvcName": self.pvc_name,
            "secretName": self.secret_name,
            "configMapName": self.config_map_name,
        }
        if self.empty_dir:
            d["emptyDir"] = True
        if self.host_path:
            d["hostPath"] = self.host_path
        if self.downward_api:
            d["downwardAPI"] = dict(self.downward_api)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Volume":
        return cls(
            name=d.get("name", ""),
            disk_id=d.get("diskID", ""),
            disk_kind=d.get("diskKind", ""),
            read_only=bool(d.get("readOnly", False)),
            pvc_name=d.get("pvcName", ""),
            secret_name=d.get("secretName", ""),
            config_map_name=d.get("configMapName", ""),
            empty_dir=bool(d.get("emptyDir", False)),
            host_path=d.get("hostPath", ""),
            downward_api=dict(d.get("downwardAPI") or {}),
        )


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: "Taint") -> bool:
        """Reference ``pkg/api/v1/helper.TolerationsTolerateTaint`` semantics."""
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

    @classmethod
    def from_dict(cls, d: dict) -> "Toleration":
        return cls(
            key=d.get("key", ""),
            operator=d.get("operator", "Equal"),
            value=d.get("value", ""),
            effect=d.get("effect", ""),
            toleration_seconds=d.get("tolerationSeconds"),
        )


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = NO_SCHEDULE

    def to_dict(self) -> dict:
        return {"key": self.key, "value": self.value, "effect": self.effect}

    @classmethod
    def from_dict(cls, d: dict) -> "Taint":
        return cls(d.get("key", ""), d.get("value", ""), d.get("effect", NO_SCHEDULE))


@dataclass
class PodAffinityTerm:
    """One (anti)affinity term (``v1.PodAffinityTerm``): pods selected by
    ``selector`` in ``namespaces`` (empty → the term-owner pod's namespace),
    spread/packed over ``topology_key``."""

    selector: Optional[LabelSelector] = None
    topology_key: str = HOSTNAME_LABEL
    namespaces: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "labelSelector": self.selector.to_dict() if self.selector else None,
            "topologyKey": self.topology_key,
            "namespaces": list(self.namespaces),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PodAffinityTerm":
        sel = d.get("labelSelector")
        return cls(
            selector=LabelSelector.from_dict(sel) if sel is not None else None,
            topology_key=d.get("topologyKey", HOSTNAME_LABEL),
            namespaces=list(d.get("namespaces") or []),
        )


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)

    def to_dict(self) -> dict:
        return {"weight": self.weight, "podAffinityTerm": self.term.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "WeightedPodAffinityTerm":
        return cls(int(d.get("weight", 1)), PodAffinityTerm.from_dict(d.get("podAffinityTerm") or {}))


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: "NodeSelectorTermRef" = None  # NodeSelectorTerm

    def to_dict(self) -> dict:
        return {"weight": self.weight, "preference": self.preference.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "PreferredSchedulingTerm":
        from .selectors import NodeSelectorTerm

        return cls(int(d.get("weight", 1)), NodeSelectorTerm.from_dict(d.get("preference") or {}))


NodeSelectorTermRef = object  # forward-typing convenience


@dataclass
class Affinity:
    node_affinity_required: Optional[NodeSelector] = None
    node_affinity_preferred: list[PreferredSchedulingTerm] = field(default_factory=list)
    pod_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (
            self.node_affinity_required
            or self.node_affinity_preferred
            or self.pod_affinity_required
            or self.pod_affinity_preferred
            or self.pod_anti_affinity_required
            or self.pod_anti_affinity_preferred
        )

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

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "Optional[Affinity]":
        if not d:
            return None
        return cls(
            node_affinity_required=NodeSelector.from_dict(d.get("nodeAffinityRequired")),
            node_affinity_preferred=[
                PreferredSchedulingTerm.from_dict(t) for t in d.get("nodeAffinityPreferred") or []
            ],
            pod_affinity_required=[
                PodAffinityTerm.from_dict(t) for t in d.get("podAffinityRequired") or []
            ],
            pod_affinity_preferred=[
                WeightedPodAffinityTerm.from_dict(t) for t in d.get("podAffinityPreferred") or []
            ],
            pod_anti_affinity_required=[
                PodAffinityTerm.from_dict(t) for t in d.get("podAntiAffinityRequired") or []
            ],
            pod_anti_affinity_preferred=[
                WeightedPodAffinityTerm.from_dict(t) for t in d.get("podAntiAffinityPreferred") or []
            ],
        )


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    node_name: str = ""
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)
    priority: int = 0
    priority_class_name: str = ""
    scheduler_name: str = "default-scheduler"
    restart_policy: str = "Always"
    service_account_name: str = ""
    termination_grace_period_seconds: int = 30
    active_deadline_seconds: Optional[int] = None
    # host namespace sharing (PSP/DenyEscalatingExec gates read these)
    host_pid: bool = False
    host_ipc: bool = False
    host_network: bool = False

    def to_dict(self) -> dict:
        return {
            "containers": [c.to_dict() for c in self.containers],
            "nodeName": self.node_name,
            "nodeSelector": dict(self.node_selector),
            "affinity": self.affinity.to_dict() if self.affinity else None,
            "tolerations": [t.to_dict() for t in self.tolerations],
            "volumes": [v.to_dict() for v in self.volumes],
            "priority": self.priority,
            "priorityClassName": self.priority_class_name,
            "schedulerName": self.scheduler_name,
            "restartPolicy": self.restart_policy,
            "serviceAccountName": self.service_account_name,
            "terminationGracePeriodSeconds": self.termination_grace_period_seconds,
            "activeDeadlineSeconds": self.active_deadline_seconds,
            "hostPID": self.host_pid,
            "hostIPC": self.host_ipc,
            "hostNetwork": self.host_network,
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodSpec":
        d = d or {}
        ads = d.get("activeDeadlineSeconds")
        return cls(
            containers=[Container.from_dict(c) for c in d.get("containers") or []],
            node_name=d.get("nodeName", ""),
            node_selector=dict(d.get("nodeSelector") or {}),
            affinity=Affinity.from_dict(d.get("affinity")),
            tolerations=[Toleration.from_dict(t) for t in d.get("tolerations") or []],
            volumes=[Volume.from_dict(v) for v in d.get("volumes") or []],
            priority=int(d.get("priority", 0)),
            priority_class_name=d.get("priorityClassName", ""),
            scheduler_name=d.get("schedulerName", "default-scheduler"),
            restart_policy=d.get("restartPolicy", "Always"),
            service_account_name=d.get("serviceAccountName", ""),
            termination_grace_period_seconds=int(d.get("terminationGracePeriodSeconds", 30)),
            active_deadline_seconds=None if ads is None else int(ads),
            host_pid=bool(d.get("hostPID", False)),
            host_ipc=bool(d.get("hostIPC", False)),
            host_network=bool(d.get("hostNetwork", False)),
        )


@dataclass
class ContainerStatus:
    """Per-container runtime state (reference ``pkg/api/types.go``
    ContainerStatus; written by the kubelet status manager)."""

    name: str = ""
    state: str = "waiting"  # waiting | running | terminated
    ready: bool = False
    restart_count: int = 0
    exit_code: int = 0
    reason: str = ""
    # runtime handle ("pid://<n>" under the real-container runtime) —
    # the reference's containerID ("docker://<hash>")
    container_id: str = ""

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "state": self.state,
            "ready": self.ready,
            "restartCount": self.restart_count,
            "exitCode": self.exit_code,
            "reason": self.reason,
        }
        if self.container_id:
            d["containerID"] = self.container_id
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ContainerStatus":
        return cls(
            name=d.get("name", ""),
            state=d.get("state", "waiting"),
            ready=bool(d.get("ready", False)),
            restart_count=int(d.get("restartCount", 0)),
            exit_code=int(d.get("exitCode", 0)),
            reason=d.get("reason", ""),
            container_id=d.get("containerID", ""),
        )


@dataclass
class PodStatus:
    phase: str = PENDING
    conditions: list[dict] = field(default_factory=list)
    host_ip: str = ""
    pod_ip: str = ""
    start_revision: int = 0
    container_statuses: list[ContainerStatus] = field(default_factory=list)
    reason: str = ""

    def to_dict(self) -> dict:
        d = {
            "phase": self.phase,
            "conditions": copy.deepcopy(self.conditions),
            "hostIP": self.host_ip,
            "podIP": self.pod_ip,
            "startRevision": self.start_revision,
        }
        if self.container_statuses:
            d["containerStatuses"] = [c.to_dict() for c in self.container_statuses]
        if self.reason:
            d["reason"] = self.reason
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodStatus":
        d = d or {}
        return cls(
            phase=d.get("phase", PENDING),
            conditions=copy.deepcopy(d.get("conditions") or []),
            host_ip=d.get("hostIP", ""),
            pod_ip=d.get("podIP", ""),
            start_revision=int(d.get("startRevision", 0)),
            container_statuses=[
                ContainerStatus.from_dict(c) for c in d.get("containerStatuses") or []
            ],
            reason=d.get("reason", ""),
        )


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"

    # -- scheduling helpers ------------------------------------------------
    def resource_requests(self) -> dict[str, Quantity]:
        """Summed container requests (reference ``predicates.GetResourceRequest``)."""
        total: dict[str, Quantity] = {}
        for c in self.spec.containers:
            for name, q in c.resources.requests.items():
                total[name] = total.get(name, Quantity(0)) + q
        return total

    def qos_class(self) -> str:
        """Reference ``pkg/api/v1/helper/qos.GetPodQOS`` semantics (cpu+mem)."""
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

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Pod":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodSpec.from_dict(d.get("spec")),
            status=PodStatus.from_dict(d.get("status")),
        )


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = ""
    status: str = "False"  # "True" | "False" | "Unknown"
    heartbeat_revision: int = 0
    heartbeat_time: float = 0.0  # injected-clock seconds (kubelet heartbeat)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "status": self.status,
            "heartbeatRevision": self.heartbeat_revision,
            "heartbeatTime": self.heartbeat_time,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodeCondition":
        return cls(
            type=d.get("type", ""),
            status=d.get("status", "False"),
            heartbeat_revision=int(d.get("heartbeatRevision", 0)),
            heartbeat_time=float(d.get("heartbeatTime", 0.0)),
        )


@dataclass
class NodeSpec:
    taints: list[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""
    pod_cidr: str = ""  # allocated by the node IPAM controller

    def to_dict(self) -> dict:
        return {
            "taints": [t.to_dict() for t in self.taints],
            "unschedulable": self.unschedulable,
            "providerID": self.provider_id,
            "podCIDR": self.pod_cidr,
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "NodeSpec":
        d = d or {}
        return cls(
            taints=[Taint.from_dict(t) for t in d.get("taints") or []],
            unschedulable=bool(d.get("unschedulable", False)),
            provider_id=d.get("providerID", ""),
            pod_cidr=d.get("podCIDR", ""),
        )


@dataclass
class NodeStatus:
    capacity: dict[str, Quantity] = field(default_factory=dict)
    allocatable: dict[str, Quantity] = field(default_factory=dict)
    conditions: list[NodeCondition] = field(default_factory=list)
    images: list[dict] = field(default_factory=list)  # {"names": [...], "sizeBytes": N}
    # PV names attached to this node, written by the attach/detach
    # controller (reference ``node.status.volumesAttached``)
    volumes_attached: list[str] = field(default_factory=list)
    # the node's read-API endpoint (reference daemonEndpoints.kubeletEndpoint
    # + addresses, collapsed to one URL) — the apiserver proxies pod
    # subresources (logs) here
    kubelet_url: str = ""
    # PVs the kubelet currently has MOUNTED into pods (reference
    # ``node.status.volumesInUse``): the attach/detach controller must not
    # detach these until the kubelet unmounts
    volumes_in_use: list[str] = field(default_factory=list)
    # [{"type": "InternalIP"|"ExternalIP"|"Hostname", "address": ...}] —
    # written by the cloud node controller (reference node.status.addresses)
    addresses: list[dict] = field(default_factory=list)

    def condition(self, ctype: str) -> Optional[NodeCondition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def to_dict(self) -> dict:
        return {
            "capacity": _res_to_dict(self.capacity),
            "allocatable": _res_to_dict(self.allocatable),
            "conditions": [c.to_dict() for c in self.conditions],
            "images": copy.deepcopy(self.images),
            "volumesAttached": list(self.volumes_attached),
            "kubeletURL": self.kubelet_url,
            "volumesInUse": list(self.volumes_in_use),
            "addresses": copy.deepcopy(self.addresses),
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "NodeStatus":
        d = d or {}
        return cls(
            capacity=_res_from_dict(d.get("capacity")),
            allocatable=_res_from_dict(d.get("allocatable")),
            conditions=[NodeCondition.from_dict(c) for c in d.get("conditions") or []],
            images=copy.deepcopy(d.get("images") or []),
            volumes_attached=list(d.get("volumesAttached") or []),
            kubelet_url=d.get("kubeletURL", ""),
            volumes_in_use=list(d.get("volumesInUse") or []),
            addresses=copy.deepcopy(d.get("addresses") or []),
        )


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=NodeSpec.from_dict(d.get("spec")),
            status=NodeStatus.from_dict(d.get("status")),
        )


# ---------------------------------------------------------------------------
# Binding — the scheduler's commit object
# (reference pkg/registry/core/pod/storage/storage.go:128 BindingREST)
# ---------------------------------------------------------------------------


@dataclass
class Binding:
    pod_namespace: str = "default"
    pod_name: str = ""
    node_name: str = ""

    KIND = "Binding"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "podNamespace": self.pod_namespace,
            "podName": self.pod_name,
            "nodeName": self.node_name,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Binding":
        return cls(
            pod_namespace=d.get("podNamespace", "default"),
            pod_name=d.get("podName", ""),
            node_name=d.get("nodeName", ""),
        )


# ---------------------------------------------------------------------------
# Workload / grouping objects (controllers + SelectorSpreadPriority)
# ---------------------------------------------------------------------------


@dataclass
class ServicePort:
    """Service port mapping (reference ``pkg/api/types.go`` ServicePort;
    consumed by the proxy's NAT rule synthesis and the endpoint controller)."""

    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: int = 0
    node_port: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "protocol": self.protocol,
            "port": self.port,
            "targetPort": self.target_port,
            "nodePort": self.node_port,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServicePort":
        return cls(
            name=d.get("name", ""),
            protocol=d.get("protocol", "TCP"),
            port=int(d.get("port", 0)),
            target_port=int(d.get("targetPort", 0)),
            node_port=int(d.get("nodePort", 0)),
        )


@dataclass
class Service:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: dict[str, str] = field(default_factory=dict)
    ports: list[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""  # "" = allocate; "None" = headless
    type: str = "ClusterIP"  # ClusterIP | NodePort | LoadBalancer
    session_affinity: str = "None"  # None | ClientIP
    # ingress IPs written by the cloud service controller for
    # type=LoadBalancer (reference ``status.loadBalancer.ingress``)
    status_load_balancer: list[str] = field(default_factory=list)

    KIND = "Service"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "selector": dict(self.selector),
                "ports": [p.to_dict() for p in self.ports],
                "clusterIP": self.cluster_ip,
                "type": self.type,
                "sessionAffinity": self.session_affinity,
            },
            "status": {
                "loadBalancer": {
                    "ingress": [{"ip": ip} for ip in self.status_load_balancer]
                }
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Service":
        spec = d.get("spec") or {}
        lb = ((d.get("status") or {}).get("loadBalancer") or {})
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=dict(spec.get("selector") or {}),
            ports=[ServicePort.from_dict(p) for p in spec.get("ports") or []],
            cluster_ip=spec.get("clusterIP", ""),
            type=spec.get("type", "ClusterIP"),
            session_affinity=spec.get("sessionAffinity", "None"),
            status_load_balancer=[
                i.get("ip", "") for i in lb.get("ingress") or [] if i.get("ip")
            ],
        )


@dataclass
class PodTemplateSpec:
    labels: dict[str, str] = field(default_factory=dict)
    spec: PodSpec = field(default_factory=PodSpec)

    def to_dict(self) -> dict:
        return {"metadata": {"labels": dict(self.labels)}, "spec": self.spec.to_dict()}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PodTemplateSpec":
        d = d or {}
        return cls(
            labels=dict((d.get("metadata") or {}).get("labels") or {}),
            spec=PodSpec.from_dict(d.get("spec")),
        )


@dataclass
class ReplicaSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_replicas: int = 0
    status_ready_replicas: int = 0
    status_observed_generation: int = 0

    KIND = "ReplicaSet"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "replicas": self.replicas,
                "selector": self.selector.to_dict(),
                "template": self.template.to_dict(),
            },
            "status": {
                "replicas": self.status_replicas,
                "readyReplicas": self.status_ready_replicas,
                "observedGeneration": self.status_observed_generation,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaSet":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            replicas=int(spec.get("replicas", 1)),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            status_replicas=int(status.get("replicas", 0)),
            status_ready_replicas=int(status.get("readyReplicas", 0)),
            status_observed_generation=int(status.get("observedGeneration", 0)),
        )


@dataclass
class ReplicationController:
    """The original replica-keeper (reference ``pkg/api/types.go:2533``).
    Semantically ReplicaSet with a plain map selector (no set-based
    expressions); era tooling (``kubectl rolling-update``) was RC-based.
    Defaulting mirrors v1: an empty selector falls back to the template
    labels."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector_labels: dict = field(default_factory=dict)  # spec.selector map
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_replicas: int = 0
    status_ready_replicas: int = 0
    status_observed_generation: int = 0

    KIND = "ReplicationController"

    @property
    def selector(self) -> LabelSelector:
        """Map selector as a LabelSelector, with the v1 default-to-
        template-labels rule — lets RC share the ReplicaSet controller
        and kubectl machinery."""
        return LabelSelector.from_match_labels(
            self.selector_labels or self.template.labels)

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "replicas": self.replicas,
                "selector": dict(self.selector_labels),
                "template": self.template.to_dict(),
            },
            "status": {
                "replicas": self.status_replicas,
                "readyReplicas": self.status_ready_replicas,
                "observedGeneration": self.status_observed_generation,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicationController":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            replicas=int(spec.get("replicas", 1)),
            selector_labels=dict(spec.get("selector") or {}),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            status_replicas=int(status.get("replicas", 0)),
            status_ready_replicas=int(status.get("readyReplicas", 0)),
            status_observed_generation=int(status.get("observedGeneration", 0)),
        )


@dataclass
class Deployment:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: str = "RollingUpdate"  # or "Recreate"
    max_surge: int = 1
    max_unavailable: int = 0
    # kubectl rollout pause/resume (deployment/sync.go: a paused
    # deployment reconciles SCALE but never progresses the rollout)
    paused: bool = False
    status_replicas: int = 0
    status_updated_replicas: int = 0
    status_ready_replicas: int = 0
    status_observed_generation: int = 0

    KIND = "Deployment"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "replicas": self.replicas,
                "selector": self.selector.to_dict(),
                "template": self.template.to_dict(),
                "strategy": self.strategy,
                "maxSurge": self.max_surge,
                "maxUnavailable": self.max_unavailable,
                "paused": self.paused,
            },
            "status": {
                "replicas": self.status_replicas,
                "updatedReplicas": self.status_updated_replicas,
                "readyReplicas": self.status_ready_replicas,
                "observedGeneration": self.status_observed_generation,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Deployment":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            replicas=int(spec.get("replicas", 1)),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            strategy=spec.get("strategy", "RollingUpdate"),
            max_surge=int(spec.get("maxSurge", 1)),
            max_unavailable=int(spec.get("maxUnavailable", 0)),
            paused=bool(spec.get("paused", False)),
            status_replicas=int(status.get("replicas", 0)),
            status_updated_replicas=int(status.get("updatedReplicas", 0)),
            status_ready_replicas=int(status.get("readyReplicas", 0)),
            status_observed_generation=int(status.get("observedGeneration", 0)),
        )


@dataclass
class Event:
    """Cluster events (reference ``client-go/tools/record``): scheduler emits
    Scheduled / FailedScheduling (``scheduler.go:174,248``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_key: str = ""
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1

    KIND = "Event"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "involvedKind": self.involved_kind,
            "involvedKey": self.involved_key,
            "reason": self.reason,
            "message": self.message,
            "type": self.type,
            "count": self.count,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            involved_kind=d.get("involvedKind", ""),
            involved_key=d.get("involvedKey", ""),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            type=d.get("type", "Normal"),
            count=int(d.get("count", 1)),
        )


# ---------------------------------------------------------------------------
# Storage (NoVolumeZoneConflict / NoVolumeNodeConflict)
# ---------------------------------------------------------------------------


@dataclass
class PersistentVolume:
    """Cluster storage resource (reference ``pkg/api/types.go`` ~:380;
    bound by the PV controller's claim↔volume matching)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: dict[str, Quantity] = field(default_factory=dict)  # {"storage": ...}
    access_modes: list[str] = field(default_factory=lambda: ["ReadWriteOnce"])
    storage_class: str = ""
    zone: str = ""  # topology constraint (NoVolumeZoneConflict)
    # Local-volume pinning (NoVolumeNodeConflict, reference
    # predicates.go:1323 via the volume.alpha node-affinity annotation):
    node_affinity: "object" = None  # Optional[selectors.NodeSelector]
    reclaim_policy: str = "Retain"  # Retain | Delete | Recycle
    phase: str = "Available"  # Available | Bound | Released | Failed
    claim_ref: str = ""  # namespace/name of bound PVC

    KIND = "PersistentVolume"

    def __post_init__(self):
        self.meta.namespace = ""

    def to_dict(self) -> dict:
        d = {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "capacity": _res_to_dict(self.capacity),
                "accessModes": list(self.access_modes),
                "storageClassName": self.storage_class,
                "reclaimPolicy": self.reclaim_policy,
            },
            "status": {"phase": self.phase, "claimRef": self.claim_ref},
        }
        if self.node_affinity is not None:
            d["spec"]["nodeAffinity"] = self.node_affinity.to_dict()
        if self.zone:
            d["metadata"].setdefault("labels", {})[ZONE_LABEL] = self.zone
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PersistentVolume":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=meta,
            capacity=_res_from_dict(spec.get("capacity")),
            access_modes=list(spec.get("accessModes") or ["ReadWriteOnce"]),
            storage_class=spec.get("storageClassName", ""),
            zone=meta.labels.get(ZONE_LABEL, ""),
            node_affinity=NodeSelector.from_dict(spec.get("nodeAffinity")),
            reclaim_policy=spec.get("reclaimPolicy", "Retain"),
            phase=status.get("phase", "Available"),
            claim_ref=status.get("claimRef", ""),
        )


@dataclass
class PersistentVolumeClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    request_storage: Quantity = field(default_factory=lambda: Quantity(0))
    access_modes: list[str] = field(default_factory=lambda: ["ReadWriteOnce"])
    storage_class: str = ""
    phase: str = "Pending"  # Pending | Bound | Lost
    volume_name: str = ""  # bound PV name

    KIND = "PersistentVolumeClaim"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "resources": {"requests": {"storage": str(self.request_storage)}},
                "accessModes": list(self.access_modes),
                "storageClassName": self.storage_class,
                "volumeName": self.volume_name,
            },
            "status": {"phase": self.phase},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PersistentVolumeClaim":
        spec = d.get("spec") or {}
        req = ((spec.get("resources") or {}).get("requests") or {}).get("storage", 0)
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            request_storage=Quantity(req),
            access_modes=list(spec.get("accessModes") or ["ReadWriteOnce"]),
            storage_class=spec.get("storageClassName", ""),
            phase=(d.get("status") or {}).get("phase", "Pending"),
            volume_name=spec.get("volumeName", ""),
        )


# Registry of the stored kinds: the clientset derives its typed clients
# (``cs.pods``, ``cs.nodes``, ...) from it.
KINDS: dict[str, type] = {}

# Kinds whose objects live outside any namespace (store key = bare name).
CLUSTER_SCOPED_KINDS: set[str] = set()

# kind -> lowercase plural resource name (the clientset attribute).
KIND_PLURALS: dict[str, str] = {}


def _pluralize(kind: str) -> str:
    low = kind.lower()
    if low.endswith("ss"):  # PriorityClass -> priorityclasses
        return low + "es"
    if low.endswith("s"):  # Endpoints -> endpoints
        return low
    return low + "s"


def register_kind(cls, cluster_scoped: bool = False, plural: Optional[str] = None):
    KINDS[cls.KIND] = cls
    KIND_PLURALS[cls.KIND] = plural or _pluralize(cls.KIND)
    if cluster_scoped:
        CLUSTER_SCOPED_KINDS.add(cls.KIND)
    return cls


def kind_for_plural(plural: str) -> Optional[str]:
    """Resource path segment -> kind (the inverse of ``KIND_PLURALS``),
    read from the live registry per call so a kind registered later
    resolves at once."""
    for kind, p in list(KIND_PLURALS.items()):
        if p == plural:
            return kind
    return None


def register_cluster_scoped(cls):
    return register_kind(cls, cluster_scoped=True)


for _cls in (Pod, Service, ReplicaSet, ReplicationController, Deployment, Event,
             PersistentVolumeClaim):
    register_kind(_cls)
for _cls in (Node, PersistentVolume):
    register_kind(_cls, cluster_scoped=True)


def from_dict(d: dict):
    kind = d.get("kind", "")
    cls = KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown kind {kind!r}")
    return cls.from_dict(d)
