"""Object builders for tests and benchmarks (reference ``test/utils``,
``plugin/pkg/scheduler/testing``)."""

from __future__ import annotations

from typing import Optional

from .api import (
    Container,
    ContainerPort,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
    Quantity,
    ResourceRequirements,
    Taint,
    Toleration,
)


def make_node(
    name: str,
    cpu: str = "4",
    memory: str = "8Gi",
    pods: int = 110,
    labels: Optional[dict] = None,
    taints: Optional[list[Taint]] = None,
    gpu: int = 0,
    storage: str = "0",
    annotations: Optional[dict] = None,
    unschedulable: bool = False,
    conditions: Optional[list[NodeCondition]] = None,
) -> Node:
    alloc = {
        "cpu": Quantity(cpu),
        "memory": Quantity(memory),
        "pods": Quantity(pods),
    }
    if gpu:
        alloc["nvidia.com/gpu"] = Quantity(gpu)
    if storage != "0":
        alloc["ephemeral-storage"] = Quantity(storage)
    return Node(
        meta=ObjectMeta(name=name, namespace="", labels=labels or {}, annotations=annotations or {}),
        spec=NodeSpec(taints=taints or [], unschedulable=unschedulable),
        status=NodeStatus(
            capacity=dict(alloc),
            allocatable=alloc,
            conditions=conditions or [NodeCondition(type="Ready", status="True")],
        ),
    )


def make_pod(
    name: str,
    cpu: str = "0",
    memory: str = "0",
    namespace: str = "default",
    labels: Optional[dict] = None,
    node_name: str = "",
    node_selector: Optional[dict] = None,
    tolerations: Optional[list[Toleration]] = None,
    host_ports: Optional[list[int]] = None,
    gpu: int = 0,
    affinity=None,
    volumes=None,
    owner_refs=None,
    containers: Optional[list[Container]] = None,
) -> Pod:
    if containers is None:
        requests = {}
        if cpu != "0":
            requests["cpu"] = Quantity(cpu)
        if memory != "0":
            requests["memory"] = Quantity(memory)
        if gpu:
            requests["nvidia.com/gpu"] = Quantity(gpu)
        ports = [ContainerPort(container_port=p, host_port=p) for p in host_ports or []]
        containers = [
            Container(
                name="c0",
                image="img",
                resources=ResourceRequirements(requests=requests),
                ports=ports,
            )
        ]
    return Pod(
        meta=ObjectMeta(
            name=name,
            namespace=namespace,
            labels=labels or {},
            owner_references=owner_refs or [],
        ),
        spec=PodSpec(
            containers=containers,
            node_name=node_name,
            node_selector=node_selector or {},
            tolerations=tolerations or [],
            affinity=affinity,
            volumes=volumes or [],
        ),
    )
