"""cloud-controller-manager (reference ``cmd/cloud-controller-manager``):
the cloud-coupled loops split out of the core controller manager so the
core control plane has zero IaaS dependencies."""

from __future__ import annotations

from typing import Callable, Optional

from ..client.clientset import Clientset
from ..controllers.manager import ControllerManager
from ..utils.metrics import ReadingsMetric
from .controllers import CloudNodeController, RouteController, ServiceLBController
from .provider import CloudProvider, FakeCloud

CLOUD_CONTROLLERS: dict[str, Callable] = {
    "cloud-node": CloudNodeController,
    "service-lb": ServiceLBController,
    "route": RouteController,
}


class CloudControllerManager(ControllerManager):
    """Same informer-sharing manager, cloud registry + provider wiring."""

    registry = CLOUD_CONTROLLERS

    def __init__(self, clientset: Clientset, cloud: CloudProvider,
                 enabled: Optional[list[str]] = None, clock=None, **kw):
        super().__init__(clientset, enabled=enabled, clock=clock,
                         cloud=cloud, **kw)


class CloudMetrics(ReadingsMetric):
    """The fake cloud's counts on a daemon's registry, read when scraped:
    balancers, the nodes they target summed, routes, calls."""

    name = "cloud"

    def __init__(self, cloud: FakeCloud):
        self.cloud = cloud

    def values(self) -> dict:
        s = self.cloud.summary()
        return {"load_balancers": len(s["balancers"]),
                "load_balancer_nodes": sum(len(b["nodes"]) for b in s["balancers"].values()),
                "routes": len(s["routes"]), "calls_total": s["calls"]}
