"""federation-controller-manager (reference
``federation/cmd/federation-controller-manager``): cluster health +
per-kind sync controllers + service DNS over one shared informer set."""

from __future__ import annotations

from typing import Callable, Optional

from ..client.clientset import Clientset
from ..client.informer import InformerFactory
from ..controllers.manager import ControllerManager
from .controllers import (
    ClusterController,
    FederatedSyncController,
    MemberRegistry,
    ServiceDNSController,
)

DEFAULT_FEDERATED_KINDS = ("Deployment", "ConfigMap", "Secret", "Service")


class FederationControllerManager(ControllerManager):
    def __init__(self, clientset: Clientset,
                 kinds: tuple = DEFAULT_FEDERATED_KINDS,
                 member_factory: Optional[Callable] = None,
                 federation_name: str = "myfed",
                 dns_zone: str = "example.com",
                 clock=None, **kw):
        # hand-built registry: every controller shares ONE MemberRegistry
        # (and through it one member clientset per cluster)
        self.clientset = clientset
        self.informers = InformerFactory(clientset)
        self.tick_stats: dict[str, dict] = {}  # ControllerManager.tick's
        if member_factory is not None:
            members = MemberRegistry(clientset, factory=member_factory)
        else:
            members = MemberRegistry(clientset)
        self.members = members
        common = {"informers": self.informers, "members": members}
        if clock is not None:
            common["clock"] = clock
        self.controllers = {
            "cluster": ClusterController(clientset, **common),
            "service-dns": ServiceDNSController(
                clientset, federation_name=federation_name,
                dns_zone=dns_zone, **common),
        }
        for kind in kinds:
            c = FederatedSyncController(clientset, kind, **common)
            self.controllers[c.name] = c

    @property
    def dns(self) -> ServiceDNSController:
        return self.controllers["service-dns"]
