"""Cloud provider interface + fake implementation.

Capability of the reference's ``pkg/cloudprovider`` (``cloud.go``
Interface with LoadBalancer()/Instances()/Zones()/Routes() accessors, ~10
provider adapters under ``providers/``) at the depth this control plane
consumes it: the cloud controllers (service LB, routes, node addresses,
instance-existence) program infrastructure through exactly this surface.

The only in-tree implementation is :class:`FakeCloud`, mirroring
``pkg/cloudprovider/providers/fake/fake.go`` — the reference's own test
double IS its contract for what a provider must do, and on this
TPU-resident control plane there is no real IaaS to call.  The call log
(``calls``) lets tests assert the controller→provider protocol exactly
the way the reference's service/route controller tests do.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Instance:
    """One cloud VM (reference ``Instances.NodeAddresses`` /
    ``ExternalID``)."""

    name: str
    internal_ip: str = ""
    external_ip: str = ""
    zone: str = ""
    region: str = ""
    exists: bool = True


@dataclass
class LoadBalancer:
    """Provisioned LB state (reference ``LoadBalancerStatus``)."""

    name: str
    ingress_ip: str = ""
    ports: list[int] = field(default_factory=list)
    nodes: list[str] = field(default_factory=list)


@dataclass
class Route:
    """One inter-node route (reference ``routes.Route``)."""

    name: str
    target_node: str = ""
    dest_cidr: str = ""


class CloudProvider:
    """Reference ``cloudprovider.Interface``.  Accessors return None when
    the provider doesn't support that service (controllers skip work)."""

    def load_balancer(self) -> Optional["LoadBalancerService"]:
        return None

    def instances(self) -> Optional["InstancesService"]:
        return None

    def zones(self) -> Optional["ZonesService"]:
        return None

    def routes(self) -> Optional["RoutesService"]:
        return None


class LoadBalancerService:
    def get_load_balancer(self, name: str) -> Optional[LoadBalancer]:
        raise NotImplementedError

    def ensure_load_balancer(self, name: str, ports: list[int],
                             nodes: list[str]) -> LoadBalancer:
        raise NotImplementedError

    def update_load_balancer(self, name: str, nodes: list[str]) -> None:
        raise NotImplementedError

    def ensure_load_balancer_deleted(self, name: str) -> None:
        raise NotImplementedError


class InstancesService:
    def node_addresses(self, name: str) -> list[dict]:
        raise NotImplementedError

    def instance_exists(self, name: str) -> bool:
        raise NotImplementedError


class ZonesService:
    def get_zone(self, name: str) -> tuple[str, str]:
        """(zone, region) for an instance."""
        raise NotImplementedError


class RoutesService:
    def list_routes(self) -> list[Route]:
        raise NotImplementedError

    def create_route(self, route: Route) -> None:
        raise NotImplementedError

    def delete_route(self, route: Route) -> None:
        raise NotImplementedError


class FakeCloud(CloudProvider, LoadBalancerService, InstancesService,
                ZonesService, RoutesService):
    """In-memory provider (reference ``providers/fake``): deterministic LB
    IP allocation, instance registry, route table, and a call log for
    protocol assertions."""

    def __init__(self, ip_base: str = "203.0.113"):
        self._lock = threading.Lock()
        self.instances_by_name: dict[str, Instance] = {}
        self.balancers: dict[str, LoadBalancer] = {}
        self.route_table: dict[str, Route] = {}
        self.calls: list[tuple] = []
        self._ip_base = ip_base
        self._next_ip = 1

    # -- accessors (all services supported) --------------------------------
    def load_balancer(self):
        return self

    def instances(self):
        return self

    def zones(self):
        return self

    def routes(self):
        return self

    # -- instance admin (test setup) ---------------------------------------
    def add_instance(self, inst: Instance) -> None:
        with self._lock:
            self.instances_by_name[inst.name] = inst

    def remove_instance(self, name: str) -> None:
        with self._lock:
            if name in self.instances_by_name:
                self.instances_by_name[name].exists = False

    # -- LoadBalancerService ------------------------------------------------
    def get_load_balancer(self, name: str) -> Optional[LoadBalancer]:
        with self._lock:
            self.calls.append(("get", name))
            return self.balancers.get(name)

    def ensure_load_balancer(self, name, ports, nodes) -> LoadBalancer:
        with self._lock:
            self.calls.append(("ensure", name, tuple(ports), tuple(sorted(nodes))))
            lb = self.balancers.get(name)
            if lb is None:
                lb = LoadBalancer(name=name,
                                  ingress_ip=f"{self._ip_base}.{self._next_ip}")
                self._next_ip += 1
                self.balancers[name] = lb
            lb.ports = list(ports)
            lb.nodes = sorted(nodes)
            return lb

    def update_load_balancer(self, name, nodes) -> None:
        with self._lock:
            self.calls.append(("update", name, tuple(sorted(nodes))))
            if name in self.balancers:
                self.balancers[name].nodes = sorted(nodes)

    def ensure_load_balancer_deleted(self, name) -> None:
        with self._lock:
            self.calls.append(("delete", name))
            self.balancers.pop(name, None)

    # -- InstancesService ----------------------------------------------------
    def node_addresses(self, name: str) -> list[dict]:
        with self._lock:
            inst = self.instances_by_name.get(name)
            if inst is None or not inst.exists:
                raise KeyError(name)
            out = []
            if inst.internal_ip:
                out.append({"type": "InternalIP", "address": inst.internal_ip})
            if inst.external_ip:
                out.append({"type": "ExternalIP", "address": inst.external_ip})
            out.append({"type": "Hostname", "address": inst.name})
            return out

    def instance_exists(self, name: str) -> bool:
        with self._lock:
            inst = self.instances_by_name.get(name)
            return inst is not None and inst.exists

    # -- ZonesService --------------------------------------------------------
    def get_zone(self, name: str) -> tuple[str, str]:
        with self._lock:
            inst = self.instances_by_name.get(name)
            if inst is None:
                raise KeyError(name)
            return inst.zone, inst.region

    # -- what the cloud holds (the daemon's stats line, /metrics) ------------
    def summary(self) -> dict:
        """The balancers (ingress IP, ports, nodes), the routes (target node:
        CIDR) and the number of calls made."""
        with self._lock:
            return {"balancers": {lb.name: {"ingress_ip": lb.ingress_ip, "ports": list(lb.ports),
                                            "nodes": list(lb.nodes)}
                                  for lb in self.balancers.values()},
                    "routes": {r.target_node: r.dest_cidr for r in self.route_table.values()},
                    "calls": len(self.calls)}

    # -- RoutesService -------------------------------------------------------
    def list_routes(self) -> list[Route]:
        with self._lock:
            return list(self.route_table.values())

    def create_route(self, route: Route) -> None:
        with self._lock:
            self.calls.append(("create-route", route.target_node, route.dest_cidr))
            self.route_table[route.name] = route

    def delete_route(self, route: Route) -> None:
        with self._lock:
            self.calls.append(("delete-route", route.target_node, route.dest_cidr))
            self.route_table.pop(route.name, None)
