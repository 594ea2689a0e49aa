"""Cloud controllers: the loops the reference splits into
cloud-controller-manager (``cmd/cloud-controller-manager``,
``pkg/controller/cloud``, ``pkg/controller/service``,
``pkg/controller/route``).

All three coordinate purely through watched API objects and program the
IaaS through the :class:`~kubernetes_tpu_torch.cloud.provider.CloudProvider`
surface — same level-triggered shape as every other controller here.
"""

from __future__ import annotations

from ..api import types as api
from ..controllers.base import Controller
from ..store.store import NotFoundError
from .provider import CloudProvider, Route

ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"


def _node_ready(node: api.Node) -> bool:
    cond = node.status.condition(api.NODE_READY)
    return cond is not None and cond.status == "True"


def _lb_name(namespace: str, name: str) -> str:
    """Cloud-unique LB name (reference ``GetLoadBalancerName`` uses
    "a"+UID).  Hash the key instead of joining with "-": namespaces and
    names may themselves contain hyphens, so a join would be ambiguous
    (team-a/web vs team/a-web) — and the hash stays derivable from the
    queue key alone after the Service object is gone."""
    import hashlib

    return "a" + hashlib.sha1(f"{namespace}/{name}".encode()).hexdigest()[:16]


class ServiceLBController(Controller):
    """``pkg/controller/service/servicecontroller.go``: for every Service
    of type=LoadBalancer, ensure a cloud LB pointing at the ready nodes
    and publish its ingress IP to service status; tear the LB down when
    the service is deleted or its type changes."""

    name = "service-lb"

    def __init__(self, clientset, informers=None, cloud: CloudProvider = None, **kw):
        super().__init__(clientset, informers, **kw)
        if cloud is None or cloud.load_balancer() is None:
            raise ValueError("ServiceLBController requires a cloud with LB support")
        self.lb = cloud.load_balancer()
        self.watch("Service")
        from ..client.informer import Handler

        # node churn re-targets every LB (reference nodeSyncLoop)
        self.informers.informer("Node").add_handler(Handler(
            on_add=lambda n: self._all_lb_services(),
            on_update=lambda old, new: (
                self._all_lb_services()
                if _node_ready(old) != _node_ready(new)
                or old.spec.unschedulable != new.spec.unschedulable
                else None
            ),
            on_delete=lambda n: self._all_lb_services(),
        ))

    def _all_lb_services(self) -> None:
        for svc in self.informer("Service").list():
            if svc.type == "LoadBalancer":
                self.queue.add(svc.meta.key)

    def _ready_nodes(self) -> list[str]:
        return sorted(
            n.meta.name for n in self.informer("Node").list()
            if _node_ready(n) and not n.spec.unschedulable
        )

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        lb_name = _lb_name(namespace, name)
        try:
            svc = self.clientset.services.get(name, namespace)
        except NotFoundError:
            self.lb.ensure_load_balancer_deleted(lb_name)
            return
        if svc.type != "LoadBalancer":
            # type changed away: release the cloud resource and any
            # previously published ingress
            self.lb.ensure_load_balancer_deleted(lb_name)
            if svc.status_load_balancer:
                def _clear(cur):
                    cur.status_load_balancer = []
                    return cur

                self.clientset.services.guaranteed_update(name, _clear, namespace)
            return
        ports = [p.port for p in svc.ports] or [80]
        lb = self.lb.ensure_load_balancer(lb_name, ports, self._ready_nodes())
        if svc.status_load_balancer != [lb.ingress_ip]:
            def _publish(cur):
                cur.status_load_balancer = [lb.ingress_ip]
                return cur

            self.clientset.services.guaranteed_update(name, _publish, namespace)


class RouteController(Controller):
    """``pkg/controller/route/routecontroller.go``: full-state reconcile of
    the cloud route table against node podCIDRs — one route per node with
    an allocated CIDR, stale routes removed."""

    name = "route"
    SYNC_KEY = "routes/all"

    def __init__(self, clientset, informers=None, cloud: CloudProvider = None,
                 cluster_name: str = "kubernetes", **kw):
        super().__init__(clientset, informers, **kw)
        if cloud is None or cloud.routes() is None:
            raise ValueError("RouteController requires a cloud with route support")
        self.routes = cloud.routes()
        self.cluster_name = cluster_name
        self.watch("Node", key_fn=lambda obj: self.SYNC_KEY)

    def sync(self, key: str) -> None:
        want: dict[str, str] = {
            n.meta.name: n.spec.pod_cidr
            for n in self.informer("Node").list() if n.spec.pod_cidr
        }
        have = {r.target_node: r for r in self.routes.list_routes()}
        for node, cidr in want.items():
            existing = have.get(node)
            if existing is None or existing.dest_cidr != cidr:
                if existing is not None:
                    self.routes.delete_route(existing)
                self.routes.create_route(Route(
                    name=f"{self.cluster_name}-{node}",
                    target_node=node, dest_cidr=cidr))
        for node, route in have.items():
            if node not in want:
                self.routes.delete_route(route)


class CloudNodeController(Controller):
    """``pkg/controller/cloud/nodecontroller.go``: stamp freshly registered
    nodes with their cloud addresses, zone/region labels and providerID;
    the periodic monitor deletes Node objects whose backing instance is
    gone from the cloud (the cloud half of node lifecycle)."""

    name = "cloud-node"

    def __init__(self, clientset, informers=None, cloud: CloudProvider = None, **kw):
        super().__init__(clientset, informers, **kw)
        if cloud is None or cloud.instances() is None:
            raise ValueError("CloudNodeController requires a cloud with instances")
        self.instances = cloud.instances()
        self.zones = cloud.zones()
        self.watch("Node")

    def sync(self, key: str) -> None:
        name = key.split("/", 1)[-1]
        # the cloud first: a node it does not know (every node of a cluster
        # on an empty fake cloud) costs no read over the wire, and every
        # heartbeat of every node enqueues its key here
        try:
            addresses = self.instances.node_addresses(name)
        except KeyError:
            return  # unknown to the cloud: the monitor decides its fate
        try:
            node = self.clientset.nodes.get(name)
        except NotFoundError:
            return
        zone = region = ""
        if self.zones is not None:
            try:
                zone, region = self.zones.get_zone(name)
            except KeyError:
                pass
        needs_labels = (
            (zone and node.meta.labels.get(ZONE_LABEL) != zone)
            or (region and node.meta.labels.get(REGION_LABEL) != region)
        )
        if node.status.addresses == addresses and not needs_labels and node.spec.provider_id:
            return

        def _stamp(cur):
            cur.status.addresses = addresses
            if zone:
                cur.meta.labels[ZONE_LABEL] = zone
            if region:
                cur.meta.labels[REGION_LABEL] = region
            if not cur.spec.provider_id:
                cur.spec.provider_id = f"fake://{name}"
            return cur

        self.clientset.nodes.guaranteed_update(name, _stamp, "")

    def monitor(self) -> int:
        """Delete nodes whose cloud instance no longer exists (reference
        ``cloud/nodecontroller.go MonitorNode``)."""
        deleted = 0
        for node in list(self.informer("Node").list()):
            # only cloud-managed nodes (stamped with a providerID) are
            # subject to instance-existence deletion
            if not node.spec.provider_id:
                continue
            if not self.instances.instance_exists(node.meta.name):
                try:
                    self.clientset.nodes.delete(node.meta.name)
                    deleted += 1
                except NotFoundError:
                    pass
        return deleted
