"""Federation control plane (reference ``federation/pkg/
federation-controller``): cluster health, per-kind sync fan-out with
status rollup, and cross-cluster service DNS.

The federation apiserver IS the ordinary wire apiserver over its own
store (the reference's federation-apiserver is likewise a trimmed
kube-apiserver) — what makes it a federation is this controller set
running against it, with a member clientset per registered Cluster.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable, Optional

from ..api import types as api
from ..client.clientset import Clientset
from ..controllers.base import Controller
from ..store.store import AlreadyExistsError, NotFoundError
from .types import CLUSTER_OFFLINE, CLUSTER_READY, PLACEMENT_ANNOTATION, Cluster

logger = logging.getLogger("kubernetes_tpu_torch.federation")


def default_member_factory(cluster: Cluster) -> Clientset:
    from ..client.remote import RemoteStore

    return Clientset(RemoteStore(cluster.server_address,
                                 token=cluster.token or None))


class MemberRegistry:
    """Shared cluster -> member-clientset resolution with caching; the
    factory is injectable so tests can wire in-proc clusters."""

    def __init__(self, clientset: Clientset,
                 factory: Callable[[Cluster], Clientset] = default_member_factory):
        self.clientset = clientset
        self.factory = factory
        # name -> ((server_address, token), clientset)
        self._cache: dict[str, tuple[tuple[str, str], Clientset]] = {}
        # one registry is shared by the cluster-probe and federated-sync
        # controllers' workers; the get-or-create below is a
        # check-then-act on the cache
        self._mu = threading.Lock()

    def clusters(self, only_ready: bool = True) -> list[Cluster]:
        out = []
        for c in self.clientset.client_for("Cluster").list("")[0]:
            if not only_ready or c.ready:
                out.append(c)
        return out

    def client(self, cluster: Cluster) -> Clientset:
        # cache keyed on the full connection identity: a rejoined or
        # re-addressed cluster must get a fresh clientset, never keep
        # syncing to the old endpoint
        ident = (cluster.server_address, cluster.token)
        with self._mu:
            entry = self._cache.get(cluster.meta.name)
            if entry is None or entry[0] != ident:
                entry = (ident, self.factory(cluster))
                self._cache[cluster.meta.name] = entry
            return entry[1]


class ClusterController(Controller):
    """``federation-controller/cluster``: probe member /healthz on every
    monitor tick, maintain Ready/Offline conditions."""

    name = "federation-cluster"

    def __init__(self, clientset, informers=None, members: MemberRegistry = None, **kw):
        super().__init__(clientset, informers, **kw)
        self.members = members or MemberRegistry(clientset)
        self.watch("Cluster")

    def _probe(self, cluster: Cluster) -> bool:
        try:
            member = self.members.client(cluster)
            raw = getattr(member.store, "raw", None)
            if raw is not None:
                return json.loads(raw("GET", "/healthz")).get("status") == "ok"
            member.nodes.list()  # in-proc member: a live store IS healthy
            return True
        except Exception:
            return False

    def sync(self, key: str) -> None:
        name = key.split("/", 1)[-1]
        try:
            cluster = self.clientset.client_for("Cluster").get(name, "")
        except NotFoundError:
            self.members._cache.pop(name, None)
            return
        healthy = self._probe(cluster)
        want = {CLUSTER_READY: "True" if healthy else "False",
                CLUSTER_OFFLINE: "False" if healthy else "True"}
        # write ONLY on a state transition: an unconditional write (fresh
        # lastProbeTime) would emit MODIFIED, re-enqueue this key via our
        # own Cluster watch, and livelock the sync loop
        current = {t: (cluster.condition(t) or {}).get("status") for t in want}
        if current == want:
            return

        def _set(cur):
            for ctype, status in want.items():
                cur.set_condition(ctype, status, clock=self.clock)
            return cur

        self.clientset.client_for("Cluster").guaranteed_update(name, _set, "")

    def monitor(self) -> None:
        for c in self.members.clusters(only_ready=False):
            self.queue.add(c.meta.key)


class FederatedSyncController(Controller):
    """``federation-controller/sync`` essential: for ONE kind, fan every
    federated object out to its placement clusters, reconcile drift, and
    delete from members when the federated object is gone.  Deployment
    status rolls up as the sum of member statuses."""

    # member-owned metadata that must not be propagated
    _STRIP = ("uid", "resourceVersion", "creationRevision")

    def __init__(self, clientset, kind: str, informers=None,
                 members: MemberRegistry = None, **kw):
        super().__init__(clientset, informers, **kw)
        self.kind = kind
        self.name = f"federated-{kind.lower()}"
        self.members = members or MemberRegistry(clientset)
        self.watch(kind)
        from ..client.informer import Handler

        # re-reconcile everything when cluster membership/health changes
        self.informers.informer("Cluster").add_handler(Handler(
            on_add=lambda c: self._requeue_all(),
            on_update=lambda old, new: (
                self._requeue_all() if old.ready != new.ready else None),
            on_delete=lambda c: self._requeue_all(),
        ))

    def _requeue_all(self) -> None:
        for obj in self.informer(self.kind).list():
            self.queue.add(obj.meta.key)

    def monitor(self) -> None:
        """Periodic full resync: member-side drift and member status
        changes are invisible to the federation store's watches (the
        reference runs per-member informers; a tick-driven resync is the
        same level-triggered contract)."""
        self._requeue_all()

    def _placement(self, obj) -> Optional[set]:
        raw = obj.meta.annotations.get(PLACEMENT_ANNOTATION)
        if raw is None:
            return None  # all ready clusters
        try:
            return set(json.loads(raw))
        except (ValueError, TypeError):
            logger.warning("%s: bad placement annotation on %s", self.name,
                           obj.meta.key)
            return None

    def _wire_for_member(self, obj) -> dict:
        d = obj.to_dict()
        meta = d.get("metadata") or {}
        for k in self._STRIP:
            meta.pop(k, None)
        d.pop("status", None)  # member-owned
        return d

    def sync(self, key: str) -> None:
        namespace, _, name = key.rpartition("/")
        client = self.clientset.client_for(self.kind)
        try:
            fed_obj = client.get(name, namespace)
        except NotFoundError:
            fed_obj = None
        clusters = self.members.clusters()
        placement = self._placement(fed_obj) if fed_obj is not None else set()
        want_wire = self._wire_for_member(fed_obj) if fed_obj is not None else None

        totals = {"replicas": 0, "ready": 0, "updated": 0}
        for cluster in clusters:
            member = self.members.client(cluster).client_for(self.kind)
            targeted = fed_obj is not None and (
                placement is None or cluster.meta.name in placement)
            try:
                existing = member.get(name, namespace)
            except NotFoundError:
                existing = None
            if not targeted:
                if existing is not None:
                    member.delete(name, namespace)
                continue
            if existing is None:
                try:
                    member.create(type(fed_obj).from_dict(want_wire))
                except AlreadyExistsError:
                    pass
                existing = member.get(name, namespace)
            elif self._wire_for_member(existing) != want_wire:
                def _overwrite(cur):
                    new = type(cur).from_dict(want_wire)
                    new.meta.uid = cur.meta.uid
                    new.meta.resource_version = cur.meta.resource_version
                    if hasattr(cur, "status"):
                        new.status = cur.status
                    return new

                existing = member.guaranteed_update(name, _overwrite, namespace)
            if self.kind == "Deployment":
                totals["replicas"] += existing.status_replicas
                totals["ready"] += existing.status_ready_replicas
                totals["updated"] += existing.status_updated_replicas

        if fed_obj is not None and self.kind == "Deployment":
            # skip the no-op write: it would MODIFIED-requeue this key
            # through our own watch forever (the livelock the deployment
            # controller also guards against)
            if (fed_obj.status_replicas, fed_obj.status_ready_replicas,
                    fed_obj.status_updated_replicas) == (
                    totals["replicas"], totals["ready"], totals["updated"]):
                return

            def _rollup(cur):
                cur.status_replicas = totals["replicas"]
                cur.status_ready_replicas = totals["ready"]
                cur.status_updated_replicas = totals["updated"]
                return cur

            client.guaranteed_update(name, _rollup, namespace)


class ServiceDNSController(Controller):
    """``federation-controller/service``'s DNS half: synthesize
    cross-cluster records ``<svc>.<ns>.<federation>.svc.<zone>`` from the
    member clusters' published LoadBalancer ingress IPs, with per-zone /
    per-region scoping (the reference's three-level fallback chain).
    Records land in an in-memory zone table standing in for the cloud
    ``dnsprovider``."""

    name = "federation-service-dns"

    def __init__(self, clientset, informers=None, members: MemberRegistry = None,
                 federation_name: str = "myfed", dns_zone: str = "example.com", **kw):
        super().__init__(clientset, informers, **kw)
        self.members = members or MemberRegistry(clientset)
        self.federation_name = federation_name
        self.dns_zone = dns_zone
        self.records: dict[str, list[str]] = {}
        # sync() runs on worker threads (possibly several), resolve() on
        # whoever serves DNS: the multi-step record rebuild must be
        # atomic against both (a resolver between the filter and the
        # re-insert would see the service briefly vanish)
        self._records_mu = threading.Lock()
        self.watch("Service")

    def monitor(self) -> None:
        """Member LB ingress IPs appear asynchronously (cloud controllers
        in the members); re-derive all records each tick."""
        for svc in self.informer("Service").list():
            self.queue.add(svc.meta.key)

    def sync(self, key: str) -> None:
        namespace, _, name = key.rpartition("/")
        base = f"{name}.{namespace}.{self.federation_name}.svc.{self.dns_zone}"
        try:
            self.clientset.services.get(name, namespace)
        except NotFoundError:
            with self._records_mu:
                self.records = {k: v for k, v in self.records.items()
                                if k != base and not k.endswith("." + base)}
            return
        global_ips: list[str] = []
        by_scope: dict[str, list[str]] = {}
        for cluster in self.members.clusters():
            member = self.members.client(cluster)
            try:
                svc = member.services.get(name, namespace)
            except NotFoundError:
                continue
            ips = list(svc.status_load_balancer)
            global_ips.extend(ips)
            for scope in (cluster.zone, cluster.region):
                if scope:
                    by_scope.setdefault(scope, []).extend(ips)
        # rebuild this service's record set ATOMICALLY: stale scoped
        # records (a zone whose member dropped the service) must vanish,
        # so a scoped lookup falls back up the chain instead of serving a
        # dead IP — and a concurrent resolve()/sibling sync() must never
        # observe the half-rebuilt table
        with self._records_mu:
            rebuilt = {k: v for k, v in self.records.items()
                       if k != base and not k.endswith("." + base)}
            rebuilt[base] = sorted(global_ips)
            for scope, ips in by_scope.items():
                if ips:  # an empty scope is NO record, so lookups fall back
                    rebuilt[f"{scope}.{base}"] = sorted(ips)
            self.records = rebuilt

    def resolve(self, fqdn: str) -> list[str]:
        """Three-level chain: exact record, else strip the leading scope
        label (zone -> region -> global) like the reference's CNAME
        fallback chain."""
        # one snapshot for the whole walk: writers only ever PUBLISH a
        # fully-built table (atomic rebind under _records_mu), so the
        # chain below can never mix two generations of records
        records = self.records
        probe = fqdn
        while True:
            ips = records.get(probe)
            if ips:
                return ips
            if "." not in probe:
                return []
            head, rest = probe.split(".", 1)
            if rest in records or "." in rest:
                probe = rest
            else:
                return []
