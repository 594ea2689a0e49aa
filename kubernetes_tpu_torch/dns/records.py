"""In-cluster DNS records: Services/Endpoints/Pods → name table.

Capability of the kube-dns addon (reference ``cluster/addons/dns/``,
skydns backed by the kubernetes "treecache" source): watch Services and
Endpoints and materialize the cluster DNS schema

- ``<svc>.<ns>.svc.<zone>``            A → clusterIP (ClusterIP services)
- ``<svc>.<ns>.svc.<zone>``            A → every ready backend IP
                                       (headless services, clusterIP: None)
- ``<pod>.<svc>.<ns>.svc.<zone>``      A → that backend pod's IP (headless
                                       per-pod records, StatefulSet identity)
- ``_<port>._<proto>.<svc>.<ns>.svc.<zone>``  SRV → (port, <svc>.<ns>.svc)
- ``<a-b-c-d>.<ns>.pod.<zone>``        A → a.b.c.d (pod IP echo records)

The table is informer-driven (LIST+WATCH, not polling) and rebuilt
per-service on each event — the treecache analogue, sized for hollow
clusters.  ``resolve()`` is the in-process query API; ``dns.server``
speaks the real wire protocol over UDP on top of it.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..api import types as api
from ..client.informer import Handler, InformerFactory

DEFAULT_ZONE = "cluster.local"


class DNSRecordStore:
    """svc/endpoints → A + SRV record table for one cluster zone."""

    def __init__(self, clientset, informers: Optional[InformerFactory] = None,
                 zone: str = DEFAULT_ZONE):
        self.clientset = clientset
        self.zone = zone.strip(".")
        self.informers = informers or InformerFactory(clientset)
        self._mu = threading.Lock()
        # per-service shards so one service's churn doesn't rebuild the world
        self._a_by_svc: dict[str, dict[str, list[str]]] = {}
        self._srv_by_svc: dict[str, dict[str, list[tuple[int, str]]]] = {}
        self._wire()

    # -- informer wiring ----------------------------------------------------
    def _wire(self) -> None:
        svcs = self.informers.informer("Service")
        svcs.add_handler(Handler(
            on_add=lambda s: self._sync_service(s.meta.key),
            on_update=lambda old, new: self._sync_service(new.meta.key),
            on_delete=lambda s: self._drop_service(s.meta.key),
        ))
        eps = self.informers.informer("Endpoints")
        eps.add_handler(Handler(
            on_add=lambda e: self._sync_service(e.meta.key),
            on_update=lambda old, new: self._sync_service(new.meta.key),
            on_delete=lambda e: self._sync_service(e.meta.key),
        ))

    def start(self, manual: bool = True) -> None:
        if manual:
            self.informers.start_all_manual()
        else:
            self.informers.start_all()
        self.resync()

    def pump(self) -> int:
        return self.informers.pump_all()

    def resync(self) -> None:
        for svc in self.informers.informer("Service").list():
            self._sync_service(svc.meta.key)

    # -- record building ----------------------------------------------------
    def _drop_service(self, key: str) -> None:
        with self._mu:
            self._a_by_svc.pop(key, None)
            self._srv_by_svc.pop(key, None)

    def _sync_service(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        svc = self.informers.informer("Service").get(key)
        if svc is None:
            self._drop_service(key)
            return
        base = f"{name}.{namespace}.svc.{self.zone}"
        a: dict[str, list[str]] = {}
        srv: dict[str, list[tuple[int, str]]] = {}
        eps = self.informers.informer("Endpoints").get(key)
        headless = svc.cluster_ip in ("", "None")
        if not headless:
            a[base] = [svc.cluster_ip]
        backend_ips: list[str] = []
        pod_targets: list[str] = []
        unnamed_backend = False  # ready address with no backing-pod name
        if eps is not None:
            for subset in eps.subsets:
                for addr in subset.addresses:
                    if not addr.ip:
                        continue
                    backend_ips.append(addr.ip)
                    if not addr.target_pod:
                        unnamed_backend = True
                    # per-pod record: <pod>.<svc>.<ns>.svc.<zone> (the
                    # StatefulSet stable-identity path; hostname = the
                    # backing pod's name)
                    if addr.target_pod:
                        pod_name = addr.target_pod.rsplit("/", 1)[-1]
                        a.setdefault(f"{pod_name}.{base}", []).append(addr.ip)
                        pod_targets.append(f"{pod_name}.{base}")
        if headless and backend_ips:
            a[base] = sorted(set(backend_ips))
        # SRV: _<portname>._<proto>.<base> -> (port, target). ClusterIP
        # services target the service name; headless services answer one
        # SRV tuple per ready backend targeting the per-pod name (the
        # reference skydns returns per-backend-pod SRV targets).
        for port in svc.ports:
            if not port.name:
                continue
            sname = f"_{port.name}._{port.protocol.lower()}.{base}"
            if headless and pod_targets:
                for tgt in sorted(set(pod_targets)):
                    srv.setdefault(sname, []).append((port.port, tgt))
                if unnamed_backend:
                    # manually-added (pod-less) backends stay reachable
                    # through the base target, whose A record lists them
                    srv[sname].append((port.port, base))
            else:
                srv.setdefault(sname, []).append((port.port, base))
        with self._mu:
            self._a_by_svc[key] = a
            self._srv_by_svc[key] = srv

    # -- queries -------------------------------------------------------------
    def _pod_echo(self, qname: str) -> Optional[list[str]]:
        """<a-b-c-d>.<ns>.pod.<zone> → a.b.c.d (no state needed)."""
        suffix = f".pod.{self.zone}"
        if not qname.endswith(suffix):
            return None
        head = qname[: -len(suffix)]
        parts = head.split(".")
        if len(parts) != 2:
            return None
        octets = parts[0].split("-")
        if len(octets) != 4 or not all(o.isdigit() and int(o) < 256 for o in octets):
            return None
        return [".".join(octets)]

    def resolve(self, qname: str, qtype: str = "A"):
        """A → list of IPs; SRV → list of (port, target). Empty on miss."""
        qname = qname.strip(".").lower()
        if qtype == "A":
            echo = self._pod_echo(qname)
            if echo is not None:
                return echo
            with self._mu:
                for recs in self._a_by_svc.values():
                    if qname in recs:
                        return list(recs[qname])
            return []
        if qtype == "SRV":
            with self._mu:
                for recs in self._srv_by_svc.values():
                    if qname in recs:
                        return list(recs[qname])
            return []
        return []

    def all_names(self) -> list[str]:
        with self._mu:
            names = set()
            for recs in self._a_by_svc.values():
                names.update(recs)
            for recs in self._srv_by_svc.values():
                names.update(recs)
        return sorted(names)
