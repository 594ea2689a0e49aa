"""Per-node service VIP dataplane: full-state rule sync + routing.

Capability of the reference's iptables proxier
(``pkg/proxy/iptables/proxier.go``, 1,752 LoC):

- ``syncProxyRules`` (``proxier.go:966``) is a FULL-STATE rewrite: every
  sync rebuilds the complete NAT table from the current Services and
  Endpoints maps — no incremental rule surgery.  ``Proxier.sync()`` does
  the same: it derives a fresh ``RuleTable`` (the iptables-restore
  analogue) from the accumulated change trackers.
- Change trackers (``serviceChanges`` / ``endpointsChanges``,
  ``proxier.go:203,260``): informer events record deltas; the sync loop
  folds them into ``service_map`` / ``endpoints_map`` and marks the
  table dirty.
- Per-rule semantics mirrored: ClusterIP → DNAT to a ready endpoint,
  NodePort rules, REJECT for VIPs with no endpoints, session affinity
  (ClientIP mode with timeout, ``proxier.go:169 affinityState``),
  headless services (no clusterIP) produce no rules, only READY
  addresses are load-balancing targets.
- Stale-affinity cleanup on endpoint removal (``proxier.go:1120``
  ``deleteEndpointConnections`` analogue — we drop sticky entries whose
  endpoint vanished).

The routing itself (``route()``) models the kernel's packet path so the
fleet and e2e tests can send "traffic" through the table; selection is
round-robin per service port (the userspace proxier's ``LoadBalancerRR``,
``pkg/proxy/userspace/roundrobin.go``) — the iptables mode's random
statistic match has the same distributional contract.

The maps are the JAX proxier's, built the same way, but a sync rebuilds
only the entries of the Services and Endpoints that changed since the
last one, and an Endpoints object's addresses are read once for every
proxier that shares an ``EndpointsCache`` (a ``HollowProxyFleet``'s): an
update that reaches a fleet's 500 proxiers costs one pass over its
addresses and, a proxier, one pass over its ports.  The rule table is
the full-state one the JAX sync builds, equal value for value.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..api import types as api
from ..api.cluster import Endpoints

DEFAULT_AFFINITY_TIMEOUT = 10800.0  # seconds (reference v1.7 default)


@dataclass(frozen=True)
class ServicePortName:
    """One load-balanced unit: a (service, port-name) pair
    (``pkg/proxy/types.go`` ServicePortName)."""

    namespace: str
    name: str
    port: str  # ServicePort.name ("" for single unnamed port)

    def __str__(self) -> str:
        return f"{self.namespace}/{self.name}:{self.port}"


@dataclass(frozen=True)
class EndpointInfo:
    ip: str
    port: int
    is_local: bool  # backing pod runs on this proxier's node


@dataclass
class ServiceInfo:
    cluster_ip: str
    port: int
    protocol: str
    node_port: int
    session_affinity: str  # "None" | "ClientIP"
    affinity_timeout: float = DEFAULT_AFFINITY_TIMEOUT


@dataclass
class Rule:
    """One synthesized dataplane rule (an iptables chain analogue)."""

    kind: str  # "cluster" | "nodeport" | "reject"
    vip: str
    port: int
    protocol: str
    service: ServicePortName
    endpoints: tuple[EndpointInfo, ...] = ()


class EndpointsCache:
    """For each Endpoints object (by identity, under its key): its service
    ports in the order a sync reads them, each with the shared tuple of its
    ready endpoints none of which is local, and the positions each node's
    endpoints hold in it.  Proxiers that share one read an object's
    addresses once."""

    def __init__(self):
        self._mu = threading.Lock()
        self._by_key: dict[str, tuple] = {}

    def ports(self, eps: Endpoints) -> list:
        key = eps.meta.key
        with self._mu:
            hit = self._by_key.get(key)
        if hit is not None and hit[0] is eps:
            return hit[1]
        ns, name = eps.meta.namespace, eps.meta.name
        built = []
        for subset in eps.subsets:
            for ep_port in subset.ports:
                infos, local = [], {}
                # only READY addresses load-balance (notReady excluded)
                for a in subset.addresses:
                    if a.node_name:
                        local.setdefault(a.node_name, []).append(len(infos))
                    infos.append(EndpointInfo(ip=a.ip, port=ep_port.port, is_local=False))
                built.append((ServicePortName(ns, name, ep_port.name), tuple(infos), local))
        with self._mu:
            self._by_key[key] = (eps, built)
        return built

    def forget(self, key: str) -> None:
        """Drop a deleted Endpoints object's entry (a proxier that still
        holds an object of that key rebuilds it)."""
        with self._mu:
            self._by_key.pop(key, None)

    def __len__(self) -> int:
        with self._mu:
            return len(self._by_key)


class _AffinityState:
    __slots__ = ("endpoint", "last_used")

    def __init__(self, endpoint: EndpointInfo, now: float):
        self.endpoint = endpoint
        self.last_used = now


class Proxier:
    """One node's dataplane.  Feed it service/endpoints deltas (informer
    handlers), call ``sync()``, then ``route()`` traffic through it."""

    def __init__(self, node_name: str = "", clock: Callable[[], float] = time.monotonic,
                 endpoints_cache: Optional[EndpointsCache] = None):
        self.node_name = node_name
        self.clock = clock
        self._lock = threading.Lock()
        self._eps_cache = endpoints_cache if endpoints_cache is not None else EndpointsCache()
        # each Service's and each Endpoints' own entries of the maps, and
        # the keys changed since the last sync
        self._svc_entries: dict[str, dict] = {}
        self._eps_entries: dict[str, dict] = {}
        self._changed_services: set = set()
        self._changed_endpoints: set = set()
        # accumulated change-tracker state (folded on sync)
        self._pending_services: dict[str, Optional[api.Service]] = {}
        self._pending_endpoints: dict[str, Optional[Endpoints]] = {}
        # folded maps
        self.service_map: dict[ServicePortName, ServiceInfo] = {}
        self.endpoints_map: dict[ServicePortName, tuple[EndpointInfo, ...]] = {}
        self._services_by_key: dict[str, api.Service] = {}
        self._endpoints_by_key: dict[str, Endpoints] = {}
        # derived rule table + runtime LB state
        self.rules: dict[tuple, Rule] = {}
        self._rr: dict[ServicePortName, int] = {}
        self._affinity: dict[tuple[ServicePortName, str], _AffinityState] = {}
        self.syncs = 0
        self.last_sync: float = 0.0

    # -- change trackers (informer side) -----------------------------------
    def on_service_update(self, svc: Optional[api.Service], key: Optional[str] = None) -> None:
        """svc=None (with key) records a deletion."""
        with self._lock:
            if svc is None:
                if key:
                    self._pending_services[key] = None
            else:
                self._pending_services[svc.meta.key] = svc

    def on_endpoints_update(self, eps: Optional[Endpoints], key: Optional[str] = None) -> None:
        with self._lock:
            if eps is None:
                if key:
                    self._pending_endpoints[key] = None
            else:
                self._pending_endpoints[eps.meta.key] = eps

    # -- full-state sync (syncProxyRules) ----------------------------------
    def _fold_changes(self) -> None:
        for key, svc in self._pending_services.items():
            if svc is None:
                self._services_by_key.pop(key, None)
            else:
                self._services_by_key[key] = svc
            self._changed_services.add(key)
        for key, eps in self._pending_endpoints.items():
            if eps is None:
                self._endpoints_by_key.pop(key, None)
                self._eps_cache.forget(key)
            else:
                self._endpoints_by_key[key] = eps
            self._changed_endpoints.add(key)
        self._pending_services.clear()
        self._pending_endpoints.clear()

    def _service_entries(self, svc: api.Service) -> dict[ServicePortName, ServiceInfo]:
        out: dict[ServicePortName, ServiceInfo] = {}
        # headless services get no VIP rules (proxier.go shouldSkipService)
        if svc.cluster_ip in ("", "None"):
            return out
        for sp in svc.ports:
            spn = ServicePortName(svc.meta.namespace, svc.meta.name, sp.name)
            out[spn] = ServiceInfo(
                cluster_ip=svc.cluster_ip,
                port=sp.port,
                protocol=sp.protocol,
                node_port=sp.node_port if svc.type in ("NodePort", "LoadBalancer") else 0,
                session_affinity=svc.session_affinity,
            )
        return out

    def _endpoints_entries(self, eps: Endpoints) -> dict[ServicePortName, tuple[EndpointInfo, ...]]:
        out: dict[ServicePortName, tuple[EndpointInfo, ...]] = {}
        for spn, shared, local in self._eps_cache.ports(eps):
            infos = shared
            mine = local.get(self.node_name) if self.node_name else None
            if mine:
                lst = list(shared)
                for i in mine:
                    lst[i] = EndpointInfo(ip=lst[i].ip, port=lst[i].port, is_local=True)
                infos = tuple(lst)
            out[spn] = out.get(spn, ()) + infos
        return out

    def _build_service_map(self) -> dict[ServicePortName, ServiceInfo]:
        for key in self._changed_services:
            svc = self._services_by_key.get(key)
            if svc is None:
                self._svc_entries.pop(key, None)
            else:
                self._svc_entries[key] = self._service_entries(svc)
        self._changed_services.clear()
        out: dict[ServicePortName, ServiceInfo] = {}
        for key in self._services_by_key:
            out.update(self._svc_entries[key])
        return out

    def _build_endpoints_map(self) -> dict[ServicePortName, tuple[EndpointInfo, ...]]:
        for key in self._changed_endpoints:
            eps = self._endpoints_by_key.get(key)
            if eps is None:
                self._eps_entries.pop(key, None)
            else:
                self._eps_entries[key] = self._endpoints_entries(eps)
        self._changed_endpoints.clear()
        out: dict[ServicePortName, tuple[EndpointInfo, ...]] = {}
        for key in self._endpoints_by_key:
            out.update(self._eps_entries[key])
        return out

    # optional ProxierHealthServer (healthcheck.py): touched after every
    # successful sync so the node healthz reflects dataplane freshness
    health_server = None

    def sync(self) -> dict[tuple, Rule]:
        """Rebuild the whole rule table (one iptables-restore batch).
        A no-delta resync is a heartbeat: it refreshes health/affinity
        bookkeeping without rebuilding identical maps."""
        with self._lock:
            if self.syncs > 0 and not self._pending_services and not self._pending_endpoints:
                self._expire_affinity()
                self.syncs += 1
                self.last_sync = self.clock()
                if self.health_server is not None:
                    self.health_server.touch()
                return self.rules
            self._fold_changes()
            self.service_map = self._build_service_map()
            self.endpoints_map = self._build_endpoints_map()

            rules: dict[tuple, Rule] = {}
            for spn, info in self.service_map.items():
                eps = self.endpoints_map.get(spn, ())
                if not eps:
                    # VIP with no backends REJECTs (proxier.go:1396)
                    rules[("reject", info.cluster_ip, info.port, info.protocol)] = Rule(
                        kind="reject", vip=info.cluster_ip, port=info.port,
                        protocol=info.protocol, service=spn,
                    )
                    continue
                rules[("cluster", info.cluster_ip, info.port, info.protocol)] = Rule(
                    kind="cluster", vip=info.cluster_ip, port=info.port,
                    protocol=info.protocol, service=spn, endpoints=eps,
                )
                if info.node_port:
                    rules[("nodeport", "", info.node_port, info.protocol)] = Rule(
                        kind="nodeport", vip="", port=info.node_port,
                        protocol=info.protocol, service=spn, endpoints=eps,
                    )
            self.rules = rules

            # drop sticky entries whose endpoint vanished
            if self._affinity:
                live: set[tuple[ServicePortName, EndpointInfo]] = {
                    (spn, ep) for spn, eps in self.endpoints_map.items() for ep in eps
                }
                self._affinity = {
                    k: st for k, st in self._affinity.items() if (k[0], st.endpoint) in live
                }
            self._expire_affinity()
            self.syncs += 1
            self.last_sync = self.clock()
            if self.health_server is not None:
                self.health_server.touch()
            return rules

    def _expire_affinity(self) -> None:
        """Prune sticky entries past their service's timeout — one-time
        client IPs must not accumulate forever (lock held by caller)."""
        now = self.clock()
        stale = [
            k for k, st in self._affinity.items()
            if now - st.last_used > self.service_map.get(
                k[0], ServiceInfo("", 0, "", 0, "None")
            ).affinity_timeout
        ]
        for k in stale:
            del self._affinity[k]

    # -- the packet path ----------------------------------------------------
    def _pick(self, spn: ServicePortName, eps: tuple[EndpointInfo, ...],
              info: ServiceInfo, client_ip: str) -> EndpointInfo:
        now = self.clock()
        if info.session_affinity == "ClientIP" and client_ip:
            akey = (spn, client_ip)
            st = self._affinity.get(akey)
            if st is not None and now - st.last_used <= info.affinity_timeout:
                st.last_used = now
                return st.endpoint
        i = self._rr.get(spn, 0)
        ep = eps[i % len(eps)]
        self._rr[spn] = i + 1
        if info.session_affinity == "ClientIP" and client_ip:
            self._affinity[(spn, client_ip)] = _AffinityState(ep, now)
        return ep

    def route(self, vip: str, port: int, protocol: str = "TCP",
              client_ip: str = "") -> Optional[EndpointInfo]:
        """ClusterIP path: returns the chosen backend, or None (REJECT)."""
        with self._lock:
            rule = self.rules.get(("cluster", vip, port, protocol))
            if rule is None or not rule.endpoints:
                return None
            info = self.service_map[rule.service]
            return self._pick(rule.service, rule.endpoints, info, client_ip)

    def route_node_port(self, node_port: int, protocol: str = "TCP",
                        client_ip: str = "") -> Optional[EndpointInfo]:
        with self._lock:
            rule = self.rules.get(("nodeport", "", node_port, protocol))
            if rule is None or not rule.endpoints:
                return None
            info = self.service_map[rule.service]
            return self._pick(rule.service, rule.endpoints, info, client_ip)

    # -- health (pkg/proxy/healthcheck) ------------------------------------
    def local_endpoint_count(self, namespace: str, name: str) -> int:
        """Ready endpoints on this node, per service — what the reference's
        service health-check server reports for LB traffic policies."""
        with self._lock:
            total = 0
            seen: set[str] = set()
            for spn, eps in self.endpoints_map.items():
                if spn.namespace != namespace or spn.name != name:
                    continue
                for ep in eps:
                    if ep.is_local and ep.ip not in seen:
                        seen.add(ep.ip)
                        total += 1
            return total

    def healthz(self, stale_after: float = 60.0) -> bool:
        return self.syncs > 0 and (self.clock() - self.last_sync) <= stale_after
