"""HollowProxy: the per-node proxy agent wired to informers.

Capability of kubemark's HollowProxy (``pkg/kubemark/hollow_proxy.go``):
a real Proxier fed by Service/Endpoints watches, with no kernel
underneath.  A fleet of these alongside ``HollowFleet`` models the full
node dataplane at 5k-node scale on one machine.

Scale shape: one shared Service informer + one shared Endpoints informer
drive EVERY hollow proxier's change trackers (the informer fan-out of
SURVEY.md P4); each node's ``sync()`` then folds only its own pending
deltas, the fleet's proxiers reading each Endpoints object's addresses
once between them (``proxier.EndpointsCache``).

``FleetMetrics`` serves a fleet's rule tables on a daemon's ``/metrics``
(computed when scraped, so a tick pays nothing for it): the syncs, the
rules and the endpoints they hold summed over the fleet, how many
proxiers hold a rule set other than the first one's, and that rule set's
digest (``digest(rule_rows(rules))``), which a check from outside can
compute from the Services and their ready pods."""

from __future__ import annotations

import hashlib
import json
import time
from typing import Callable, Optional

from ..client.clientset import Clientset
from ..client.informer import Handler, InformerFactory
from ..utils.metrics import ReadingsMetric
from .proxier import EndpointsCache, Proxier


class HollowProxy:
    def __init__(
        self,
        clientset: Clientset,
        node_name: str,
        informers: Optional[InformerFactory] = None,
        clock: Callable[[], float] = time.monotonic,
        endpoints_cache: Optional[EndpointsCache] = None,
    ):
        self.clientset = clientset
        self.proxier = Proxier(node_name=node_name, clock=clock,
                               endpoints_cache=endpoints_cache)
        self.informers = informers or InformerFactory(clientset)
        self._wire()

    def _wire(self) -> None:
        p = self.proxier
        self.informers.informer("Service").add_handler(Handler(
            on_add=lambda s: p.on_service_update(s),
            on_update=lambda old, new: p.on_service_update(new),
            on_delete=lambda s: p.on_service_update(None, key=s.meta.key),
        ))
        self.informers.informer("Endpoints").add_handler(Handler(
            on_add=lambda e: p.on_endpoints_update(e),
            on_update=lambda old, new: p.on_endpoints_update(new),
            on_delete=lambda e: p.on_endpoints_update(None, key=e.meta.key),
        ))

    def start(self) -> None:
        self.informers.start_all_manual()
        self.proxier.sync()

    def tick(self) -> None:
        """Pump watches and resync the table (the proxier's syncPeriod)."""
        self.informers.pump_all()
        self.proxier.sync()


class HollowProxyFleet:
    """N hollow proxies sharing one informer factory, and one
    ``EndpointsCache``: an Endpoints update is read once for the fleet."""

    def __init__(
        self,
        clientset: Clientset,
        node_names: list[str],
        clock: Callable[[], float] = time.monotonic,
    ):
        self.informers = InformerFactory(clientset)
        cache = EndpointsCache()
        self.proxies = [
            HollowProxy(clientset, name, informers=self.informers, clock=clock,
                        endpoints_cache=cache)
            for name in node_names
        ]

    def start(self) -> None:
        self.informers.start_all_manual()
        for p in self.proxies:
            p.proxier.sync()

    def tick_all(self) -> None:
        self.informers.pump_all()
        for p in self.proxies:
            p.proxier.sync()

    def stop(self) -> None:
        self.informers.stop_all()


def rule_rows(rules: dict) -> list:
    """A rule table in canonical form: one sorted row per rule, (kind, vip,
    port, protocol, service port name, its endpoints' sorted (ip, port)).
    Whether an endpoint is local differs by node and is left out."""
    return sorted(
        [r.kind, r.vip, r.port, r.protocol, str(r.service),
         sorted([e.ip, e.port] for e in r.endpoints)]
        for r in rules.values())


def digest(rows: list) -> int:
    """The first 48 bits of the rows' SHA-256: an integer a float gauge
    carries exactly."""
    raw = json.dumps(rows, separators=(",", ":")).encode()
    return int(hashlib.sha256(raw).hexdigest()[:12], 16)


class FleetMetrics(ReadingsMetric):
    """The fleet's proxy counters on a daemon's registry, read from the
    proxiers when scraped."""

    name = "hollow_proxy"

    def __init__(self, fleet: HollowProxyFleet):
        self.fleet = fleet

    def values(self) -> dict:
        proxiers = [p.proxier for p in self.fleet.proxies]
        tables = [p.rules for p in proxiers]  # each sync swaps in a new dict
        digests = [digest(rule_rows(t)) for t in tables]
        first = digests[0] if digests else 0
        return {
            "proxiers": len(proxiers),
            "syncs_total": sum(p.syncs for p in proxiers),
            "rules": sum(len(t) for t in tables),
            "rule_endpoints": sum(len(r.endpoints) for t in tables for r in t.values()),
            "rule_sets_differing": sum(1 for d in digests if d != first),
            "rule_set_digest": first,
        }
