"""Per-CLIENT staleness attribution for the watch-fanout SLO.

The cluster-wide ``watch_fanout_staleness`` SLO tells you the fleet is
stale; this module attributes it per client.  The aggregate cannot tell
you WHICH of 10k watchers is stale, and a single wedged dashboard client
hides behind 9,999 healthy ones in any mean.

:class:`WatchFanoutTracker` keeps one integer per registered client —
the last revision that client APPLIED — plus the store head, and derives:

- the **worst-client gauge** (``client_watch_worst_staleness_revisions``,
  registered by :class:`~.metrics.ClientMetrics`): the largest per-client
  revision lag at the last sample.  A gauge, so the serving SLO over it
  (``slo.serving_slos()``) keeps producing data — and can recover — when
  churn stops;
- the **top-K laggard dump**: on an SLO breach the flight recorder's
  snapshot carries ``[{client, lag, applied}...]`` for the K worst
  clients (wired through ``slo.register_breach_context``), so "fan-out
  is stale" auto-captures WHO is stale, not just that someone is.

Lock discipline: one flat lock around two dicts of ints; ``report()`` is
the hollow-watcher hot path and does one dict store.  All reads take a
snapshot under the lock and rank outside it.
"""

from __future__ import annotations

import threading
from typing import Optional

from .metrics import ClientMetrics, DEFAULT_CLIENT_METRICS


class WatchFanoutTracker:
    """Per-client applied-revision ledger → worst-client staleness."""

    def __init__(self, metrics: Optional[ClientMetrics] = None):
        self._mu = threading.Lock()
        # client id -> last revision that client applied to its cache.
        # bounded: one int per REGISTERED client; unregister() removes
        # the entry when a watcher leaves the fleet
        self._applied: dict[str, int] = {}
        self._head = 0  # the store head the lags are measured against
        self.metrics = metrics or DEFAULT_CLIENT_METRICS

    # -- the client side (hollow watchers, informers) ----------------------
    def register(self, client_id: str, revision: int = 0) -> None:
        with self._mu:
            self._applied[client_id] = int(revision)

    def unregister(self, client_id: str) -> None:
        with self._mu:
            self._applied.pop(client_id, None)

    def report(self, client_id: str, revision: int) -> None:
        """The hot path: one dict store per pump batch, no ranking."""
        with self._mu:
            self._applied[client_id] = revision

    # -- the sampling side (scrape loop / bench driver) --------------------
    def observe_head(self, revision: int) -> None:
        with self._mu:
            self._head = max(self._head, int(revision))

    def clients(self) -> int:
        with self._mu:
            return len(self._applied)

    def sample(self) -> int:
        """Recompute the worst-client lag, publish it to the gauge, and
        return it.  Called once per scrape (or bench sample tick) — the
        ranking walk is O(clients) and never runs on a client's path."""
        with self._mu:
            head = self._head
            worst = 0
            for rev in self._applied.values():
                lag = head - rev
                if lag > worst:
                    worst = lag
        self.metrics.watch_worst_staleness.set(float(worst))
        return worst

    def top_laggards(self, k: int = 10) -> list[dict]:
        """The K worst clients by revision lag — the flight recorder's
        breach attribution payload."""
        with self._mu:
            head = self._head
            snap = list(self._applied.items())
        snap.sort(key=lambda it: it[1])
        return [{"client": cid, "applied": rev, "lag": head - rev}
                for cid, rev in snap[:k] if head - rev > 0]

    # -- SLO wiring --------------------------------------------------------
    def attach_breach_context(self, slo_name: str = "watch_fanout_worst_client_staleness",
                              k: int = 10) -> None:
        """Register the top-K laggard dump as the breach context for the
        per-client serving SLO: when it burns, the flight-recorder
        snapshot names the laggards."""
        from . import slo as slo_mod

        slo_mod.register_breach_context(
            slo_name,
            lambda: {"clients": self.clients(),
                     "top_laggards": self.top_laggards(k)})
