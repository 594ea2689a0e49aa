"""The HPA's metrics source: node stats scraped into per-pod utilization.

Capability of ``pkg/controller/podautoscaler/metrics/metrics_client.go``
(the heapster REST client): scrape every node's kubelet stats-summary
document (``pkg/kubelet/server/stats/summary.go``), keep the last two
CPU samples per pod, and answer *CPU utilization as percent of request*
— cumulative CPU deltas over wall time, exactly how a rate is derived
from cadvisor counters.  The scrape dials the node's kubeletURL
directly, falling back to the apiserver's node proxy
(``/api/v1/nodes/<n>/proxy/stats/summary``) when the direct dial fails
or no kubeletURL is published — so tunnel-only nodes still feed the HPA.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Optional

from ..api import types as api

logger = logging.getLogger("kubernetes_tpu_torch.metrics")


class MetricsClient:
    def __init__(self, clientset, scrape_interval: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.monotonic):
        self.clientset = clientset
        self.scrape_interval = scrape_interval
        self.clock = clock
        # rates need REAL elapsed time even under a fake test clock
        self.wall_clock = wall_clock
        self._last_scrape = -1e18
        # pod key -> (wall_t, cumulative cpu ms); two generations for rates
        self._prev: dict[str, tuple[float, float]] = {}
        self._cur: dict[str, tuple[float, float]] = {}
        # generations roll only when at least this much wall time passed:
        # /proc CPU counters tick at ~10ms, so a near-zero window reads a
        # spurious zero rate
        self.min_rate_window = 0.25
        self._memory: dict[str, int] = {}
        self._pod_node: dict[str, str] = {}  # last node each pod reported from
        # node -> scrape counter at demotion: scrape via proxy only until
        # DIRECT_RETRY_SWEEPS pass, then retry the direct dial (a node
        # that recovers gets its direct path back; entries for deleted
        # nodes are pruned each sweep)
        self._direct_bad: dict[str, int] = {}
        self.stats = {"scrapes": 0, "nodes_ok": 0, "nodes_failed": 0}
        # utilization() runs on EVERY HPA worker thread (run_workers
        # defaults to 2): without this lock, concurrent scrapes lose
        # stat updates, double-roll the sample generations (defeating
        # min_rate_window), and the eviction comprehensions can raise
        # "dictionary changed size during iteration" mid-sync.  Held
        # across the whole sweep — the throttle means at most one sweep
        # per interval actually dials nodes; contenders return fast.
        self._mu = threading.Lock()

    # how many sweeps a node stays demoted to the proxy before the
    # direct dial is retried (~1 min at the default 5s interval)
    DIRECT_RETRY_SWEEPS = 12

    # -- scraping ------------------------------------------------------------
    def _fetch_summary(self, node: api.Node) -> Optional[dict]:
        url = node.status.kubelet_url
        raw = getattr(self.clientset.store, "raw", None)
        demoted_at = self._direct_bad.get(node.meta.name)
        if demoted_at is not None and (
                self.stats["scrapes"] - demoted_at >= self.DIRECT_RETRY_SWEEPS):
            self._direct_bad.pop(node.meta.name)
            demoted_at = None
        # a node whose direct dial recently failed goes straight to the
        # proxy — otherwise every sweep pays the full direct timeout per
        # tunnel-only node before the call that actually works
        if url and demoted_at is None:
            try:
                # blocking-ok — the sweep dials under _mu by design (see _mu's init comment): the interval throttle means contenders return fast instead of racing duplicate sweeps
                with urllib.request.urlopen(f"{url}/stats/summary", timeout=5) as r:
                    return json.loads(r.read())
            except Exception as e:  # noqa: BLE001 — a down node must not stop the sweep
                logger.debug("direct stats scrape of %s failed: %s",
                             node.meta.name, e)
                if raw is not None:  # demote only when a proxy path exists
                    self._direct_bad[node.meta.name] = self.stats["scrapes"]
        # fall back to the apiserver node proxy when the clientset is
        # remote (RemoteStore carries .raw): nodes reachable only through
        # the tunneler still feed the HPA pipeline
        if raw is None:
            return None
        try:
            body = raw("GET",
                       f"/api/v1/nodes/{node.meta.name}/proxy/stats/summary")
            return json.loads(body)
        except Exception as e:  # noqa: BLE001
            logger.debug("proxied stats scrape of %s failed: %s",
                         node.meta.name, e)
            # both paths down: let the next sweep retry the direct dial
            self._direct_bad.pop(node.meta.name, None)
            return None

    def _scrapeable(self, node: api.Node) -> bool:
        return bool(node.status.kubelet_url
                    or getattr(self.clientset.store, "raw", None))

    def scrape(self, force: bool = False) -> None:
        """One sweep over every node with a kubelet endpoint; throttled
        to ``scrape_interval`` unless forced."""
        with self._mu:
            self._scrape_locked(force)

    def _scrape_locked(self, force: bool) -> None:
        now = self.clock()
        if not force and now - self._last_scrape < self.scrape_interval:
            return
        self._last_scrape = now
        wall = self.wall_clock()
        self.stats["scrapes"] += 1
        sample: dict[str, tuple[float, float]] = {}
        memory: dict[str, int] = {}
        pod_node: dict[str, str] = {}
        ok_nodes: set[str] = set()
        all_nodes: set[str] = set()
        for node in self.clientset.nodes.list()[0]:
            all_nodes.add(node.meta.name)
            summary = self._fetch_summary(node)
            if summary is None:
                if self._scrapeable(node):
                    self.stats["nodes_failed"] += 1
                continue
            self.stats["nodes_ok"] += 1
            ok_nodes.add(node.meta.name)
            for entry in summary.get("pods", []):
                ref = entry.get("podRef") or {}
                key = f"{ref.get('namespace', 'default')}/{ref.get('name', '')}"
                pod_node[key] = node.meta.name
                memory[key] = int((entry.get("memory") or {}).get("usageBytes", 0))
                cpu = entry.get("cpu") or {}
                if "cumulativeCpuMillis" in cpu:
                    sample[key] = (wall, float(cpu["cumulativeCpuMillis"]))
        # generations roll only when the new sweep actually sampled CPU
        # (a sweep of down nodes must not wipe the rate window) AND the
        # current generation is old enough to anchor a meaningful rate —
        # back-to-back scrapes otherwise collapse the window below the
        # counter tick and read a spurious zero
        if sample:
            ref_wall = max((t for t, _ in self._cur.values()), default=None)
            if ref_wall is None or wall - ref_wall >= self.min_rate_window:
                self._prev = {k: v for k, v in self._cur.items() if k in sample}
            self._cur.update(sample)
        # evict ONLY pods whose node was scraped successfully this sweep
        # and no longer reports them — a down node's pods keep their rate
        # window until the node answers again (partial-outage safety)
        for gone in [k for k in self._cur
                     if k not in sample and self._pod_node.get(k) in ok_nodes]:
            self._cur.pop(gone)
            self._prev.pop(gone, None)
        for gone in [k for k in self._memory
                     if k not in memory and self._pod_node.get(k) in ok_nodes]:
            self._memory.pop(gone)
            self._pod_node.pop(gone, None)
        self._pod_node.update(pod_node)
        self._memory.update(memory)
        # deleted nodes must not accumulate in the demotion ledger
        for gone in [n for n in self._direct_bad if n not in all_nodes]:
            self._direct_bad.pop(gone)

    # -- queries -------------------------------------------------------------
    def pod_cpu_millicores(self, pod_key: str) -> Optional[float]:
        """Observed CPU rate in millicores, from the last two samples;
        None until two samples exist."""
        with self._mu:
            cur = self._cur.get(pod_key)
            prev = self._prev.get(pod_key)
        if cur is None or prev is None:
            return None
        dt = cur[0] - prev[0]
        if dt <= 0:
            return None
        return max(0.0, (cur[1] - prev[1]) / dt) / 1000.0 * 1000.0  # ms/s = millicores

    def pod_memory_bytes(self, pod_key: str) -> Optional[int]:
        with self._mu:
            return self._memory.get(pod_key)

    def utilization(self, pod: api.Pod) -> Optional[float]:
        """CPU utilization as percent of the pod's CPU request — the
        number the HPA's replica calculator consumes
        (``replica_calculator.go GetResourceReplicas``).  Scrapes lazily
        (throttled) so the HPA needs no separate pump.

        Returns **None** when no rate exists yet (fewer than two samples,
        node down, or no CPU request): missing data must read as
        "unknown", never as "idle" — the reference HPA skips scaling on
        missing metrics rather than scaling to min."""
        self.scrape()
        rate = self.pod_cpu_millicores(pod.meta.key)
        if rate is None:
            return None
        request_m = 0
        for c in pod.spec.containers:
            q = c.resources.requests.get("cpu")
            if q is not None:
                request_m += int(q.milli_value())
        if request_m <= 0:
            return None
        return rate / request_m * 100.0
