"""Horizontal pod autoscaler controller.

Capability of ``pkg/controller/podautoscaler/horizontal.go`` (1,449 LoC):
per HPA, read the target workload's pods' CPU utilization from a metrics
source (the reference scrapes heapster; here any callable
``metrics(pod) -> percent-of-request``), compute

    desired = ceil(current * observed / target)

(``replica_calculator.go``), clamp to [min,max], apply a tolerance band
(±10%) and scale the target via its scale client.  Driven by ``tick()``
(the reference polls every 30s)."""

from __future__ import annotations

import math
from typing import Callable, Optional

from ..api import types as api
from ..api.cluster import HorizontalPodAutoscaler
from ..store.store import NotFoundError
from .base import Controller

TOLERANCE = 0.1  # reference defaultTestingTolerance / horizontal.go tolerance


class HorizontalPodAutoscalerController(Controller):
    name = "horizontalpodautoscaler"

    def __init__(self, clientset, informers=None,
                 metrics: Optional[Callable[[api.Pod], float]] = None,
                 metrics_client=None, **kw):
        super().__init__(clientset, informers, **kw)
        # metrics source: per-pod CPU as percent of request.  Default is
        # the REAL pipeline — kubelet stats-summary scraped by the
        # MetricsClient (metrics_client.go) — not an injected stub; an
        # explicit callable still overrides for tests
        if metrics is None:
            from .metrics_client import MetricsClient

            self.metrics_client = metrics_client or MetricsClient(clientset)
            self.metrics = self.metrics_client.utilization
        else:
            self.metrics_client = metrics_client
            self.metrics = metrics
        self.watch("HorizontalPodAutoscaler")

    def tick(self) -> None:
        # informer cache, not a wire LIST per resync period
        for hpa in self.informer("HorizontalPodAutoscaler").list():
            self.queue.add(hpa.meta.key)

    def _target_client(self, hpa: HorizontalPodAutoscaler):
        return self.clientset.client_for(hpa.target_kind)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            hpa = self.clientset.horizontalpodautoscalers.get(name, namespace)
        except NotFoundError:
            return
        try:
            target = self._target_client(hpa).get(hpa.target_name, namespace)
        except (NotFoundError, KeyError):
            return
        selector = target.selector
        pods = [p for p in self.clientset.pods.list(namespace)[0]
                if selector.matches(p.meta.labels)
                and p.status.phase == api.RUNNING]
        current = target.replicas
        # None = metrics MISSING for that pod (metrics client warming up,
        # node down) — distinct from an explicit 0.0 (observed idle).
        # Missing data must never read as "idle": the reference HPA skips
        # the scaling decision when it cannot get metrics.
        samples = [self.metrics(p) for p in pods]
        known = [s for s in samples if s is not None]
        observed = sum(known) / len(known) if known else 0.0

        desired = current
        if known and hpa.target_cpu_utilization > 0:
            ratio = observed / hpa.target_cpu_utilization
            if abs(ratio - 1.0) > TOLERANCE:  # inside the band: no scale
                # scale from the pod count metrics exist for, not
                # spec.replicas (replica_calculator.go uses
                # readyPodCount) — repeated syncs with unchanged metrics
                # then converge instead of compounding; fully idle
                # (ratio 0) clamps to minReplicas
                desired = math.ceil(len(known) * ratio)
        # pods exist but ALL metrics are missing (or target<=0): hold the
        # metric-driven decision as-is — but the reference always bounds
        # desiredReplicas, so the [min,max] clamp is unconditional
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))

        if desired != current:
            def _scale(obj):
                obj.replicas = desired
                return obj

            self._target_client(hpa).guaranteed_update(hpa.target_name, _scale, namespace)

        def _status(cur: HorizontalPodAutoscaler) -> HorizontalPodAutoscaler:
            cur.status_current_replicas = current
            cur.status_desired_replicas = desired
            cur.status_current_utilization = int(observed)
            if desired != current:
                cur.status_last_scale_time = self.clock()
            return cur

        self.clientset.horizontalpodautoscalers.guaranteed_update(name, _status, namespace)
