"""Controller manager: the registry/runner for all control loops.

Capability of ``cmd/kube-controller-manager``
(``controllermanager.go:107 Run``, ``:435 StartControllers``, registry at
``:315-339``): construct every enabled controller over ONE shared informer
factory (one watch per kind total — the reference's shared-informer
economy), run them, and expose a deterministic ``reconcile_all`` for
single-threaded drives."""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

logger = logging.getLogger("kubernetes_tpu_torch.controllers.manager")

from ..client.clientset import Clientset
from ..client.informer import InformerFactory
from .base import Controller
from .certificates import CertificateController
from .crdregistrar import CRDRegistrar
from .cronjob import CronJobController
from .daemonset import DaemonSetController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .endpoint import EndpointController
from .garbagecollector import GarbageCollector
from .horizontal import HorizontalPodAutoscalerController
from .ipam import (BootstrapSignerController, NodeIpamController,
    TokenCleanerController)
from .job import JobController
from .namespace import NamespaceController
from .node_lifecycle import NodeLifecycleController
from .podgc import PodGCController
from .replicaset import (ReplicaSetController,
                         ReplicationControllerController)
from .resourcequota import ResourceQuotaController
from .serviceaccounts import ServiceAccountController
from .statefulset import StatefulSetController
from .taint import NoExecuteTaintManager
from .ttl import TTLController
from .volume import AttachDetachController, PersistentVolumeController

# registry of startable loops (reference controllermanager.go:315-339)
DEFAULT_CONTROLLERS: dict[str, Callable] = {
    "deployment": DeploymentController,
    "replicaset": ReplicaSetController,
    "replication": ReplicationControllerController,
    "garbagecollector": GarbageCollector,
    "node-lifecycle": NodeLifecycleController,
    "job": JobController,
    "cronjob": CronJobController,
    "daemonset": DaemonSetController,
    "statefulset": StatefulSetController,
    "endpoint": EndpointController,
    "namespace": NamespaceController,
    "resourcequota": ResourceQuotaController,
    "podgc": PodGCController,
    "ttl": TTLController,
    "disruption": DisruptionController,
    "taint-manager": NoExecuteTaintManager,
    "crd-registrar": CRDRegistrar,
    "persistentvolume": PersistentVolumeController,
    "attachdetach": AttachDetachController,
    "horizontalpodautoscaler": HorizontalPodAutoscalerController,
    "serviceaccount": ServiceAccountController,
    "certificates": CertificateController,
    "node-ipam": NodeIpamController,
    "bootstrapsigner": BootstrapSignerController,
    "tokencleaner": TokenCleanerController,
}


class ControllerManager:
    registry: dict[str, Callable] = DEFAULT_CONTROLLERS

    def __init__(
        self,
        clientset: Clientset,
        enabled: Optional[list[str]] = None,
        clock=None,
        registry: Optional[dict[str, Callable]] = None,
        **controller_kw,
    ):
        import inspect

        registry = registry or type(self).registry
        self.clientset = clientset
        self.informers = InformerFactory(clientset)
        self.controllers: dict[str, Controller] = {}
        # per tick-driven controller: ticks, their seconds, the longest
        self.tick_stats: dict[str, dict] = {}
        kw = dict(controller_kw)
        if clock is not None:
            kw["clock"] = clock
        consumed: set[str] = {"clock"}
        for name in enabled or list(registry):
            ctor = registry[name]
            accepted = set(inspect.signature(ctor.__init__).parameters)
            # pass each controller only the options it declares ("clock" is
            # universal via the Controller base)
            sub_kw = {k: v for k, v in kw.items() if k in accepted or k == "clock"}
            consumed |= set(sub_kw)
            self.controllers[name] = ctor(clientset, informers=self.informers, **sub_kw)
        leftover = set(kw) - consumed
        if leftover:
            raise TypeError(
                f"options {sorted(leftover)} not accepted by any enabled controller "
                f"({sorted(self.controllers)}) — typo or missing controller?"
            )

    def start(self, manual: bool = True, workers_per_controller: int = 1) -> None:
        if manual:
            self.informers.start_all_manual()
        else:
            self.informers.start_all()
            for c in self.controllers.values():
                c.run_workers(workers_per_controller)

    def reconcile_all(self, max_rounds: int = 50) -> int:
        """Drive every controller to quiescence (single-threaded drive)."""
        total = 0
        for _ in range(max_rounds):
            self.informers.pump_all()
            progressed = 0
            for c in self.controllers.values():
                while c.sync_once():
                    progressed += 1
                self.informers.pump_all()
            total += progressed
            if progressed == 0 and all(len(c.queue) == 0 for c in self.controllers.values()):
                break
        return total

    def tick(self) -> None:
        """Drive the clock-based loops (the reference runs these on
        wait.Until timers): node-lifecycle monitor, taint-manager timers,
        cronjob schedule checks."""
        for c in self.controllers.values():
            fn = getattr(c, "monitor", None) or getattr(c, "tick", None)
            if fn is not None:
                t = time.perf_counter()
                try:
                    fn()
                except Exception:  # controller loops never die
                    logger.exception("%s tick failed", c.name)
                dt = time.perf_counter() - t
                st = self.tick_stats.setdefault(c.name, {"ticks": 0, "s": 0.0, "max_s": 0.0})
                st["ticks"] += 1
                st["s"] += dt
                st["max_s"] = max(st["max_s"], dt)

    def stats(self) -> dict:
        """Each controller's syncs, sync seconds, failed syncs and queue
        depth, the tick-driven loops' seconds, and the node lifecycle
        controller's zone states."""
        out = {"controllers": {name: {**c.sync_stats, "queue": len(c.queue)}
                               for name, c in self.controllers.items()},
               "ticks": {k: dict(v) for k, v in self.tick_stats.items()}}
        nlc = self.controllers.get("node-lifecycle")
        if nlc is not None:
            out["zone_states"] = dict(nlc.zone_states)
        return out

    def stop(self) -> None:
        for c in self.controllers.values():
            c.stop()
        self.informers.stop_all()
