"""PLEG — the Pod Lifecycle Event Generator.

Capability of ``pkg/kubelet/pleg/generic.go:181 relist``: instead of the
sync loop polling every pod's runtime state, the PLEG periodically relists
the runtime (sandboxes + container states), diffs against the previous
relist, and emits typed lifecycle events; the kubelet syncs exactly the
pods that changed.  Out-of-band changes — a sandbox killed behind the
kubelet's back — surface as events within one relist period.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
SANDBOX_DIED = "SandboxDied"
POD_SYNC = "PodSync"


@dataclass(frozen=True)
class PodLifecycleEvent:
    pod_key: str
    type: str
    detail: str = ""


class PLEG:
    """Relist-based event source over the hollow runtime + sandboxes.

    ``relist()`` snapshots (sandbox liveness, per-container state/restart
    counts) for every known pod and emits the difference from the
    previous snapshot."""

    def __init__(self, pod_manager, sandboxes=None,
                 relist_period: float = 1.0,
                 clock: Callable[[], float] = None):
        import time

        self.pod_manager = pod_manager
        self.sandboxes = sandboxes
        self.relist_period = relist_period
        self.clock = clock or time.monotonic
        self._last_relist = -1e18
        # pod key -> {"sandbox": bool|None, "containers": {name: (state, restarts)}}
        self._snapshot: dict[str, dict] = {}
        self.stats = {"relists": 0, "events": 0}

    def due(self) -> bool:
        return self.clock() - self._last_relist >= self.relist_period

    def _observe(self) -> dict[str, dict]:
        snap: dict[str, dict] = {}
        for key in self.pod_manager.known():
            containers = {
                name: (st.status.state, st.status.restart_count)
                for name, st in self.pod_manager._pods.get(key, {}).items()
            }
            sandbox: Optional[bool] = None
            if self.sandboxes is not None and key in self.sandboxes.known():
                sandbox = self.sandboxes.exists(key)
            snap[key] = {"sandbox": sandbox, "containers": containers}
        return snap

    def relist(self, force: bool = False) -> list[PodLifecycleEvent]:
        if not force and not self.due():
            return []
        self._last_relist = self.clock()
        self.stats["relists"] += 1
        new = self._observe()
        events: list[PodLifecycleEvent] = []
        for key, cur in new.items():
            old = self._snapshot.get(key)
            if old is None:
                events.append(PodLifecycleEvent(key, POD_SYNC, "first relist"))
                continue
            # the out-of-band case: the sandbox process disappeared while
            # the runtime still believes the pod runs
            if old["sandbox"] is True and cur["sandbox"] is False:
                events.append(PodLifecycleEvent(
                    key, SANDBOX_DIED, "sandbox process gone"))
            for name, (state, restarts) in cur["containers"].items():
                prev = old["containers"].get(name)
                if prev is None:
                    events.append(PodLifecycleEvent(
                        key, CONTAINER_STARTED, name))
                    continue
                prev_state, prev_restarts = prev
                if restarts > prev_restarts:
                    # a restart implies died-then-started
                    events.append(PodLifecycleEvent(key, CONTAINER_DIED, name))
                    events.append(PodLifecycleEvent(
                        key, CONTAINER_STARTED, name))
                elif prev_state == "running" and state != "running":
                    events.append(PodLifecycleEvent(key, CONTAINER_DIED, name))
        for key in self._snapshot.keys() - new.keys():
            events.append(PodLifecycleEvent(key, POD_SYNC, "pod gone"))
        self._snapshot = new
        self.stats["events"] += len(events)
        return events
