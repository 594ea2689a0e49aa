"""Kubelet volume manager: the desired-vs-actual mount state machine.

Capability of ``pkg/kubelet/volumemanager`` (2,546 LoC;
``reconciler/reconciler.go:165``):

- **desired state of world**: every PVC-backed volume of every pod
  assigned to this node must be mounted before that pod may start
  (``WaitForAttachAndMount`` — the hollow kubelet gates Pending→Running
  on it);
- **actual state of world**: a volume mounts only once the attach/detach
  controller has attached its PV to this node
  (``node.status.volumesAttached``), after a configurable mount latency;
- **volumesInUse**: mounted volumes are reported in node status; the
  attach/detach controller MUST NOT detach a volume still in use — the
  unmount-before-detach safety protocol
  (``attachdetach`` reconciler checking volumesInUse);
- pods leaving the node unmount their volumes, releasing them for
  detach.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api import types as api


@dataclass
class _MountState:
    pv_name: str
    mounting_since: Optional[float] = None  # attach seen; latency running
    mounted: bool = False


class VolumeManager:
    def __init__(self, clock: Callable[[], float], mount_latency: float = 0.0):
        self.clock = clock
        self.mount_latency = mount_latency
        # pod key -> {pv name -> state}
        self._pods: dict[str, dict[str, _MountState]] = {}

    # -- desired state ------------------------------------------------------
    def _required_pvs(self, pod: api.Pod, pvc_to_pv: dict[str, str]):
        """PV names this pod needs mounted; None = some claim is unbound
        (nothing mountable yet, and startup must block)."""
        out = []
        for vol in pod.spec.volumes:
            if vol.pvc_name:
                pv = pvc_to_pv.get(f"{pod.meta.namespace}/{vol.pvc_name}")
                if pv is None:
                    return None
                out.append(pv)
        return out

    def sync(self, pods: list[api.Pod], attached: set[str],
             pvc_to_pv: dict[str, str]) -> None:
        """One reconciler pass (reconciler.go:165): progress mounts for
        present pods, unmount volumes of departed pods."""
        now = self.clock()
        live = set()
        for pod in pods:
            # terminal pods unmount like departed ones (the real kubelet
            # tears down volumes of terminated pods so they can detach)
            if pod.status.phase in (api.SUCCEEDED, api.FAILED):
                continue
            required = self._required_pvs(pod, pvc_to_pv)
            if not required:
                continue  # no volumes (or unbound): no state entry at all
            key = pod.meta.key
            live.add(key)
            states = self._pods.setdefault(key, {})
            for pv in required:
                st = states.get(pv)
                if st is None:
                    st = states[pv] = _MountState(pv_name=pv)
                if st.mounted:
                    continue
                if pv not in attached:
                    st.mounting_since = None  # must wait for the attach
                    continue
                if st.mounting_since is None:
                    st.mounting_since = now
                if now - st.mounting_since >= self.mount_latency:
                    st.mounted = True
        for gone in set(self._pods) - live:
            del self._pods[gone]  # unmount everything of departed pods

    # -- queries ------------------------------------------------------------
    def pod_volumes_ready(self, pod: api.Pod, pvc_to_pv: dict[str, str]) -> bool:
        """WaitForAttachAndMount: True when every required volume is
        mounted (pods without PVC volumes are trivially ready)."""
        required = self._required_pvs(pod, pvc_to_pv)
        if required is None:
            return False  # unbound claim blocks startup
        if not required:
            return True
        states = self._pods.get(pod.meta.key, {})
        return all(states.get(pv) is not None and states[pv].mounted for pv in required)

    def has_state(self) -> bool:
        return bool(self._pods)

    def volumes_in_use(self) -> list[str]:
        out = set()
        for states in self._pods.values():
            for pv, st in states.items():
                if st.mounted:
                    out.add(pv)
        return sorted(out)
