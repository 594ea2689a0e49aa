"""Node resource management: the cgroup hierarchy + image GC analogues.

Two reference kubelet subsystems:

- **ContainerManager** (``pkg/kubelet/cm/container_manager_linux.go``,
  ``qos_container_manager_linux.go``): a node-allocatable cgroup tree —
  root → kubepods → {guaranteed at top level, burstable, besteffort} →
  pod — with the reference's accounting rules: allocatable = capacity −
  system-reserved − kube-reserved; per-pod cpu shares =
  max(2, milliCPU × 1024 / 1000) (``helpers_linux.go MilliCPUToShares``);
  Guaranteed pods parent directly under kubepods, Burstable/BestEffort
  under their QoS cgroup whose cpu shares are the live sum of member
  requests (``qos_container_manager_linux.go setCPUCgroupConfig``).
  Admission debits requests against allocatable — a pod that does not
  fit is REJECTED at the node (the kubelet's OutOf<resource> path),
  independent of what the scheduler thought.  Observed usage is charged
  into the pod cgroup and rolls up the tree, so memory pressure is an
  ACCOUNTED signal (root usage vs threshold), not a scripted one.

- **ImageManager** (``pkg/kubelet/images/image_gc_manager.go``): images
  pull on first reference with deterministic pseudo-sizes, are
  ref-counted by running pods, age while unreferenced, and are LRU
  garbage-collected when disk usage crosses ``high_threshold`` down to
  ``low_threshold``; failure to reach it raises the disk-pressure signal
  the eviction manager consumes.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api import types as api
from .runtime import QOS_BEST_EFFORT, QOS_BURSTABLE, QOS_GUARANTEED, pod_qos_class


def milli_cpu_to_shares(milli: int) -> int:
    """helpers_linux.go MilliCPUToShares (min 2, the kernel floor)."""
    return max(2, milli * 1024 // 1000)


def _pod_requests(pod: api.Pod) -> tuple[int, int]:
    """(milliCPU, memory bytes) summed over containers."""
    cpu = mem = 0
    for c in pod.spec.containers:
        r = c.resources.requests
        q = r.get("cpu")
        if q is not None:
            cpu += int(api.Quantity(str(q)).milli_value())
        q = r.get("memory")
        if q is not None:
            mem += int(api.Quantity(str(q)).value())
    return cpu, mem


@dataclass
class Cgroup:
    """One node in the hierarchy: configured shares/limits + live charges."""

    name: str
    cpu_shares: int = 2
    memory_limit: Optional[int] = None  # None = unlimited
    memory_usage: int = 0  # charged (observed) bytes, rolled up by parent
    children: dict[str, "Cgroup"] = field(default_factory=dict)

    def usage(self) -> int:
        return self.memory_usage + sum(c.usage() for c in self.children.values())


class AdmissionRejected(Exception):
    """The node cannot host the pod (OutOfcpu / OutOfmemory / OutOfpods)."""

    def __init__(self, resource: str, message: str):
        self.resource = resource
        super().__init__(message)


class ContainerManager:
    """The node's resource ledger + cgroup tree."""

    def __init__(self, cpu: str, memory: str, max_pods: int,
                 system_reserved_cpu: str = "0",
                 system_reserved_memory: str = "0",
                 kube_reserved_cpu: str = "0",
                 kube_reserved_memory: str = "0"):
        self.capacity_cpu = int(api.Quantity(cpu).milli_value())
        self.capacity_memory = int(api.Quantity(memory).value())
        self.max_pods = max_pods
        reserved_cpu = (int(api.Quantity(system_reserved_cpu).milli_value())
                        + int(api.Quantity(kube_reserved_cpu).milli_value()))
        reserved_mem = (int(api.Quantity(system_reserved_memory).value())
                        + int(api.Quantity(kube_reserved_memory).value()))
        # NodeAllocatable (container_manager_linux.go GetNodeAllocatable)
        self.allocatable_cpu = max(0, self.capacity_cpu - reserved_cpu)
        self.allocatable_memory = max(0, self.capacity_memory - reserved_mem)
        # the tree: kubepods → {burstable, besteffort} (+ guaranteed pods
        # directly under kubepods, like the reference layout)
        self.root = Cgroup("kubepods",
                           cpu_shares=milli_cpu_to_shares(self.allocatable_cpu),
                           memory_limit=self.allocatable_memory)
        self.root.children["burstable"] = Cgroup("kubepods/burstable")
        self.root.children["besteffort"] = Cgroup("kubepods/besteffort",
                                                  cpu_shares=2)
        # pod ledger: key -> (qos, milliCPU, memory)
        self._pods: dict[str, tuple[str, int, int]] = {}
        self.reserved_cpu = 0
        self.reserved_memory = 0

    # -- admission (kubelet canAdmitPod over allocatable) -------------------
    def admit(self, pod: api.Pod) -> None:
        """Raises AdmissionRejected when requests exceed what's left of
        node allocatable — the node-side backstop behind the scheduler."""
        if pod.meta.key in self._pods:
            return
        cpu, mem = _pod_requests(pod)
        if len(self._pods) + 1 > self.max_pods:
            raise AdmissionRejected("pods", f"node holds {len(self._pods)} pods, max {self.max_pods}")
        if self.reserved_cpu + cpu > self.allocatable_cpu:
            raise AdmissionRejected(
                "cpu", f"requested {cpu}m, {self.allocatable_cpu - self.reserved_cpu}m allocatable left")
        if self.reserved_memory + mem > self.allocatable_memory:
            raise AdmissionRejected(
                "memory", f"requested {mem}B, {self.allocatable_memory - self.reserved_memory}B allocatable left")

    def add_pod(self, pod: api.Pod, force: bool = False) -> Cgroup:
        """Create the pod cgroup in its QoS parent and debit the ledger.
        ``force`` skips admission — for pods observed ALREADY running
        (kubelet restart recovery), which are never re-admitted."""
        key = pod.meta.key
        if key in self._pods:
            return self._find_pod_cgroup(key)
        if not force:
            self.admit(pod)
        qos = pod_qos_class(pod)
        cpu, mem = _pod_requests(pod)
        cg = Cgroup(f"pod{pod.meta.uid or key}",
                    cpu_shares=milli_cpu_to_shares(cpu),
                    # Guaranteed pods are limited to their (== request)
                    # bound; others inherit the parent bound
                    memory_limit=mem if qos == QOS_GUARANTEED and mem else None)
        parent = self._qos_parent(qos)
        parent.children[key] = cg
        self._pods[key] = (qos, cpu, mem)
        self.reserved_cpu += cpu
        self.reserved_memory += mem
        self._recompute_qos_shares()
        return cg

    def remove_pod(self, pod_key: str) -> None:
        rec = self._pods.pop(pod_key, None)
        if rec is None:
            return
        qos, cpu, mem = rec
        self._qos_parent(qos).children.pop(pod_key, None)
        self.reserved_cpu -= cpu
        self.reserved_memory -= mem
        self._recompute_qos_shares()

    def known(self) -> set[str]:
        return set(self._pods)

    def _qos_parent(self, qos: str) -> Cgroup:
        if qos == QOS_GUARANTEED:
            return self.root
        return self.root.children[
            "burstable" if qos == QOS_BURSTABLE else "besteffort"]

    def _find_pod_cgroup(self, key: str) -> Optional[Cgroup]:
        qos, _, _ = self._pods[key]
        return self._qos_parent(qos).children.get(key)

    def _recompute_qos_shares(self) -> None:
        """setCPUCgroupConfig: burstable shares track the live sum of
        member requests; besteffort stays at the kernel floor."""
        total = sum(cpu for qos, cpu, _ in self._pods.values()
                    if qos == QOS_BURSTABLE)
        self.root.children["burstable"].cpu_shares = milli_cpu_to_shares(total)

    # -- usage accounting (the cadvisor feed) ------------------------------
    def charge_usage(self, usage_by_pod: dict[str, int]) -> None:
        """Write observed per-pod memory into each pod cgroup (absolute,
        not incremental — mirrors a stats sample)."""
        for key in self._pods:
            cg = self._find_pod_cgroup(key)
            if cg is not None:
                cg.memory_usage = usage_by_pod.get(key, 0)

    def node_usage(self) -> int:
        """Accounted memory use: the root rollup."""
        return self.root.usage()

    def qos_usage(self, qos: str) -> int:
        if qos == QOS_GUARANTEED:
            return sum(c.usage() for k, c in self.root.children.items()
                       if k not in ("burstable", "besteffort"))
        return self._qos_parent(qos).usage()


# -- image GC ----------------------------------------------------------------

@dataclass
class _Image:
    name: str
    size: int
    refs: int = 0
    last_used: float = 0.0
    first_detected: float = 0.0


class ImageManager:
    """Pull bookkeeping + LRU garbage collection over a disk budget."""

    def __init__(self, disk_capacity: int = 100 << 30,
                 high_threshold: float = 0.85, low_threshold: float = 0.80,
                 min_age: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.disk_capacity = disk_capacity
        self.high_threshold = high_threshold
        self.low_threshold = low_threshold
        self.min_age = min_age
        self.clock = clock
        self._images: dict[str, _Image] = {}
        # pod key -> image names it references
        self._pod_images: dict[str, set[str]] = {}
        self.stats = {"pulled": 0, "removed": 0, "reclaimed_bytes": 0}

    @staticmethod
    def image_size(name: str) -> int:
        """Deterministic pseudo-size (64–576 MiB) — the fake-runtime
        stand-in for a registry manifest size."""
        return (64 + (zlib.crc32(name.encode()) % 512)) << 20

    def disk_used(self) -> int:
        return sum(im.size for im in self._images.values())

    def ensure_pulled(self, pod: api.Pod) -> list[str]:
        """Pull every container image the pod references (no-op when
        present) and take refs.  Returns newly pulled names."""
        now = self.clock()
        key = pod.meta.key
        wanted = {c.image or f"img-{c.name}" for c in pod.spec.containers}
        pulled = []
        for name in wanted:
            im = self._images.get(name)
            if im is None:
                im = self._images[name] = _Image(
                    name=name, size=self.image_size(name),
                    first_detected=now)
                self.stats["pulled"] += 1
                pulled.append(name)
            im.last_used = now
        prev = self._pod_images.get(key, set())
        for name in wanted - prev:
            self._images[name].refs += 1
        self._pod_images[key] = wanted
        return pulled

    def release(self, pod_key: str) -> None:
        now = self.clock()
        for name in self._pod_images.pop(pod_key, set()):
            im = self._images.get(name)
            if im is not None:
                im.refs = max(0, im.refs - 1)
                im.last_used = now

    def garbage_collect(self) -> dict:
        """image_gc_manager.go GarbageCollect: over ``high_threshold`` →
        free LRU unreferenced images (older than min_age) until under
        ``low_threshold``.  Returns {freed, used, over} — ``over`` True
        means even a full sweep could not reach the target (the caller
        raises disk pressure)."""
        used = self.disk_used()
        high = int(self.disk_capacity * self.high_threshold)
        if used <= high:
            return {"freed": 0, "used": used, "over": False}
        target = int(self.disk_capacity * self.low_threshold)
        now = self.clock()
        candidates = sorted(
            (im for im in self._images.values()
             if im.refs == 0 and now - im.first_detected >= self.min_age),
            key=lambda im: im.last_used)
        freed = 0
        for im in candidates:
            if used - freed <= target:
                break
            del self._images[im.name]
            freed += im.size
            self.stats["removed"] += 1
        self.stats["reclaimed_bytes"] += freed
        used -= freed
        return {"freed": freed, "used": used, "over": used > target}

    def images(self) -> list[str]:
        return sorted(self._images)
