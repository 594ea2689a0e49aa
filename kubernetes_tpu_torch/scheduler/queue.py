"""Pending-pod FIFO queue + per-pod scheduling backoff.

Capability of the reference's ``podQueue *cache.FIFO``
(``factory/factory.go:75,140``; blocking pop ``getNextPod :782``) and
``util/backoff_utils.go:86 PodBackoff`` (1s initial, 60s max, exponential).

Extra over the reference (the batch seam): ``drain(max_n)`` pops every
currently-pending pod at once — the batch backend schedules the whole
drained batch in one pass instead of one ``pop()`` per iteration.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..api import types as api
from ..client.workqueue import WorkQueue


class PodBackoff:
    def __init__(
        self,
        initial: float = 1.0,
        max_duration: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.initial = initial
        self.max_duration = max_duration
        self._clock = clock
        self._entries: dict[str, tuple[float, float]] = {}  # key -> (backoff, last_update)
        self._mu = threading.Lock()

    def arm(self, pod_key: str) -> float:
        """Consume one backoff step: returns the duration to wait NOW and
        doubles the stored duration for the next failure (reference
        ``getBackoff``).  Call this only when a failure actually
        happened — read-only probes must use :meth:`peek`."""
        with self._mu:
            backoff, _ = self._entries.get(pod_key, (self.initial, 0.0))
            next_backoff = min(backoff * 2, self.max_duration)
            self._entries[pod_key] = (next_backoff, self._clock())
            return backoff

    def peek(self, pod_key: str) -> float:
        """Inspect without arming: the duration the next :meth:`arm`
        would return.  Split from the arming read (ROADMAP open item) so
        a monitoring/diagnostic probe does not double the pod's penalty
        or refresh its GC timestamp."""
        with self._mu:
            return self._entries.get(pod_key, (self.initial, 0.0))[0]

    def get_backoff(self, pod_key: str) -> float:
        """Deprecated spelling of :meth:`arm` — it ADVANCES the backoff.
        Kept for the reference-shaped name; new probes that only want to
        look must call :meth:`peek`."""
        return self.arm(pod_key)

    def forget(self, pod_key: str) -> None:
        with self._mu:
            self._entries.pop(pod_key, None)

    def gc(self, max_age: float = 600.0) -> None:
        with self._mu:
            now = self._clock()
            for k in [k for k, (_, t) in self._entries.items() if now - t > max_age]:
                del self._entries[k]


class SchedulingQueue:
    """FIFO of pending pods, deduped by key, with delayed re-adds.

    A thin pod-object layer over :class:`..client.workqueue.WorkQueue`
    (one blocking/dedup/delay implementation in the package):
    the workqueue carries keys, this class carries the pod objects.  A key
    whose pod was removed may linger in the workqueue; pops skip such
    phantoms, and ``__len__`` counts live pods only."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._wq = WorkQueue(clock=clock)
        self._mu = threading.Lock()
        self._pods: dict[str, api.Pod] = {}
        self._clock = clock

    def add(self, pod: api.Pod) -> None:
        with self._mu:
            self._pods[pod.meta.key] = pod
        self._wq.add(pod.meta.key)

    def add_after(self, pod: api.Pod, delay: float) -> None:
        with self._mu:
            self._pods[pod.meta.key] = pod
        self._wq.add_after(pod.meta.key, delay)

    def update(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.meta.key in self._pods:
                self._pods[pod.meta.key] = pod

    def remove(self, pod_key: str) -> None:
        with self._mu:
            self._pods.pop(pod_key, None)

    def pop(self, timeout: Optional[float] = None) -> Optional[api.Pod]:
        """Blocking FIFO pop (``getNextPod``)."""
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - self._clock())
            key = self._wq.get(timeout=remaining)
            if key is None:
                return None
            self._wq.done(key)
            with self._mu:
                pod = self._pods.pop(key, None)
            if pod is not None:
                return pod
            # phantom (removed while queued): keep draining

    def drain(self, max_n: Optional[int] = None) -> list[api.Pod]:
        """Pop every currently-ready pod in FIFO order — the batch seam.
        One lock round for the keys, one for the pod map (the per-pod
        pop() path costs four lock rounds each; at 150k pods that's the
        difference between microseconds and a second of pure locking)."""
        keys = self._wq.drain_ready(max_n)
        if not keys:
            return []
        out: list[api.Pod] = []
        with self._mu:
            for key in keys:
                pod = self._pods.pop(key, None)
                if pod is not None:  # phantom: removed while queued
                    out.append(pod)
        return out

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until a key is ready, the queue closes, or the timeout
        elapses — without consuming anything.  The batch loop's
        accumulation primitive (a ready key may still be a phantom; the
        loop's drain skips those as usual)."""
        return self._wq.wait_ready(timeout)

    @property
    def closed(self) -> bool:
        return self._wq.is_shutdown()

    def snapshot_pending(self) -> list[api.Pod]:
        """The live pod objects currently known to the queue (ready or
        delayed), without consuming anything — the overlapped-prep path
        warms per-pod memos (signature/content keys) on these while the
        device executes the current wave."""
        with self._mu:
            return list(self._pods.values())

    def __len__(self) -> int:
        # fast path: nothing delayed (the steady-state accumulation loop
        # polls len() every few ms) — every live pod is ready, no key-set
        # materialization needed
        if self._wq.delayed_count() == 0:
            with self._mu:
                return len(self._pods)
        with self._mu:
            live = set(self._pods)
        # live pods that are ready (not still in the delay heap)
        delayed = self._wq.delayed_keys()
        return len([k for k in live if k not in delayed])

    def pending_delayed(self) -> int:
        delayed = self._wq.delayed_keys()
        with self._mu:
            return len([k for k in delayed if k in self._pods])

    def close(self) -> None:
        self._wq.shut_down()
