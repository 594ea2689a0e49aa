"""Rate-limited, deduplicating work queues.

Capability of ``client-go/util/workqueue``: items (keys) are deduped while
queued, in-flight items that are re-added are re-queued on done(), and
failures get per-item exponential backoff (``default_rate_limiters.go``).
This is the spine of every controller (SURVEY.md P3).

The delay machinery is virtual-time-friendly: pass a ``clock`` callable for
deterministic tests (the reference injects ``util/clock`` the same way).
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Callable, Hashable, Optional


class ExponentialBackoff:
    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: dict[Hashable, int] = {}
        self._mu = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._mu:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        return min(self.base_delay * (2**n), self.max_delay)

    def forget(self, item: Hashable) -> None:
        with self._mu:
            self._failures.pop(item, None)

    def retries(self, item: Hashable) -> int:
        with self._mu:
            return self._failures.get(item, 0)


class WorkQueue:
    """Dedup queue with the add/get/done discipline of ``workqueue.Type``."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._cond = threading.Condition()
        self._queue: deque[Hashable] = deque()
        self._dirty: set[Hashable] = set()
        self._processing: set[Hashable] = set()
        self._shutdown = False
        self._clock = clock
        # delayed adds: heap of (ready_time, seq, item)
        self._delayed: list[tuple[float, int, Hashable]] = []
        self._seq = 0
        self.rate_limiter = ExponentialBackoff()

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # re-queued by done()
            self._queue.append(item)
            self._cond.notify()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (self._clock() + delay, self._seq, item))
            self._cond.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self.rate_limiter.retries(item)

    def _drain_delayed_locked(self) -> Optional[float]:
        """Move ready delayed items into the queue; return wait time to the
        next delayed item, if any."""
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item not in self._dirty:
                self._dirty.add(item)
                if item not in self._processing:
                    self._queue.append(item)
        if self._delayed:
            return max(0.0, self._delayed[0][0] - now)
        return None

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Blocking pop; returns None on shutdown or timeout."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                next_delay = self._drain_delayed_locked()
                if self._queue:
                    item = self._queue.popleft()
                    self._processing.add(item)
                    self._dirty.discard(item)
                    return item
                if self._shutdown:
                    return None
                wait = next_delay
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def try_get(self) -> Optional[Hashable]:
        return self.get(timeout=0)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until at least one item is ready (without popping it),
        the queue shuts down, or the timeout elapses.  Returns whether an
        item is ready — the batch loop's accumulation wait: peek-and-wait
        instead of pop-and-requeue, so FIFO order is untouched."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                next_delay = self._drain_delayed_locked()
                if self._queue:
                    return True
                if self._shutdown:
                    return False
                wait = next_delay
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return False
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def drain_ready(self, max_n: Optional[int] = None) -> list:
        """Pop every currently-ready item under ONE lock acquisition (the
        batch scheduler's seam: item-at-a-time get/done costs two lock
        rounds per pod — 300k rounds per 150k-pod drain).  Items are
        returned already marked done (the caller owns the whole batch; a
        re-add during the batch re-queues normally via the dirty set)."""
        out: list = []
        with self._cond:
            self._drain_delayed_locked()
            while self._queue and (max_n is None or len(out) < max_n):
                item = self._queue.popleft()
                self._dirty.discard(item)
                out.append(item)
        return out

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def __len__(self) -> int:
        with self._cond:
            self._drain_delayed_locked()
            return len(self._queue)

    def pending_delayed(self) -> int:
        with self._cond:
            return len(self._delayed)

    def delayed_count(self) -> int:
        """Number of items still waiting in the delay heap AFTER moving
        ready ones into the queue — unlike :meth:`pending_delayed`, an
        item whose deadline passed is not counted.  O(ready-moves), no
        set materialization: the batch loop's accumulation window polls
        queue length every few ms, and building ``delayed_keys()``'s set
        per poll was pure overhead in the (typical) empty-heap case."""
        with self._cond:
            self._drain_delayed_locked()
            return len(self._delayed)

    def delayed_keys(self) -> set:
        """Items currently waiting in the delay heap (not yet ready)."""
        with self._cond:
            self._drain_delayed_locked()
            return {item for _, _, item in self._delayed}

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def is_shutdown(self) -> bool:
        with self._cond:
            return self._shutdown
