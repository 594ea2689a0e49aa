"""Event recording: correlate, aggregate, rate-limit, write asynchronously.

Capability of the reference's ``client-go/tools/record`` stack:

- ``EventBroadcaster`` — emitters never block on the API: events enter a
  bounded in-memory queue consumed by a background writer thread
  (reference: the watch channel + ``StartRecordingToSink``).  When the
  queue is full the newest event is dropped and counted (the reference
  drops on sink backpressure via its rate limiter).
- ``EventCorrelator`` (``tools/record/events_cache.go``) —
  - *aggregation*: more than ``max_similar`` events in the same group
    (source + object + type + reason) inside ``similar_window`` collapse
    into ONE "(combined from similar events)" event whose count rises;
  - *dedup*: an identical event (same message too) bumps ``count`` on the
    stored object via CAS instead of minting a new one;
  - *spam filter*: a token bucket per source+object (``burst`` tokens,
    one refill per ``refill_period``) drops floods outright.

The scheduler's hot batch loop only appends to a deque; all store writes
happen off the timed path, like the reference's async goroutine sink.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..api import types as api

logger = logging.getLogger("kubernetes_tpu_torch.record")


@dataclass
class _PendingEvent:
    involved_kind: str
    involved_key: str  # namespace/name (or bare name for cluster-scoped)
    namespace: str
    etype: str
    reason: str
    # str, or a lazy ("fmt %s", arg, ...) tuple formatted on the SINK
    # thread — the emitting hot loop never pays string interpolation
    message: object
    time: float = 0.0  # emitter-side clock; correlation uses THIS, not
    # drain time, so a backed-up sink doesn't warp windows/buckets


def _fmt(message) -> str:
    return message if isinstance(message, str) else message[0] % tuple(message[1:])


@dataclass
class _PendingBatch:
    """A whole wave's events, unexpanded: the emitting scheduler thread
    enqueues (objects, kind, timestamp) and the SINK thread builds the
    per-event records — at 2k bindings per wave the dataclass
    construction alone is measurable on the timed path, and the sink
    drains concurrently with the next wave's device execution anyway."""

    items: list  # [(obj, etype, reason, message), ...]
    kind: str
    time: float

    def expand(self) -> list[_PendingEvent]:
        kind = self.kind
        now = self.time
        return [
            _PendingEvent(
                involved_kind=getattr(obj, "KIND", kind),
                involved_key=obj.meta.key,
                namespace=obj.meta.namespace,
                etype=etype,
                reason=reason,
                message=message,
                time=now,
            )
            for obj, etype, reason, message in self.items
        ]


def _expand_chunk(chunk: list) -> list[_PendingEvent]:
    out: list[_PendingEvent] = []
    for ev in chunk:
        if isinstance(ev, _PendingBatch):
            out.extend(ev.expand())
        else:
            out.append(ev)
    return out


class _TokenBucket:
    __slots__ = ("tokens", "last")

    def __init__(self, burst: int, now: float):
        self.tokens = float(burst)
        self.last = now

    def take(self, burst: int, refill_period: float, now: float) -> bool:
        if refill_period > 0:
            self.tokens = min(
                float(burst), self.tokens + (now - self.last) / refill_period
            )
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class EventCorrelator:
    """Pure decision logic, shared by sync and async paths.

    ``observe`` returns one of:
    - ``("create", event_dict)`` — mint a new Event object;
    - ``("patch", stored_name, namespace)`` — bump count on a prior event;
    - ``("drop", None, None)`` — spam-filtered.
    """

    def __init__(
        self,
        source: str = "",
        clock: Callable[[], float] = time.monotonic,
        max_similar: int = 10,
        similar_window: float = 600.0,
        burst: int = 25,
        refill_period: float = 300.0 / 25.0,
        cache_size: int = 4096,
    ):
        self.source = source
        self.clock = clock
        self.max_similar = max_similar
        self.similar_window = similar_window
        self.burst = burst
        self.refill_period = refill_period
        self._lock = threading.Lock()
        # spam filter state per source+object (LRU: hits refresh recency)
        self._buckets: collections.OrderedDict[str, _TokenBucket] = collections.OrderedDict()
        # aggregation state per similarity group: [count, window_start]
        self._similar: collections.OrderedDict[tuple, list] = collections.OrderedDict()
        # dedup cache: full event identity -> stored event name
        self._seen: collections.OrderedDict[tuple, str] = collections.OrderedDict()
        self._cache_size = cache_size
        self._name_seq = 0
        self.stats = {"created": 0, "patched": 0, "dropped_spam": 0, "aggregated": 0}

    def _trim(self, od: collections.OrderedDict) -> None:
        while len(od) > self._cache_size:
            od.popitem(last=False)

    def observe(self, ev: _PendingEvent):
        with self._lock:
            return self._observe_locked(ev)

    def observe_many(self, evs: list[_PendingEvent]) -> list:
        """Correlate a whole drained chunk under ONE lock acquisition."""
        with self._lock:
            return [self._observe_locked(ev) for ev in evs]

    def _observe_locked(self, ev: _PendingEvent):
        now = ev.time
        # -- spam filter (EventSourceObjectSpamFilter) ------------------
        bkey = f"{self.source}\x00{ev.involved_key}"
        bucket = self._buckets.get(bkey)
        if bucket is None:
            bucket = self._buckets[bkey] = _TokenBucket(self.burst, now)
            self._trim(self._buckets)
        else:
            self._buckets.move_to_end(bkey)
        if not bucket.take(self.burst, self.refill_period, now):
            self.stats["dropped_spam"] += 1
            return ("drop", None, None)

        # -- aggregation by similarity group ----------------------------
        group = (ev.involved_kind, ev.involved_key, ev.etype, ev.reason)
        rec = self._similar.get(group)
        if rec is None or now - rec[1] > self.similar_window:
            rec = self._similar[group] = [0, now]
            self._trim(self._similar)
        else:
            self._similar.move_to_end(group)
        rec[0] += 1
        aggregated = rec[0] > self.max_similar
        if aggregated:
            self.stats["aggregated"] += 1

        # -- dedup (bump count on an identical prior event) -------------
        # (key on the FORMATTED message so a str emit and a lazy-tuple
        # emit of the same final text dedup together; formatting happens
        # here on the sink thread, never on the emitting hot path)
        message = _fmt(ev.message)
        ident = group if aggregated else group + (message,)
        stored = self._seen.get(ident)
        if stored is not None:
            self._seen.move_to_end(ident)
            self.stats["patched"] += 1
            return ("patch", stored, ev.namespace)
        if aggregated:
            message = f"(combined from similar events): {message}"

        self._name_seq += 1
        _, name = (ev.involved_key.rsplit("/", 1) + [ev.involved_key])[:2] \
            if "/" in ev.involved_key else ("", ev.involved_key)
        stored_name = f"{name}.{self._name_seq:x}"
        self._seen[ident] = stored_name
        self._trim(self._seen)
        self.stats["created"] += 1
        return (
            "create",
            api.Event(
                meta=api.ObjectMeta(name=stored_name, namespace=ev.namespace),
                involved_kind=ev.involved_kind,
                involved_key=ev.involved_key,
                reason=ev.reason,
                message=message,
                type=ev.etype,
                count=1,
            ),
            ev.namespace,
        )


class EventBroadcaster:
    """Bounded queue + background writer (StartRecordingToSink)."""

    def __init__(
        self,
        clientset,
        source: str = "",
        clock: Callable[[], float] = time.monotonic,
        max_queued: int = 1_000_000,
        correlator: Optional[EventCorrelator] = None,
    ):
        self.clientset = clientset
        self.correlator = correlator or EventCorrelator(source=source, clock=clock)
        # entries are _PendingEvent or _PendingBatch; the bound and all
        # accounting (overflow drops, __len__) are in EVENTS — a batch
        # weighs len(items), so the documented memory bound holds no
        # matter how waves are packaged
        self._queue: collections.deque = collections.deque()
        self._queued_events = 0
        self._max_queued = max_queued
        self._cv = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self.dropped_overflow = 0

    # -- emitter side (hot path: append only) ------------------------------
    @staticmethod
    def _weight(ev) -> int:
        return len(ev.items) if isinstance(ev, _PendingBatch) else 1

    def enqueue(self, ev: _PendingEvent) -> None:
        with self._cv:
            if self._queued_events >= self._max_queued:
                self.dropped_overflow += 1
                return
            self._queue.append(ev)
            self._queued_events += 1
            self._cv.notify()

    def enqueue_many(self, evs: list) -> None:
        """Batch append under ONE lock acquisition + ONE sink wake-up — the
        batch scheduler's whole bind wave enqueues without per-event
        synchronization (and without waking the sink mid-timed-section).
        Entries may be unexpanded _PendingBatch items; room and drops are
        accounted in EVENTS (a batch truncates to the remaining room)."""
        with self._cv:
            appended = False
            for ev in evs:
                w = self._weight(ev)
                room = self._max_queued - self._queued_events
                if room <= 0:
                    self.dropped_overflow += w
                    continue
                if w > room:
                    self.dropped_overflow += w - room
                    if isinstance(ev, _PendingBatch):
                        ev = _PendingBatch(items=ev.items[:room],
                                           kind=ev.kind, time=ev.time)
                        w = room
                    else:
                        continue
                self._queue.append(ev)
                self._queued_events += w
                appended = True
            if appended:
                self._cv.notify()

    def recorder(self, involved_kind: str = "Pod") -> "EventRecorder":
        return EventRecorder(self, involved_kind)

    # -- sink side ---------------------------------------------------------
    def _write(self, decision) -> None:
        action, payload, namespace = decision
        try:
            if action == "create":
                # no return decode: the sink never reads the stored copy
                self.clientset.events.create_nowait(payload)
            elif action == "create_many":
                # a whole chunk's creates as ONE store txn
                self.clientset.events.create_many_nowait(payload)
            elif action == "patch":
                def _bump(cur: api.Event) -> api.Event:
                    cur.count += 1
                    return cur

                self.clientset.events.guaranteed_update(payload, _bump, namespace)
        except Exception:  # events are best-effort, like the reference sink
            logger.debug("event write failed", exc_info=True)

    def _write_chunk(self, decisions) -> None:
        """Write one correlated chunk: every "create" decision is folded
        into ONE ``("create_many", [events], None)`` decision — a single
        batch store txn (one lock/WAL/fanout pass) instead of a per-Event
        commit.  "patch" decisions (count bumps on prior events) stay
        per-item CAS loops.  Create order within the chunk is preserved
        (patches target already-stored names, so their relative order to
        creates is immaterial).  Everything still flows through
        ``_write`` — the single best-effort/override seam."""
        creates = [payload for action, payload, _ns in decisions
                   if action == "create"]
        if creates:
            self._write(("create_many", creates, None))
        for decision in decisions:
            if decision[0] != "create":
                self._write(decision)

    def process_one(self) -> bool:
        """Synchronous drain step (tests / manual pumping)."""
        with self._cv:
            if not self._queue:
                return False
            ev = self._queue.popleft()
            self._queued_events -= self._weight(ev)
        for pe in _expand_chunk([ev]):
            self._write(self.correlator.observe(pe))
        return True

    def process_batch(self, max_n: int = 4096) -> int:
        """Pop a chunk, correlate it under one lock, write the decisions."""
        with self._cv:
            if not self._queue:
                return 0
            chunk = [self._queue.popleft()
                     for _ in range(min(max_n, len(self._queue)))]
            self._queued_events -= sum(self._weight(ev) for ev in chunk)
        chunk = _expand_chunk(chunk)
        self._write_chunk(self.correlator.observe_many(chunk))
        return len(chunk)

    def flush(self) -> int:
        n = 0
        while (k := self.process_batch()):
            n += k
        return n

    def start(self) -> None:
        if self._thread is not None:
            if self._thread.is_alive():
                return
            self._thread = None  # stale handle from a timed-out stop()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="event-sink")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(timeout=0.2)
                if self._stopped and not self._queue:
                    return
                chunk = [self._queue.popleft()
                         for _ in range(min(4096, len(self._queue)))]
                self._queued_events -= sum(self._weight(ev) for ev in chunk)
            if chunk:
                self._write_chunk(
                    self.correlator.observe_many(_expand_chunk(chunk)))

    @property
    def running(self) -> bool:
        # a dead thread (e.g. it finished draining after a timed-out
        # stop()) is not a running sink — misreporting True here would
        # suppress callers' manual-drain fallbacks
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        with self._cv:
            self._stopped = True
            if not drain:
                self._queue.clear()
                self._queued_events = 0
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            # a huge backlog can outlive one join timeout; keep waiting for
            # THE THREAD (a concurrent caller-side flush would invert
            # create/patch ordering) — but only up to `timeout`: a sink
            # wedged inside _write must not hang stop() forever
            deadline = time.monotonic() + timeout
            while t.is_alive() and time.monotonic() < deadline:
                t.join(timeout=min(10.0, max(0.1, deadline - time.monotonic())))
                if not drain:
                    break
            if t.is_alive():
                logger.warning(
                    "event sink still draining after %.0fs; leaving the "
                    "thread to finish (%d events queued)", timeout,
                    self._queued_events)
                return  # keep _thread set so start() cannot double-sink
            self._thread = None
        if drain and (t is None or not t.is_alive()):
            self.flush()  # manual mode, or a remainder after thread exit

    def __len__(self) -> int:
        return self._queued_events  # pending EVENTS (batches pre-counted)


class EventRecorder:
    """The per-component emitting facade (reference ``EventRecorder``)."""

    def __init__(self, broadcaster: EventBroadcaster, involved_kind: str = "Pod"):
        self.broadcaster = broadcaster
        self.involved_kind = involved_kind

    def event(self, obj, etype: str, reason: str, message) -> None:
        meta = getattr(obj, "meta", None)
        key = meta.key if meta is not None else str(obj)
        namespace = meta.namespace if meta is not None else "default"
        self.broadcaster.enqueue(
            _PendingEvent(
                involved_kind=getattr(obj, "KIND", self.involved_kind),
                involved_key=key,
                namespace=namespace,
                etype=etype,
                reason=reason,
                message=message,
                time=self.broadcaster.correlator.clock(),
            )
        )

    def event_batch(self, items) -> None:
        """items: iterable of (obj, etype, reason, message) — message may be
        a lazy ("fmt %s", arg) tuple.  One timestamp, one lock, one wake —
        and ZERO per-event construction on the emitting thread: the batch
        rides the queue unexpanded (_PendingBatch) and the sink builds the
        records while the next wave owns the hot path."""
        items = list(items)
        if not items:
            return
        self.broadcaster.enqueue_many([_PendingBatch(
            items=items,
            kind=self.involved_kind,
            time=self.broadcaster.correlator.clock(),
        )])
