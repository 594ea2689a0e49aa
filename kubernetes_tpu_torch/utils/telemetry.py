"""Off-box telemetry shipper: flight dumps and time-series deltas leave
the process.

A bounded-queue background thread ships JSON records — flight-recorder
dumps (offered by ``Tracer.dump``) and per-scrape time-series deltas
(offered by the scraper's telemetry observer) — as JSON-lines to a
:class:`FileSink` or an HTTP collector (:class:`HTTPSink`; the apiserver's
``/telemetry`` route is one).

Failure posture, in order of importance:

1. **A dead collector must never stall a wave.**  Producers only ever
   :meth:`TelemetryShipper.offer` — append to a bounded queue under a
   queue lock, drop-and-count on overflow.  No producer ever blocks on
   the network.
2. Ship attempts retry with exponential backoff using the same
   classification the remote client uses: transport errors and 5xx/429
   are retryable, other 4xx are fatal (a collector rejecting the payload
   will reject the retry too).
3. A batch that exhausts its retries (or classifies fatal) degrades to
   the local ``dead`` ring — bounded, inspectable, counted.  The
   in-process flight recorder still holds every dump regardless; losing
   the *shipment* loses a copy, never the data.

``telemetry.ship`` is a registered fault point: collector down mid-churn
→ local ring intact, drop counters visible, convergence unaffected.

Non-goals: no OTLP/Jaeger wire format —
the payload is the recorder's own JSON, one object per line — and no
sampling; the queue bound plus the scrape cadence are the backpressure.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Optional

from .. import faults
from . import tracing
from .metrics import Counter, Registry

# -- the global switch (one load + None check at every producer site) ------
_ACTIVE: Optional["TelemetryShipper"] = None


def current() -> Optional["TelemetryShipper"]:
    """The active shipper, or None (disabled)."""
    return _ACTIVE


def enable(sink, registry: Optional[Registry] = None,
           start_thread: bool = True, **kwargs) -> "TelemetryShipper":
    """Install a process-wide shipper over ``sink`` and return it."""
    global _ACTIVE
    disable()
    shipper = TelemetryShipper(sink, registry=registry, **kwargs)
    if start_thread:
        shipper.start()
    _ACTIVE = shipper
    return shipper


def disable() -> Optional["TelemetryShipper"]:
    """Uninstall the active shipper; drains what it can, then stops."""
    global _ACTIVE
    shipper = _ACTIVE
    _ACTIVE = None
    if shipper is not None:
        shipper.stop()
    return shipper


class FileSink:
    """JSON-lines append to a local file — the zero-dependency collector
    (bench artifacts, air-gapped runs).  Called only from the shipper's
    worker thread, so no lock."""

    def __init__(self, path: str):
        self.path = path

    def ship(self, records: list[dict]) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")


class HTTPSink:
    """POST JSON-lines to a collector URL (the apiserver's ``/telemetry``
    ingest, or anything that accepts ndjson).  Raises on non-2xx — the
    shipper owns retry/backoff and classification."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url
        self.timeout = timeout

    def ship(self, records: list[dict]) -> None:
        body = "".join(json.dumps(r, default=str) + "\n"
                       for r in records).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/x-ndjson"})
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass


def _retryable(exc: BaseException) -> bool:
    """The remote client's classification, applied to shipping: HTTP 4xx
    (except 429) is fatal — the collector will reject the retry too;
    transport errors, 5xx, and 429 are worth the backoff.  An injected
    ``FaultInjected`` models a transport failure (retryable)."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500 or exc.code == 429
    return True


class TelemetryShipper:
    """Bounded-queue background shipper.

    Producers call :meth:`offer` (never blocks, never raises); the
    worker thread drains batches through the sink with retry + backoff.
    ``start_thread=False`` mode (tests, synchronous benches) drains via
    explicit :meth:`drain_all` calls."""

    def __init__(self, sink, queue_max: int = 1024, batch_max: int = 64,
                 dead_max: int = 256, retries: int = 3,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 flush_interval_s: float = 0.5,
                 sleep=time.sleep, registry: Optional[Registry] = None):
        self.sink = sink
        self.queue_max = queue_max
        self.batch_max = batch_max
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.flush_interval_s = flush_interval_s
        self.sleep = sleep
        self._mu = threading.Lock()
        self._queue: deque = deque()
        #: the local degrade ring: batches that exhausted their retries
        self.dead: deque = deque(maxlen=dead_max)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters are real metrics so a daemon's own scrape loop sees
        # its shipper's health (register into the daemon registry when
        # given; standalone Counter objects otherwise)
        self.shipped = Counter(
            "telemetry_shipped_total", "records delivered to the sink")
        self.overflow = Counter(
            "telemetry_overflow_total",
            "records dropped at offer() because the queue was full")
        self.dead_lettered = Counter(
            "telemetry_dead_lettered_total",
            "records that exhausted ship retries and degraded to the "
            "local dead ring")
        self.ship_retries = Counter(
            "telemetry_ship_retries_total",
            "ship attempts re-issued after a retryable failure")
        self.feedback_dropped = Counter(
            "telemetry_feedback_dropped_total",
            "records refused because they were produced from inside a "
            "ship attempt (instrumentation of the shipper itself — "
            "accepting them would feed the queue it is draining)")
        # per-thread re-entrancy guard: a ship failure fires the fault/
        # trace instrumentation, which may take a flight dump, whose
        # ship hook would offer a NEW record — an unbounded feedback
        # loop keeping drain_all spinning forever.  Anything offered
        # while the same thread is inside _ship_batch is that loop.
        self._shipping = threading.local()
        if registry is not None:
            for c in (self.shipped, self.overflow, self.dead_lettered,
                      self.ship_retries, self.feedback_dropped):
                registry.register(c)

    # -- producer side (hot-adjacent: must never block or raise) -----------
    def offer(self, record: dict) -> bool:
        """Enqueue one record; drop-and-count when the queue is full.
        The overflow counter increments outside the queue lock (Counter
        carries its own) — no nested lock orders here."""
        if getattr(self._shipping, "active", False):
            self.feedback_dropped.inc()
            return False
        with self._mu:
            if len(self._queue) < self.queue_max:
                self._queue.append(record)
                self._wake.set()
                return True
        self.overflow.inc()
        return False

    def pending(self) -> int:
        with self._mu:
            return len(self._queue)

    def stats(self) -> dict:
        """The drop/overflow visibility contract of the fault matrix."""
        with self._mu:
            queued = len(self._queue)
            dead = len(self.dead)
        return {
            "queued": queued,
            "dead": dead,
            "shipped": self.shipped.value,
            "overflow": self.overflow.value,
            "dead_lettered": self.dead_lettered.value,
            "ship_retries": self.ship_retries.value,
            "feedback_dropped": self.feedback_dropped.value,
        }

    # -- consumer side (worker thread, or explicit drains in tests) --------
    def _pop_batch(self) -> list[dict]:
        with self._mu:
            batch = []
            while self._queue and len(batch) < self.batch_max:
                batch.append(self._queue.popleft())
            return batch

    def _ship_batch(self, batch: list[dict]) -> bool:
        """One batch through the sink with retry + backoff.  Returns
        False when the batch degraded to the dead ring.  Runs with NO
        shipper lock held — a slow sink must not block offer()."""
        attempt = 0
        backoff = self.backoff_s
        self._shipping.active = True
        try:
            while True:
                try:
                    faults.hit("telemetry.ship", records=len(batch),
                               attempt=attempt)
                    self.sink.ship(batch)
                    self.shipped.inc(len(batch))
                    return True
                except Exception as e:  # noqa: BLE001 - classified below
                    if not _retryable(e) or attempt >= self.retries:
                        with self._mu:  # stats() reads len(dead) under _mu
                            self.dead.extend(batch)
                        self.dead_lettered.inc(len(batch))
                        tr = tracing.current()
                        if tr is not None:
                            tr.instant("telemetry.ship_failed",
                                       records=len(batch), error=str(e),
                                       attempts=attempt + 1)
                        return False
                    attempt += 1
                    self.ship_retries.inc()
                    self.sleep(backoff)
                    backoff = min(backoff * 2, self.backoff_max_s)
        finally:
            self._shipping.active = False

    def drain_all(self) -> int:
        """Ship until the queue is empty; returns records delivered."""
        delivered = 0
        while True:
            batch = self._pop_batch()
            if not batch:
                return delivered
            if self._ship_batch(batch):
                delivered += len(batch)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="ktpu-torch-telemetry-shipper", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            try:
                self.drain_all()
            except Exception:  # noqa: BLE001 - shipping must never crash
                import logging

                logging.getLogger("kubernetes_tpu_torch.telemetry").exception(
                    "telemetry drain failed (worker keeps running)")
        self.drain_all()  # final drain on stop

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        else:
            self.drain_all()  # threadless mode still flushes on stop


def timeseries_observer(shipper: "TelemetryShipper"):
    """A scrape observer that offers each scrape's delta batch to the
    shipper — wire with ``store.add_observer(timeseries_observer(shp))``
    (``utils/health.py`` does this for daemons)."""

    def _observe(samples: list) -> None:
        if samples:
            shipper.offer({"kind": "timeseries",
                           "samples": [list(s) for s in samples]})

    return _observe
