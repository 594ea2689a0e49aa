"""Generic controller runtime: informers → workqueue → reconcile.

The shape every reference controller shares (SURVEY.md §2.5, P3; exemplar
``deployment_controller.go:112,147,458``): watch events enqueue object
keys into a rate-limited dedup workqueue; N workers pop keys and run a
level-triggered ``sync(key)`` that reconciles desired vs observed state
through the API only.  Failures requeue with exponential backoff; success
forgets the backoff.

Drive modes mirror the informers: ``run_workers`` (threads, production
shape) or ``sync_once``/``reconcile_all`` (deterministic, for tests and
single-threaded composition)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..client.clientset import Clientset
from ..client.informer import Handler, InformerFactory
from ..client.workqueue import WorkQueue

logger = logging.getLogger("kubernetes_tpu_torch.controllers")


class Controller:
    """Base: subclasses set ``name``, call ``watch(kind, ...)`` in
    ``__init__``, and implement ``sync(key)``."""

    name = "controller"
    max_retries = 15

    def __init__(self, clientset: Clientset, informers: Optional[InformerFactory] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clientset = clientset
        self.informers = informers or InformerFactory(clientset)
        self.queue = WorkQueue(clock=clock)
        self.clock = clock
        self._stopped = threading.Event()
        self._threads: list[threading.Thread] = []
        # syncs run, their seconds and the failed ones (requeued or
        # dropped): the controller manager's stats line reports them
        self._stats_mu = threading.Lock()
        self.sync_stats = {"syncs": 0, "sync_s": 0.0, "errors": 0}

    # -- wiring ------------------------------------------------------------
    def watch(self, kind: str, key_fn: Optional[Callable] = None) -> None:
        """Subscribe to a kind; enqueue key_fn(obj) (default: the object's
        own key) on every add/update/delete."""
        key_fn = key_fn or (lambda obj: obj.meta.key)

        def enqueue(obj):
            key = key_fn(obj)
            if key is not None:
                self.queue.add(key)

        self.informers.informer(kind).add_handler(
            Handler(
                on_add=enqueue,
                on_update=lambda old, new: enqueue(new),
                on_delete=enqueue,
            )
        )

    def informer(self, kind: str):
        return self.informers.informer(kind)

    # -- reconcile ---------------------------------------------------------
    def sync(self, key: str) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _process_one(self, key) -> None:
        t = time.perf_counter()
        failed = True
        try:
            self.sync(key)
            failed = False
        except Exception as e:  # noqa: BLE001 - controller loops never die
            if self.queue.num_requeues(key) < self.max_retries:
                logger.warning("%s: sync %s failed (requeue): %s", self.name, key, e)
                self.queue.add_rate_limited(key)
            else:
                logger.error("%s: sync %s dropped after retries: %s", self.name, key, e)
                self.queue.forget(key)
        else:
            self.queue.forget(key)
        finally:
            self.queue.done(key)
            with self._stats_mu:
                self.sync_stats["syncs"] += 1
                self.sync_stats["sync_s"] += time.perf_counter() - t
                self.sync_stats["errors"] += failed

    def sync_once(self, timeout: float = 0.0) -> bool:
        """Process one queued key synchronously; False if queue empty."""
        key = self.queue.get(timeout=timeout)
        if key is None:
            return False
        self._process_one(key)
        return True

    def reconcile_all(self, max_rounds: int = 50) -> int:
        """Pump informers + drain the queue until quiescent (tests)."""
        total = 0
        for _ in range(max_rounds):
            self.informers.pump_all()
            progressed = 0
            while self.sync_once():
                progressed += 1
            total += progressed
            self.informers.pump_all()
            if len(self.queue) == 0 and progressed == 0:
                break
        return total

    # -- threaded ----------------------------------------------------------
    def run_workers(self, n: int = 1) -> None:
        for _ in range(n):
            t = threading.Thread(target=self._worker_loop, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker_loop(self) -> None:
        while not self._stopped.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            self._process_one(key)

    def stop(self) -> None:
        self._stopped.set()
        self.queue.shut_down()
        for t in self._threads:
            t.join(timeout=5)
