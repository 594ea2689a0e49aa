"""Shared informer: LIST+WATCH → local cache → handler fan-out.

The reference's list-watch-cache stack (``client-go/tools/cache``:
``reflector.go:239 ListAndWatch``, ``shared_informer.go:182 Run``) in one
component: list to seed the cache at a revision, watch from that
revision, apply each event to the cache, and hand it to every handler.

Two drive modes:

- ``start()`` — a daemon thread consumes the watch;
- ``start_manual()`` + ``pump()`` — the caller drains pending events on
  its own thread (deterministic tests and single-threaded loops).

Objects handed to handlers are shared and must not be mutated.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..store.store import (
    ADDED,
    DELETED,
    MODIFIED,
    WATCH_GAP,
    ExpiredRevisionError,
    WatchEvent,
)
from ..utils.metrics import DEFAULT_CLIENT_METRICS
from .clientset import TypedClient

logger = logging.getLogger("kubernetes_tpu_torch.client.informer")

# LIST→WATCH attempts before a relist gives up: the window can slide past
# the list revision only under extreme write pressure
_MAX_LIST_WATCH_ATTEMPTS = 5


class Handler:
    def __init__(
        self,
        on_add: Optional[Callable] = None,
        on_update: Optional[Callable] = None,
        on_delete: Optional[Callable] = None,
    ):
        self.on_add = on_add or (lambda obj: None)
        self.on_update = on_update or (lambda old, new: None)
        self.on_delete = on_delete or (lambda obj: None)


class SharedInformer:
    def __init__(self, client: TypedClient):
        self._client = client
        self.kind = client.kind
        self._handlers: list[Handler] = []
        self._cache: dict[str, object] = {}  # key -> typed object
        self._mu = threading.RLock()
        self._synced = threading.Event()
        self._watch = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.last_revision = 0
        self.metrics = DEFAULT_CLIENT_METRICS
        # decode_s (typed decode) and apply_s (decode + cache + handlers)
        # are cumulative: the churn harness deltas them per wave
        self.stats = {"relists": 0, "handler_errors": 0, "relist_failures": 0,
                      "decode_errors": 0, "decode_s": 0.0, "apply_s": 0.0}
        # serializes relist(): two callers must not build two watches
        self._relist_mu = threading.Lock()
        # set when a delta was lost (undecodable payload) or a relist
        # failed: pump()/the watch loop relist on their next turn
        self._gap_pending = False

    # -- registration ------------------------------------------------------
    def add_handler(self, handler: Handler) -> None:
        # snapshot under the lock, replay outside it: a handler calling
        # back into get()/list() must not deadlock
        with self._mu:
            self._handlers.append(handler)
            replay = list(self._cache.values()) if self._synced.is_set() else []
        for obj in replay:
            self._deliver(handler.on_add, obj)

    # -- cache reads -------------------------------------------------------
    def get(self, key: str):
        with self._mu:
            return self._cache.get(key)

    def list(self) -> list:
        with self._mu:
            return list(self._cache.values())

    def keys(self) -> list[str]:
        with self._mu:
            return list(self._cache.keys())

    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- lifecycle ---------------------------------------------------------
    def _list_and_watch(self):
        """LIST, then WATCH from the list revision; a window that slid past
        that revision in between (``ExpiredRevisionError``) lists again.
        Returns (objects, revision, watch)."""
        attempts = 0
        while True:
            objs, rev = self._client.list()
            try:
                return objs, rev, self._client.watch(from_revision=rev)
            except ExpiredRevisionError:
                attempts += 1
                if attempts >= _MAX_LIST_WATCH_ATTEMPTS:
                    raise

    def _seed(self) -> None:
        objs, rev, watch = self._list_and_watch()
        with self._mu:
            self._cache = {o.meta.key: o for o in objs}
            self.last_revision = rev
            self._watch = watch
            handlers = list(self._handlers)
            objs_now = list(self._cache.values())
        for h in handlers:
            for o in objs_now:
                self._deliver(h.on_add, o)
        self._synced.set()

    def start(self) -> None:
        """Seed synchronously, then consume the watch on a daemon thread."""
        self._seed()
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name=f"informer-{self.kind}")
        self._thread.start()

    def start_manual(self) -> None:
        """Seed synchronously; the caller drives with pump()."""
        self._seed()

    def stop(self) -> None:
        self._stopped.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run_loop(self) -> None:
        while not self._stopped.is_set():
            if self._gap_pending:
                self._try_relist()  # the 0.2 s get below paces retries
            ev = self._watch.get(timeout=0.2)
            if ev is None:
                continue
            try:
                self._apply(ev)
            except Exception:
                if self._stopped.is_set():
                    return
                # the watch loop is the informer's heartbeat: one bad
                # delta must not end it
                logger.exception("informer %s: failed to apply %s %s",
                                 self.kind, ev.type, ev.key)

    def pump(self) -> int:
        """Apply every pending event on this thread.  A no-op when the
        watch thread owns the stream."""
        if self._thread is not None:
            return 0
        if self._watch is None:
            self._seed()
        if self._gap_pending:
            self._try_relist()
        n = 0
        while True:
            ev = self._watch.get(timeout=0)
            if ev is None:
                break
            self._apply(ev)
            n += 1
        return n

    # -- relist (reflector 410 fallback + resync) --------------------------
    def relist(self) -> None:
        """Full LIST → cache diff → watch restart (``reflector.go``'s "too
        old resource version" fallback, doubling as the resync period).
        Handlers see the diff as ordinary add/update/delete callbacks, so a
        cache gap of any size reconverges in one call.

        The new LIST and watch are built before the old watch is touched,
        so a failure here leaves the informer as it was; ``_try_relist``
        marks the gap for the next turn."""
        with self._relist_mu:
            objs, rev, new_watch = self._list_and_watch()
            new_cache = {o.meta.key: o for o in objs}
            with self._mu:
                old_watch = self._watch
                old_cache = self._cache
                self._cache = new_cache
                self.last_revision = max(self.last_revision, rev)
                self._watch = new_watch
                handlers = list(self._handlers)
                self.stats["relists"] += 1
                self._gap_pending = False
            if old_watch is not None:
                # events the old stream holds past the LIST are replayed by
                # the new watch: dropping its queue loses nothing
                old_watch.stop()
        self.metrics.informer_relists.inc()
        for key, obj in new_cache.items():
            old = old_cache.get(key)
            if old is None:
                for h in handlers:
                    self._deliver(h.on_add, obj)
            elif old.meta.resource_version != obj.meta.resource_version:
                for h in handlers:
                    self._deliver(h.on_update, old, obj)
        for key, old in old_cache.items():
            if key not in new_cache:
                for h in handlers:
                    self._deliver(h.on_delete, old)

    def _try_relist(self) -> bool:
        """Relist, absorbing a failure into ``_gap_pending`` so the next
        turn retries: stale until the store answers, never wedged."""
        try:
            self.relist()
            return True
        except Exception:
            with self._mu:
                self._gap_pending = True
                self.stats["relist_failures"] += 1
            logger.exception("informer %s: relist failed — will retry", self.kind)
            return False

    def _deliver(self, fn, *args) -> None:
        """One handler callback, isolated: a raising handler is counted and
        logged, never allowed to wedge its peers or the watch loop."""
        try:
            fn(*args)
        except Exception:
            with self._mu:
                self.stats["handler_errors"] += 1
            self.metrics.informer_handler_errors.inc()
            logger.exception("informer %s: handler error (isolated)", self.kind)

    # -- delta application -------------------------------------------------
    def _apply(self, ev: WatchEvent) -> None:
        t_apply = time.perf_counter()
        try:
            self._apply_event(ev)
        finally:
            dt = time.perf_counter() - t_apply
            with self._mu:
                self.stats["apply_s"] += dt

    def _apply_event(self, ev: WatchEvent) -> None:
        if ev.type == WATCH_GAP:
            # the transport lost continuity (410 on resume) and ended its
            # stream: no payload to apply; rebuild from a fresh LIST
            self._try_relist()
            return
        if ev.revision <= self.last_revision:
            # a straggler from a watch a relist already superseded
            return
        t_decode = time.perf_counter()
        try:
            obj = self._client._cls.from_dict(ev.object)
        except Exception:
            # the delta is lost, not the watch loop: relist next turn
            with self._mu:
                self.stats["decode_errors"] += 1
                self._gap_pending = True
            self.metrics.informer_decode_errors.inc()
            logger.exception("informer %s: failed to decode %s %s — "
                             "relist scheduled", self.kind, ev.type, ev.key)
            return
        dt = time.perf_counter() - t_decode
        with self._mu:
            self.stats["decode_s"] += dt
            old = self._cache.get(ev.key)
            if ev.type == DELETED:
                self._cache.pop(ev.key, None)
            else:
                self._cache[ev.key] = obj
            self.last_revision = max(self.last_revision, ev.revision)
            handlers = list(self._handlers)
        for h in handlers:
            if ev.type == ADDED:
                self._deliver(h.on_add, obj)
            elif ev.type == MODIFIED:
                self._deliver(h.on_update, old, obj)
            elif ev.type == DELETED:
                self._deliver(h.on_delete, old if old is not None else obj)


class InformerFactory:
    """SharedInformerFactory: one informer per kind per factory."""

    def __init__(self, clientset):
        self._clientset = clientset
        self._informers: dict[str, SharedInformer] = {}
        self._mk_mu = threading.Lock()

    def informer(self, kind: str) -> SharedInformer:
        inf = self._informers.get(kind)  # hit path: lock-free
        if inf is None:
            with self._mk_mu:
                inf = self._informers.get(kind)
                if inf is None:
                    inf = SharedInformer(self._clientset.client_for(kind))
                    self._informers[kind] = inf
        return inf

    def informers(self) -> list[SharedInformer]:
        return list(self._informers.values())

    def start_all(self) -> None:
        for inf in self.informers():
            if not inf.has_synced():
                inf.start()

    def start_all_manual(self) -> None:
        for inf in self.informers():
            if not inf.has_synced():
                inf.start_manual()

    def pump_all(self) -> int:
        return sum(inf.pump() for inf in self.informers())

    def stop_all(self) -> None:
        for inf in self.informers():
            inf.stop()
