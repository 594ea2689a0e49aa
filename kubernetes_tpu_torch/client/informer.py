"""Shared informer: LIST+WATCH → local cache → handler fan-out.

The reference's list-watch-cache stack (``client-go/tools/cache``:
``reflector.go:239 ListAndWatch``, ``shared_informer.go:182 Run``) in one
component: list to seed the cache at a revision, watch from that
revision, apply each event to the cache, and hand it to every handler.

Two drive modes:

- ``start()`` — a daemon thread consumes the watch;
- ``start_manual()`` + ``pump()`` — the caller drains pending events on
  its own thread (deterministic tests and single-threaded loops).

Objects handed to handlers are shared and must not be mutated.  With
``mutation_detector=True`` the informer snapshots each object's wire form
and raises ``CacheMutationError`` when a cached object no longer matches
it (the reference's ``KUBE_CACHE_MUTATION_DETECTOR``,
``tools/cache/mutation_detector.go``).

Ingest: while ``api.lazy.ENABLED`` holds, the informer LISTs through the
store's column batch (``list_columns``) or lazy views (``list_lazy``) and
wraps every watch payload in a lazy view instead of decoding it; it
watches with ``frames=True``, so a ``create_many``/``bind_many`` txn
arrives as one ``WatchFrame`` applied under one lock hold and handed to
batch-aware handlers (``Handler.on_batch``) in one call.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .. import faults
from ..api import lazy as lazy_mod
from ..store.frames import FRAME, WatchFrame
from ..store.store import (
    ADDED,
    DELETED,
    MODIFIED,
    WATCH_GAP,
    ExpiredRevisionError,
    WatchEvent,
)
from ..utils import tracing
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
        on_batch: Optional[Callable] = None,
    ):
        self.on_add = on_add or (lambda obj: None)
        self.on_update = on_update or (lambda old, new: None)
        self.on_delete = on_delete or (lambda obj: None)
        # a batch-aware handler receives a whole watch frame in one call:
        # ``on_batch(frame, deltas)``, deltas = [(type, old, new, i)] (i
        # indexes the frame's columns; fenced events are absent).  Without
        # it a handler gets the per-event callbacks for a framed event.
        self.on_batch = on_batch


class SharedInformer:
    def __init__(self, client: TypedClient, mutation_detector: bool = False,
                 compact_on_resync: bool = False):
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
        # the detector's snapshots: key -> the object's to_dict() as cached
        # (read through the typed fields, so a lazy view's snapshot is what
        # its typed twin gives)
        self._mutation_detector = mutation_detector
        self._snapshots: dict[str, dict] = {}
        # every successful relist ends with a promote-and-drop-raw sweep
        self.compact_on_resync = compact_on_resync
        self.metrics = DEFAULT_CLIENT_METRICS
        # cumulative, deltaed per wave by the churn harness: decode_s
        # (wrap or typed decode) and apply_s (decode + cache + handlers);
        # frames applied, the events they carried, frames lost whole
        # (-> gap), objects compacted (promote-and-drop-raw), and the
        # events applied one at a time (outside frames)
        self.stats = {"relists": 0, "handler_errors": 0, "relist_failures": 0,
                      "decode_errors": 0, "decode_s": 0.0, "dropped_events": 0,
                      "apply_s": 0.0, "frames": 0, "frame_events": 0,
                      "batch_errors": 0, "compactions": 0, "events": 0}
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
    def _list(self):
        """LIST through the cheapest path: the store's column batch (raw
        views and identity columns), else lazy views, else the eager typed
        decode (lazy decode off).  Returns (objects, revision, keys or
        None): a column batch's keys spare seeding the meta decode."""
        if lazy_mod.ENABLED:
            batch = self._client.list_columns()
            if batch is not None:
                return batch.objects(), batch.revision, batch.keys
            objs, rev = self._client.list_lazy()
            return objs, rev, None
        objs, rev = self._client.list()
        return objs, rev, None

    def _watch_from(self, rev: int):
        """The watch from ``rev``, framed (the informer is frame-aware)."""
        return self._client.watch(from_revision=rev, frames=True)

    def _list_and_watch(self):
        """LIST, then WATCH from the list revision; a window that slid past
        that revision in between (``ExpiredRevisionError``) lists again.
        Returns (cache dict, revision, watch)."""
        attempts = 0
        while True:
            objs, rev, keys = self._list()
            try:
                watch = self._watch_from(rev)
            except ExpiredRevisionError:
                attempts += 1
                if attempts >= _MAX_LIST_WATCH_ATTEMPTS:
                    raise
                continue
            cache = dict(zip(keys, objs)) if keys is not None else {o.meta.key: o for o in objs}
            return cache, rev, watch

    def _seed(self) -> None:
        cache, rev, watch = self._list_and_watch()
        with self._mu:
            self._cache = cache
            self._snapshot_all()
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
            except CacheMutationError:
                raise  # the detector's whole point is to fail loudly
            except Exception:
                if self._stopped.is_set():
                    return
                # the watch loop is the informer's heartbeat: one bad
                # delta must not end it
                logger.exception("informer %s: failed to apply %s %s",
                                 self.kind, ev.type, getattr(ev, "key", ""))

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
            # a frame counts for the events it carried
            n += len(ev) if ev.type == FRAME else 1
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
        tr = tracing.current()
        with (tr.span("informer.relist", cat="ingest", kind=self.kind)
              if tr is not None else tracing.NULL_SPAN):
            self._relist_inner()
        if self.compact_on_resync:
            self.compact_cache()

    def _relist_inner(self) -> None:
        with self._relist_mu:
            new_cache, rev, new_watch = self._list_and_watch()
            with self._mu:
                old_watch = self._watch
                old_cache = self._cache
                self._cache = new_cache
                self._snapshot_all()
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
            elif lazy_mod.resource_version_of(old) != lazy_mod.resource_version_of(obj):
                # raw-aware: a resync diff decodes no object's meta
                for h in handlers:
                    self._deliver(h.on_update, old, obj)
        for key, old in old_cache.items():
            if key not in new_cache:
                for h in handlers:
                    self._deliver(h.on_delete, old)

    # the reference's resyncPeriod is this same relist, on a timer
    resync = relist

    def _snapshot_all(self) -> None:
        # caller holds _mu
        if self._mutation_detector:
            self._snapshots = {k: o.to_dict() for k, o in self._cache.items()}

    def _check_snapshot(self, key: str, old, new) -> None:
        """Caller holds _mu.  Before a delta replaces ``old``, hold it to
        the snapshot taken when it entered the cache; then snapshot
        ``new`` (None: the key leaves the cache)."""
        if not self._mutation_detector:
            return
        snap = self._snapshots.get(key)
        if old is not None and snap is not None and old.to_dict() != snap:
            raise CacheMutationError(f"{self.kind} {key} was mutated in the informer cache")
        if new is None:
            self._snapshots.pop(key, None)
        else:
            self._snapshots[key] = new.to_dict()

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
    def _apply(self, ev) -> None:
        if ev.type == FRAME:
            # a column-packed batch: one lock hold for the whole frame
            return self._apply_batch(ev)
        if ev.type == WATCH_GAP:
            # the transport lost continuity (410 on resume) and ended its
            # stream: no payload to apply; rebuild from a fresh LIST
            self._try_relist()
            return
        tr = tracing.current()
        # a span an event only when the tracer is verbose (frames always get one)
        with (tr.span("informer.event.apply", cat="ingest", kind=self.kind, key=ev.key,
                      type=ev.type)
              if tr is not None and tr.verbose else tracing.NULL_SPAN):
            t_apply = time.perf_counter()
            try:
                self._apply_event(ev)
            finally:
                dt = time.perf_counter() - t_apply
                with self._mu:
                    self.stats["apply_s"] += dt

    def _apply_event(self, ev: WatchEvent) -> None:
        if ev.revision <= self.last_revision:
            # a straggler from a watch a relist already superseded
            return
        fault = faults.hit("informer.deliver", kind=self.kind, key=ev.key, type=ev.type)
        if fault is not None and fault.mode == "drop":
            # lossy delivery: the cache diverges until a relist reconverges it
            with self._mu:
                self.stats["dropped_events"] += 1
            self.metrics.informer_dropped_events.inc()
            return
        t_decode = time.perf_counter()
        try:
            faults.hit("informer.decode", kind=self.kind, key=ev.key, type=ev.type)
            if lazy_mod.ENABLED:
                # the payload becomes the object's wire backing; typed
                # fields materialize on first touch
                obj = lazy_mod.wrap(self._client._cls, ev.object)
            else:
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
            self.stats["events"] += 1
            old = self._cache.get(ev.key)
            self._check_snapshot(ev.key, old, None if ev.type == DELETED else obj)
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

    # -- batch (frame) application -----------------------------------------
    def _decode_frame(self, frame: WatchFrame, fence: int) -> tuple:
        """Decode a frame's payloads outside the cache lock.  Returns
        (decoded, dropped, decode_errors, decode_s), decoded = [(i, type,
        key, revision, obj)].  A dropped delivery or an undecodable payload
        loses that delta (gap marked), never the frame."""
        decoded = []
        dropped = decode_errors = 0
        t_decode = time.perf_counter()
        cls = self._client._cls
        for i in range(len(frame)):
            etype, key, rev = frame.types[i], frame.keys[i], frame.revisions[i]
            if rev <= fence:
                continue  # stragglers inside a superseded frame
            fault = faults.hit("informer.deliver", kind=self.kind, key=key, type=etype)
            if fault is not None and fault.mode == "drop":
                dropped += 1
                continue
            try:
                faults.hit("informer.decode", kind=self.kind, key=key, type=etype)
                raw = frame.objects[i]
                obj = lazy_mod.wrap(cls, raw) if lazy_mod.ENABLED else cls.from_dict(raw)
            except Exception:
                decode_errors += 1
                logger.exception("informer %s: failed to decode %s %s in a frame — "
                                 "relist scheduled", self.kind, etype, key)
                continue
            decoded.append((i, etype, key, rev, obj))
        return decoded, dropped, decode_errors, time.perf_counter() - t_decode

    def _apply_batch(self, frame: WatchFrame) -> None:
        """Apply one frame: decode outside the lock, land the whole batch
        in the cache under one lock hold, and hand it to each handler in
        one isolated ``on_batch`` call (or the per-event callbacks).  A
        frame that fails before any event applied is lost as a unit and
        marks a gap, which the relist path heals.  Its span carries the
        store txn's correlation id, as the scheduler's confirm span inside
        it does."""
        tr = tracing.current()
        with (tr.span("informer.frame.apply", cat="ingest", kind=self.kind, txn=frame.txn,
                      events=len(frame))
              if tr is not None else tracing.NULL_SPAN):
            self._apply_batch_inner(frame)

    def _apply_batch_inner(self, frame: WatchFrame) -> None:
        t_apply = time.perf_counter()
        try:
            faults.hit("informer.apply_batch", kind=self.kind, n=len(frame))
            decoded, dropped, decode_errors, decode_s = self._decode_frame(
                frame, self.last_revision)
        except Exception:
            with self._mu:
                self.stats["batch_errors"] += 1
                self._gap_pending = True
            self.metrics.informer_frame_errors.inc()
            logger.exception("informer %s: failed to apply a %d-event frame — relist "
                             "scheduled", self.kind, len(frame))
            return
        if dropped:
            self.metrics.informer_dropped_events.inc(dropped)
        if decode_errors:
            self.metrics.informer_decode_errors.inc(decode_errors)
        applied: list = []
        with self._mu:
            self.stats["frames"] += 1
            self.stats["dropped_events"] += dropped
            self.stats["decode_errors"] += decode_errors
            if decode_errors:
                self._gap_pending = True
            self.stats["decode_s"] += decode_s
            for i, etype, key, rev, obj in decoded:
                if rev <= self.last_revision:
                    continue  # a concurrent relist superseded this event
                old = self._cache.get(key)
                self._check_snapshot(key, old, None if etype == DELETED else obj)
                if etype == DELETED:
                    self._cache.pop(key, None)
                else:
                    self._cache[key] = obj
                self.last_revision = max(self.last_revision, rev)
                applied.append((etype, old, obj, i))
            self.stats["frame_events"] += len(applied)
            handlers = list(self._handlers)
        for h in handlers:
            if h.on_batch is not None:
                self._deliver(h.on_batch, frame, applied)
                continue
            for etype, old, obj, _i in applied:
                if etype == ADDED:
                    self._deliver(h.on_add, obj)
                elif etype == MODIFIED:
                    self._deliver(h.on_update, old, obj)
                elif etype == DELETED:
                    self._deliver(h.on_delete, old if old is not None else obj)
        dt = time.perf_counter() - t_apply
        with self._mu:
            self.stats["apply_s"] += dt

    # -- cache compaction (promote-and-drop-raw) ---------------------------
    def compact_cache(self) -> int:
        """Promote every lazy view of the cache to its typed form and
        release its pinned wire dict.  Promotion is what any reader would
        have triggered, so concurrent readers are safe and the objects'
        values are unchanged.  Returns the number of objects whose payload
        was dropped; the approximate bytes released go to
        ``client_informer_compaction_freed_bytes``."""
        with self._mu:
            objs = list(self._cache.values())
        n = 0
        freed = 0
        for obj in objs:
            size = lazy_mod.raw_payload_size(obj)
            if lazy_mod.promote_and_drop_raw(obj):
                n += 1
                freed += size
        with self._mu:
            self.stats["compactions"] += n
        if n:
            self.metrics.informer_compactions.inc(n)
        self.metrics.informer_compaction_freed_bytes.set(freed)
        return n


class CacheMutationError(RuntimeError):
    pass


class InformerFactory:
    """SharedInformerFactory: one informer per kind per factory."""

    def __init__(self, clientset, mutation_detector: bool = False,
                 compact_on_resync: bool = False):
        self._clientset = clientset
        self._mutation_detector = mutation_detector
        self._compact_on_resync = compact_on_resync
        self._informers: dict[str, SharedInformer] = {}
        self._mk_mu = threading.Lock()

    def informer(self, kind: str) -> SharedInformer:
        inf = self._informers.get(kind)  # hit path: lock-free
        if inf is None:
            with self._mk_mu:
                inf = self._informers.get(kind)
                if inf is None:
                    inf = SharedInformer(self._clientset.client_for(kind),
                                         mutation_detector=self._mutation_detector,
                                         compact_on_resync=self._compact_on_resync)
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

    def relist_all(self) -> None:
        """Resync every synced informer (the factory's resync tick): each
        re-LISTs, diffs and restarts its watch."""
        for inf in self.informers():
            if inf.has_synced():
                inf.relist()

    def pump_all(self) -> int:
        # a handler may register a new informer mid-pump (the GC wiring a
        # just-established CRD kind): it gets its events next round
        return sum(inf.pump() for inf in self.informers())

    def stop_all(self) -> None:
        for inf in self.informers():
            inf.stop()


class PodNodeIndex:
    """By-node pod index over a shared informer (the kubelet's
    ``spec.nodeName=<node>`` field selector, kept on the client side so a
    fleet of kubelets shares one Pod watch).

    Mutated on the informer's delivery thread and read by the kubelets
    (``pods_on``); both sides hold ``_mu``.  The pods are the informer's
    shared cache objects: readers must not mutate them."""

    def __init__(self, informer: SharedInformer):
        self._mu = threading.Lock()
        self._by_node: dict[str, dict] = {}
        informer.add_handler(
            Handler(on_add=self._upsert, on_update=lambda old, new: self._move(old, new),
                    on_delete=self._drop)
        )

    def _upsert(self, pod) -> None:
        if pod.spec.node_name:
            with self._mu:
                self._by_node.setdefault(pod.spec.node_name, {})[pod.meta.key] = pod

    def _move(self, old, new) -> None:
        # pop and insert under one lock hold: released between them, a
        # concurrent pods_on() could find the pod on no node at all
        with self._mu:
            if old is not None and old.spec.node_name and old.spec.node_name != new.spec.node_name:
                self._by_node.get(old.spec.node_name, {}).pop(old.meta.key, None)
                self._shed(old.spec.node_name)
            if new.spec.node_name:
                self._by_node.setdefault(new.spec.node_name, {})[new.meta.key] = new

    def _drop(self, pod) -> None:
        if pod.spec.node_name:
            with self._mu:
                self._by_node.get(pod.spec.node_name, {}).pop(pod.meta.key, None)
                self._shed(pod.spec.node_name)

    def _shed(self, node_name: str) -> None:
        # caller holds _mu: drop a node's dict with its last pod, or node
        # churn keeps an empty dict for every node name ever seen
        if not self._by_node.get(node_name):
            self._by_node.pop(node_name, None)

    def pods_on(self, node_name: str) -> list:
        with self._mu:
            return list(self._by_node.get(node_name, {}).values())


class PodOwnerIndex:
    """Pods by controller-owner UID, and orphans by namespace: a
    ReplicaSet's reconcile reads its own pods, not the cluster's
    (client-go keeps the same index in its Indexer).

    Written on the informer's delivery thread, read by controller workers;
    both sides hold ``_mu``."""

    def __init__(self, informer: SharedInformer):
        self._mu = threading.Lock()
        self._by_owner: dict[str, dict] = {}
        self._orphans: dict[str, dict] = {}  # namespace -> key -> pod
        informer.add_handler(Handler(on_add=self._upsert, on_update=self._move,
                                     on_delete=self._drop))

    def _slot(self, pod) -> dict:
        # caller holds _mu
        ref = pod.meta.controller_ref()
        if ref is not None:
            return self._by_owner.setdefault(ref.uid, {})
        return self._orphans.setdefault(pod.meta.namespace, {})

    def _upsert(self, pod) -> None:
        with self._mu:
            self._slot(pod)[pod.meta.key] = pod

    def _move(self, old, new) -> None:
        with self._mu:
            if old is not None:
                self._slot(old).pop(old.meta.key, None)
                self._shed(old)
            self._slot(new)[new.meta.key] = new

    def _drop(self, pod) -> None:
        with self._mu:
            self._slot(pod).pop(pod.meta.key, None)
            self._shed(pod)

    def _shed(self, pod) -> None:
        # caller holds _mu: drop an emptied slot, or every owner UID and
        # namespace the cluster has ever had keeps an empty dict
        ref = pod.meta.controller_ref()
        if ref is not None:
            if not self._by_owner.get(ref.uid):
                self._by_owner.pop(ref.uid, None)
        elif not self._orphans.get(pod.meta.namespace):
            self._orphans.pop(pod.meta.namespace, None)

    def owned_by(self, uid: str) -> list:
        with self._mu:
            return list(self._by_owner.get(uid, {}).values())

    def orphans_in(self, namespace: str) -> list:
        with self._mu:
            return list(self._orphans.get(namespace, {}).values())
