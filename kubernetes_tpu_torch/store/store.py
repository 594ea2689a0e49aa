"""Revisioned in-process object store with CAS updates and watch streams.

The capability of the reference's etcd3 store plus its watch cache
(``apiserver/pkg/storage/etcd3/store.go``, ``storage/cacher.go``) in one
component:

- a single monotonically increasing **revision** stamped onto every write
  (etcd ``mod_revision``);
- **guaranteed_update**: optimistic-concurrency read-modify-write that
  retries the caller's mutation on a revision conflict
  (``storage/etcd3/store.go:257``);
- **watch from a revision**: every watcher gets the exact ordered event
  sequence after its start revision, replayed from a bounded in-memory
  event log (the watch-cache window, ``storage/watch_cache.go``); a
  revision older than the window raises ``ExpiredRevisionError`` and the
  watcher relists.

The store holds **serialized dicts**, never live objects, and copies on
every get/list/event (natively where ``native.get_fastcopy`` built), so
informer objects are immutable by construction.  ``list_columns`` emits a
columnar LIST (``store/columns.py``) and ``watch(frames=True)`` delivers a
``create_many``/``bind_many`` txn as one ``WatchFrame`` (``store/frames.py``).
Every write passes the ``store.commit`` fault point before it starts and,
with tracing on, runs in a ``store.txn`` span; batch txns carry a
correlation id (``tracing.next_txn``) on their span and their frame.

Durability (``data_dir``): every committed event is appended to a
write-ahead log (``store/wal.py``) before any watcher or the caller sees
it, snapshots bound the replay, and a new ``Store`` over the same
directory recovers the objects and the revision.  ``transformer``
encrypts the records at rest (``store/encryption.py``).  A follower
applies a leader's events through ``apply_replicated`` and
``install_snapshot`` (``store/replication.py``).  ``coalesce_window_s``
folds single-event churn per key for live delivery (off by default).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .. import faults
from ..api.meta import new_uid
from ..utils import tracing
from ..utils.metrics import DEFAULT_STORE_METRICS


def _py_fast_deepcopy(obj):
    """Deep copy for JSON-shaped data (dict/list/scalars only), the store's
    wire form by construction; about 3x faster than ``copy.deepcopy``,
    which pays for memo bookkeeping and type dispatch this shape never
    needs."""
    t = type(obj)
    if t is dict:
        return {k: _py_fast_deepcopy(v) for k, v in obj.items()}
    if t is list:
        return [_py_fast_deepcopy(v) for v in obj]
    return obj  # str/int/float/bool/None are immutable


def _fast_deepcopy(obj):
    """The first call resolves the copier (the native C walk of
    ``csrc/fastcopy.c`` where it builds, else the Python walk) and rebinds
    this name, so importing the store never compiles and later calls pay
    no dispatch."""
    global _fast_deepcopy
    from ..native import get_fastcopy

    _fast_deepcopy = get_fastcopy() or _py_fast_deepcopy
    return _fast_deepcopy(obj)


def object_key(namespace: str, name: str) -> str:
    """Canonical store/informer key; matches ``ObjectMeta.key``:
    cluster-scoped objects (empty namespace) use the bare name."""
    return f"{namespace}/{name}" if namespace else name


ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
# Not a state transition: a watch transport's admission that continuity
# was lost (410 Gone on resume, the event-log window slid past its
# bookmark).  An informer that receives it relists; it carries no object.
WATCH_GAP = "GAP"


class ConflictError(Exception):
    """CAS failure: the object's resourceVersion changed under the writer."""


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    pass


class ExpiredRevisionError(Exception):
    """The event-log window slid past the requested revision; relist."""


@dataclass(frozen=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    key: str  # namespace/name
    revision: int
    object: dict  # serialized object, shared read-only by every consumer


@dataclass
class _Item:
    data: dict
    revision: int


class Watch:
    """One watch stream.  Iterate, or ``get`` with a timeout; ``stop()``
    ends it.  Events arrive in revision order with no gaps."""

    def __init__(self, store: "Store", q: "queue.Queue[Optional[WatchEvent]]"):
        self._store = store
        self._queue = q
        self._stopped = threading.Event()

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self._store._remove_watch(self._queue)
            self._queue.put(None)

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            yield ev

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None


class _PendingBatch:
    """One open coalescing window: the latest buffered event of each
    (kind, key), awaiting one framed flush.

    A fold deletes and reinserts the key, so the dict's order is each
    key's latest commit and the flush frame's revision column is strictly
    increasing (the ``from_wire`` invariant).  The WAL, the event log and
    replication stay per-event at commit time; only live delivery to the
    watchers waits for the window."""

    __slots__ = ("latest", "deadline", "txn", "folded")

    def __init__(self, deadline: float, txn: str):
        self.latest: "collections.OrderedDict[tuple, WatchEvent]" = collections.OrderedDict()
        self.deadline = deadline
        self.txn = txn
        self.folded = 0  # deliveries superseded inside this window


class Store:
    """In-process strongly ordered object store."""

    def __init__(self, event_log_window: int = 100_000,
                 data_dir: Optional[str] = None, fsync: bool = False,
                 compact_every: int = 100_000, transformer=None,
                 coalesce_window_s: float = 0.0):
        self._mu = threading.RLock()
        self._rev = 0
        # kind -> {key -> _Item}
        self._objects: dict[str, dict[str, _Item]] = {}
        # the watch-cache window; a deque so trimming the oldest is O(1)
        self._log: collections.deque[WatchEvent] = collections.deque(maxlen=event_log_window)
        # (kind filter or None, queue, wants frames): a frame-aware watcher
        # (watch(frames=True)) gets one WatchFrame a batch txn, everyone
        # else the per-event expansion
        self._watchers: list[tuple[Optional[str], "queue.Queue[Optional[WatchEvent]]", bool]] = []
        # the coalescing window: 0.0 (the default) fans every event out at
        # commit; > 0 folds single-event churn per key (latest wins) and
        # flushes one frame a kind when the window closes.  Batch txns,
        # a new watcher and a snapshot install flush the open window first.
        self._coalesce_window = float(coalesce_window_s or 0.0)
        self._coalesce_max_keys = 10_000
        self._pending: Optional[_PendingBatch] = None
        self._coalesce_closed = False
        self._coalesce_wake: Optional[threading.Event] = None
        self._coalesce_thread: Optional[threading.Thread] = None
        if self._coalesce_window > 0.0:
            self._coalesce_wake = threading.Event()
            self._coalesce_thread = threading.Thread(
                target=self._coalesce_loop, name="store-coalesce", daemon=True)
            self._coalesce_thread.start()
        # durability: with a data_dir every committed event is logged
        # before the call returns, and a new Store over the same directory
        # recovers the objects and the revision
        self._wal = None
        if data_dir is not None:
            from .wal import WriteAheadLog

            self._wal = WriteAheadLog(data_dir, compact_every=compact_every,
                                      fsync=fsync, transformer=transformer)
            rev, objects, _ = self._wal.recover()
            self._rev = rev
            for kind, bucket in objects.items():
                for key, data in bucket.items():
                    self._objects.setdefault(kind, {})[key] = _Item(
                        data=data,
                        revision=int(data.get("metadata", {}).get("resourceVersion", rev)))
            self._wal.open()

    def compact(self) -> None:
        """Write a snapshot and truncate the WAL (etcd compaction).  The
        snapshot is encoded while the store lock is held, so the live
        dicts need no copy."""
        if self._wal is None:
            return
        with self._mu:
            objects = {kind: {key: item.data for key, item in bucket.items()}
                       for kind, bucket in self._objects.items()}
            self._wal.write_snapshot(self._rev, objects)

    def close(self) -> None:
        if self._coalesce_thread is not None:
            self._coalesce_closed = True
            self._coalesce_wake.set()
            self._coalesce_thread.join(timeout=5.0)
            self.flush_coalesced()  # nothing buffered outlives the store
        if self._wal is not None:
            self._wal.close()

    # -- revision ----------------------------------------------------------
    @property
    def revision(self) -> int:
        with self._mu:
            return self._rev

    @property
    def user(self) -> str:
        """The request's identity, which the apiserver sets on every
        request; only an admitted store keeps it (for its plugins)."""
        return ""

    @user.setter
    def user(self, name: str) -> None:
        pass

    def _next_rev(self) -> int:
        self._rev += 1
        return self._rev

    # -- writes ------------------------------------------------------------
    def _insert_locked(self, bucket: dict, kind: str, obj: dict, trusted: bool) -> WatchEvent:
        meta = obj.setdefault("metadata", {})
        key = object_key(meta.get("namespace", "default"), meta.get("name", ""))
        if key in bucket:
            raise AlreadyExistsError(f"{kind} {key} already exists")
        rev = self._next_rev()
        data = obj if trusted else _fast_deepcopy(obj)
        m = data["metadata"]
        m.setdefault("namespace", "default")
        if not m.get("uid"):
            m["uid"] = new_uid()
        m["resourceVersion"] = rev
        m["creationRevision"] = rev
        bucket[key] = _Item(data=data, revision=rev)
        return WatchEvent(ADDED, kind, key, rev, _fast_deepcopy(data))

    def create(self, kind: str, obj: dict, _trusted: bool = False) -> dict:
        """``_trusted`` marks ``obj`` as privately owned (the typed client's
        freshly built wire dict), which skips the defensive copy.  The
        returned dict is the event's copy: read-only by contract."""
        # before the lock and any mutation: an injected commit failure
        # models an overloaded store, and the write never starts
        faults.hit("store.commit", op="create", kind=kind)
        tr = tracing.current()
        with (tr.span("store.txn", cat="store", op="create", kind=kind)
              if tr is not None else tracing.NULL_SPAN), self._mu:
            ev = self._insert_locked(self._objects.setdefault(kind, {}), kind, obj, _trusted)
            self._emit(ev)
            return ev.object

    def create_many(self, kind: str, objs: list[dict],
                    _trusted: bool = False) -> list[Optional[dict]]:
        """Batch create under ONE lock acquisition: per item exactly
        :meth:`create` (same defaulting, same ADDED event, events in list
        order).  An item that fails (already exists, malformed) yields None
        in its slot and the rest of the batch still commits."""
        faults.hit("store.commit", op="create_many", kind=kind)
        results: list[Optional[dict]] = []
        # minted whether or not tracing is on: it rides the watch frame
        txn = tracing.next_txn("create_many")
        tr = tracing.current()
        with (tr.span("store.txn", cat="store", op="create_many", kind=kind, txn=txn,
                      n=len(objs))
              if tr is not None else tracing.NULL_SPAN) as sp, self._mu:
            bucket = self._objects.setdefault(kind, {})
            events: list[WatchEvent] = []
            for obj in objs:
                try:
                    ev = self._insert_locked(bucket, kind, obj, _trusted)
                except Exception:  # noqa: BLE001 - one bad item, not the batch
                    results.append(None)
                    continue
                events.append(ev)
                results.append(ev.object)
            # the txn fans out as one frame to each frame-aware watcher
            self._emit_many(events, txn=txn)
            sp.set(committed=len(events))
        return results

    def update(
        self, kind: str, obj: dict, expect_rev: Optional[int] = None, _trusted: bool = False
    ) -> dict:
        """CAS write.  ``expect_rev`` defaults to obj.metadata.resourceVersion;
        0 there forces the write (last write wins)."""
        faults.hit("store.commit", op="update", kind=kind)
        tr = tracing.current()
        with (tr.span("store.txn", cat="store", op="update", kind=kind)
              if tr is not None else tracing.NULL_SPAN), self._mu:
            meta = obj.get("metadata") or {}
            key = object_key(meta.get("namespace", "default"), meta.get("name", ""))
            bucket = self._objects.setdefault(kind, {})
            item = bucket.get(key)
            if item is None:
                raise NotFoundError(f"{kind} {key}")
            if expect_rev is None:
                expect_rev = int(meta.get("resourceVersion", 0)) or None
            if expect_rev is not None and item.revision != expect_rev:
                raise ConflictError(
                    f"{kind} {key}: expected rev {expect_rev}, have {item.revision}"
                )
            rev = self._next_rev()
            data = obj if _trusted else _fast_deepcopy(obj)
            m = data["metadata"]
            m["uid"] = item.data["metadata"]["uid"]
            m["resourceVersion"] = rev
            m["creationRevision"] = item.data["metadata"].get("creationRevision", 0)
            # the deletion tombstone is immutable once set (graceful deletion)
            prior_del = item.data["metadata"].get("deletionRevision")
            if prior_del is not None:
                m["deletionRevision"] = prior_del
                if not m.get("finalizers"):
                    # the last finalizer went: finish the delete
                    # (registry/generic/registry/store.go:977)
                    del bucket[key]
                    final = _fast_deepcopy(data)
                    self._emit(WatchEvent(DELETED, kind, key, rev, final))
                    return final
            bucket[key] = _Item(data=data, revision=rev)
            ev_copy = _fast_deepcopy(data)
            self._emit(WatchEvent(MODIFIED, kind, key, rev, ev_copy))
            return ev_copy

    def bind_many(self, items: list[tuple[str, str, str]]) -> list[Optional[str]]:
        """Batch placement commit: for each (namespace, name, node_name),
        CAS-set ``spec.nodeName`` under ONE lock acquisition, the etcd-txn
        counterpart of one Binding call per pod.

        Returns one entry per item: None on success, else an error string
        ("not found" / "conflict: ...").  Per-pod MODIFIED events are still
        emitted; their objects share the stored containers/status
        structures and own fresh spec/metadata dicts, the only parts this
        path ever mutates in place.  Frame-aware watchers get the txn as
        one frame whose ``prev_revisions`` column holds each pod's revision
        before the bind (the scheduler's confirm fence)."""
        faults.hit("store.commit", op="bind_many", kind="Pod")
        results: list[Optional[str]] = []
        txn = tracing.next_txn("bind_many")
        tr = tracing.current()
        with (tr.span("store.txn", cat="store", op="bind_many", kind="Pod", txn=txn,
                      n=len(items))
              if tr is not None else tracing.NULL_SPAN) as sp, self._mu:
            bucket = self._objects.setdefault("Pod", {})
            events: list[WatchEvent] = []
            prev_revs: list[int] = []
            for namespace, name, node_name in items:
                key = object_key(namespace, name)
                # one pod's bind fails while the rest of the txn commits
                # (a partial bind): this item's error string, no exception
                if faults.hit("scheduler.bind", pod=key, node=node_name,
                              via="bind_many") is not None:
                    results.append("injected: bind fault")
                    continue
                item = bucket.get(key)
                if item is None:
                    results.append("not found")
                    continue
                spec = item.data.setdefault("spec", {})
                cur = spec.get("nodeName", "")
                if cur and cur != node_name:
                    results.append(f"conflict: already bound to {cur}")
                    continue
                prev_revs.append(item.revision)
                rev = self._next_rev()
                spec["nodeName"] = node_name
                item.data["metadata"]["resourceVersion"] = rev
                item.revision = rev
                ev_obj = {
                    **item.data,
                    "spec": dict(spec),
                    "metadata": dict(item.data["metadata"]),
                }
                events.append(WatchEvent(MODIFIED, "Pod", key, rev, ev_obj))
                results.append(None)
            self._emit_many(events, prev_revisions=prev_revs, txn=txn)
            sp.set(committed=len(events), errors=sum(1 for r in results if r is not None))
        return results

    def guaranteed_update(
        self, kind: str, namespace: str, name: str, mutate: Callable[[dict], dict]
    ) -> dict:
        """Read-modify-write retry loop (``etcd3/store.go:257``).  ``mutate``
        receives a private copy and returns the new object (or raises)."""
        while True:
            cur = self.get(kind, namespace, name)
            rev = int(cur["metadata"]["resourceVersion"])
            new = mutate(cur)
            try:
                return self.update(kind, new, expect_rev=rev, _trusted=True)
            except ConflictError:
                continue

    def delete(self, kind: str, namespace: str, name: str, expect_rev: Optional[int] = None) -> dict:
        """Delete, honoring finalizers: while ``metadata.finalizers`` is
        non-empty the object is only marked deleting (``deletionRevision``
        tombstone, MODIFIED event); the removal happens when an update
        clears the last finalizer."""
        faults.hit("store.commit", op="delete", kind=kind)
        tr = tracing.current()
        with (tr.span("store.txn", cat="store", op="delete", kind=kind)
              if tr is not None else tracing.NULL_SPAN), self._mu:
            key = object_key(namespace, name)
            bucket = self._objects.setdefault(kind, {})
            item = bucket.get(key)
            if item is None:
                raise NotFoundError(f"{kind} {key}")
            if expect_rev is not None and item.revision != expect_rev:
                raise ConflictError(f"{kind} {key}")
            rev = self._next_rev()
            if item.data["metadata"].get("finalizers"):
                item.data["metadata"]["deletionRevision"] = rev
                item.data["metadata"]["resourceVersion"] = rev
                item.revision = rev
                marked = _fast_deepcopy(item.data)
                self._emit(WatchEvent(MODIFIED, kind, key, rev, marked))
                return marked
            del bucket[key]
            final = _fast_deepcopy(item.data)
            final["metadata"]["deletionRevision"] = rev
            self._emit(WatchEvent(DELETED, kind, key, rev, final))
            return final

    # -- reads -------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._mu:
            item = self._objects.get(kind, {}).get(object_key(namespace, name))
            if item is None:
                raise NotFoundError(f"{kind} {namespace}/{name}")
            return _fast_deepcopy(item.data)

    # -- the follower side of replication (store/replication.py) -----------
    def apply_replicated(self, ev: WatchEvent) -> None:
        """Apply a leader's committed event as it is: no CAS re-check (it
        won on the leader), the revision follows the leader's, and the
        local WAL and watchers see it as a local commit.  An event at or
        below the applied revision is a no-op (catch-up may ship twice)."""
        with self._mu:
            if ev.revision <= self._rev:
                return
            bucket = self._objects.setdefault(ev.kind, {})
            if ev.type == DELETED:
                bucket.pop(ev.key, None)
            else:
                bucket[ev.key] = _Item(data=_fast_deepcopy(ev.object), revision=ev.revision)
            self._rev = ev.revision
            self._emit(WatchEvent(ev.type, ev.kind, ev.key, ev.revision,
                                  _fast_deepcopy(ev.object)))

    def install_snapshot(self, rev: int, objects: dict) -> None:
        """Replace the state wholesale (raft InstallSnapshot): a rejoining
        replica older than the leader's log window takes this path."""
        with self._mu:
            # buffered events precede the snapshot: deliver them before
            # the jump (watchers older than the snapshot relist)
            self._flush_pending_locked()
            self._objects = {
                kind: {key: _Item(data=_fast_deepcopy(data),
                                  revision=data["metadata"].get("resourceVersion", rev))
                       for key, data in bucket.items()}
                for kind, bucket in objects.items()
            }
            self._rev = rev
            self._log.clear()  # watchers older than the snapshot must relist
            if self._wal is not None:
                # the old WAL's events do not compose with the new revision
                # line: snapshot now or recovery diverges
                self.compact()

    def list(self, kind: str, namespace: Optional[str] = None) -> tuple[list[dict], int]:
        """Returns (objects sorted by namespace/name, list revision): the
        revision to start a watch from, the reflector's LIST-then-WATCH
        contract (``tools/cache/reflector.go:239``)."""
        with self._mu:
            out = []
            for item in self._objects.get(kind, {}).values():
                ns = item.data["metadata"].get("namespace", "")
                if namespace is None or ns == namespace:
                    out.append(_fast_deepcopy(item.data))
            out.sort(key=lambda d: (d["metadata"]["namespace"], d["metadata"]["name"]))
            return out, self._rev

    def list_columns(self, kind: str = "Pod", namespace: Optional[str] = None):
        """Columnar LIST (Pod and Node): one packed batch of raw views plus
        identity (and for pods signature) columns, see ``store/columns.py``.
        The views share deep subtrees with the stored dicts: only the two
        levels the store mutates in place are copied, under the lock, so
        the batch is a consistent snapshot at its revision.  Payloads are
        read-only.  None for kinds without a columnar form (callers fall
        back to :meth:`list`)."""
        from .columns import COLUMN_BATCH_KINDS, batch_from_views, shallow_object_view

        if kind not in COLUMN_BATCH_KINDS:
            return None
        with self._mu:
            rev = self._rev
            views = []
            for item in self._objects.get(kind, {}).values():
                if namespace is not None:
                    ns = item.data.get("metadata", {}).get("namespace", "")
                    if ns != namespace:
                        continue
                views.append(shallow_object_view(item.data))
        return batch_from_views(views, rev, kind=kind)

    # -- watch -------------------------------------------------------------
    def watch(self, kind: Optional[str] = None, from_revision: Optional[int] = None,
              frames: bool = False) -> Watch:
        """Watch events for ``kind`` (None = all kinds) strictly after
        ``from_revision`` (None = now).  Raises ``ExpiredRevisionError`` if
        the revision has fallen out of the event-log window.

        ``frames=True``: a correlated batch txn (``create_many``/
        ``bind_many``) arrives as one :class:`~.frames.WatchFrame` instead
        of N events (the log replay stays per-event)."""
        with self._mu:
            # ordering barrier: flush the open coalescing window before the
            # log replay, which already holds the buffered events, or the
            # flush would deliver them a second time
            self._flush_pending_locked()
            q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
            if from_revision is not None and from_revision < self._rev:
                oldest = self._log[0].revision if self._log else self._rev + 1
                if from_revision + 1 < oldest:
                    raise ExpiredRevisionError(
                        f"revision {from_revision} too old (oldest {oldest})"
                    )
                for ev in self._log:
                    if ev.revision > from_revision and (kind is None or ev.kind == kind):
                        q.put(ev)
            self._watchers.append((kind, q, frames))
            return Watch(self, q)

    def _remove_watch(self, q) -> None:
        with self._mu:
            self._watchers = [(k, w, f) for (k, w, f) in self._watchers if w is not q]

    def _append_log(self, ev: WatchEvent) -> None:
        """Durability and the watch-cache window for one event (no fan-out)."""
        if self._wal is not None:
            # durability before visibility: the record is on disk before
            # any watcher or the caller observes the commit
            self._wal.append(ev.type, ev.kind, ev.key, ev.revision, ev.object)
            if self._wal.needs_compaction():
                self.compact()  # an RLock: the write path may re-enter
        self._log.append(ev)  # deque maxlen trims the window

    def _replicate(self, ev: WatchEvent) -> None:
        """The per-event shipping hook, a no-op here: ``ReplicatedStore``
        ships to its followers.  Both emit paths call it, after local
        durability."""

    def _emit(self, ev: WatchEvent) -> None:
        # WatchEvent.object is shared read-only: one private copy is made
        # at emit time and handed to the log and every watcher (the
        # informer parses it into fresh typed objects)
        self._append_log(ev)
        self._replicate(ev)
        if self._coalesce_window > 0.0:
            # only live delivery waits for the window; with nobody watching
            # there is nothing to deliver (watch() replays the log)
            if self._watchers:
                self._buffer_event(ev)
            return
        for kind, q, _frames in self._watchers:
            if kind is None or kind == ev.kind:
                q.put(ev)

    # -- the coalescing window ---------------------------------------------
    def _buffer_event(self, ev: WatchEvent) -> None:
        """Fold one committed event into the open window, opening one if
        needed.  The caller holds the store lock."""
        p = self._pending
        if p is None:
            p = self._pending = _PendingBatch(time.monotonic() + self._coalesce_window,
                                              tracing.next_txn("coalesce"))
            self._coalesce_wake.set()
        k = (ev.kind, ev.key)
        if k in p.latest:
            # latest wins: the superseded delivery is dropped and the key
            # moves to the tail, so the flush's revisions stay increasing
            del p.latest[k]
            p.folded += 1
        p.latest[k] = ev
        # bounded: the window flushes inline at its key cap
        if len(p.latest) >= self._coalesce_max_keys:
            self._flush_pending_locked()

    def flush_coalesced(self) -> None:
        """Deliver the open window now: the flusher's deadline, an ordering
        barrier, or an explicit flush."""
        with self._mu:
            self._flush_pending_locked()

    def _flush_pending_locked(self) -> None:
        p = self._pending
        if p is None:
            return
        self._pending = None
        events = list(p.latest.values())
        if not events:
            return
        from . import frames as frames_mod

        m = DEFAULT_STORE_METRICS
        m.coalesce_flushes.inc()
        if p.folded:
            m.coalesced_events.inc(p.folded)
        by_kind: dict[str, list[WatchEvent]] = {}
        for ev in events:
            by_kind.setdefault(ev.kind, []).append(ev)
        # a synthetic frame carries no prev_revisions: the fold hides the
        # intermediate transitions, so consumers take the per-object
        # compare; the frame's fence (its last revision) is exact
        frames_by_kind: dict[str, object] = {}
        # the window's own span: the flusher's deadline runs on a thread
        # with no other span open, and a fault at the seam dumps with the
        # window's txn as its context
        tr = tracing.current()
        with (tr.span("store.coalesce", cat="store", txn=p.txn, events=len(events),
                      folded=p.folded)
              if tr is not None else tracing.NULL_SPAN):
            try:
                faults.hit("store.coalesce", n=len(events), folded=p.folded)
                if frames_mod.ENABLED:
                    for kind, evs in by_kind.items():
                        if len(evs) > 1:
                            frames_by_kind[kind] = frames_mod.WatchFrame(
                                kind, [e.type for e in evs], [e.key for e in evs],
                                [e.revision for e in evs], [e.object for e in evs],
                                prev_revisions=None, txn=p.txn)
            except Exception:  # noqa: BLE001 - degrade, never drop state
                # this window falls back to per-event delivery of the same
                # folded events: every consumer converges to the same state,
                # only the packing is lost
                frames_by_kind = {}
                m.coalesce_fallbacks.inc()
        for wkind, q, wants_frames in self._watchers:
            for kind, evs in by_kind.items():
                if wkind is not None and wkind != kind:
                    continue
                frame = frames_by_kind.get(kind) if wants_frames else None
                if frame is not None:
                    q.put(frame)
                else:
                    for ev in evs:
                        q.put(ev)

    def _coalesce_loop(self) -> None:
        """The flusher thread: parked until a window opens, then sleeps out
        its deadline and flushes, never holding the store lock asleep."""
        while True:
            self._coalesce_wake.wait()  # blocking-ok — parked until a window opens
            self._coalesce_wake.clear()
            if self._coalesce_closed:
                return
            while not self._coalesce_closed:
                with self._mu:
                    p = self._pending
                    delay = 0.0 if p is None else p.deadline - time.monotonic()
                if p is None:
                    break
                if delay > 0:
                    time.sleep(delay)  # blocking-ok — outside the lock, bounded by the window
                    continue
                self.flush_coalesced()

    def _emit_many(self, events: list[WatchEvent],
                   prev_revisions: Optional[list[int]] = None,
                   txn: Optional[str] = None) -> None:
        """Fan one correlated batch out: the log stays per-event, every
        frame-aware watcher receives one column-packed frame (one queue
        put, one informer lock hold, one handler fan-out for the txn), and
        per-event watchers see the same event sequence as before."""
        if not events:
            return
        from . import frames as frames_mod

        # ordering barrier: a batch txn fans out at commit, so an open
        # coalescing window reaches the queues first
        self._flush_pending_locked()
        for ev in events:
            self._append_log(ev)
            self._replicate(ev)
        want_frame = len(events) > 1 and frames_mod.ENABLED
        kind = events[0].kind  # batch txns are single-kind
        frame = None
        for wkind, q, wants_frames in self._watchers:
            if wkind is not None and wkind != kind:
                continue
            if wants_frames and want_frame:
                if frame is None:  # built once, shared-immutable
                    frame = frames_mod.WatchFrame(
                        kind, [ev.type for ev in events], [ev.key for ev in events],
                        [ev.revision for ev in events], [ev.object for ev in events],
                        prev_revisions=prev_revisions, txn=txn)
                q.put(frame)
            else:
                for ev in events:
                    q.put(ev)
