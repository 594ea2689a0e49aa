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
every get/list/event, so informer objects are immutable by construction.
Durability, replication, columnar lists, watch frames and the coalescing
window of the reference package are not part of this store.
"""

from __future__ import annotations

import collections
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from ..api.meta import new_uid


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


class Store:
    """In-process strongly ordered object store."""

    def __init__(self, event_log_window: int = 100_000):
        self._mu = threading.RLock()
        self._rev = 0
        # kind -> {key -> _Item}
        self._objects: dict[str, dict[str, _Item]] = {}
        # the watch-cache window; a deque so trimming the oldest is O(1)
        self._log: collections.deque[WatchEvent] = collections.deque(maxlen=event_log_window)
        # (kind filter or None, queue)
        self._watchers: list[tuple[Optional[str], "queue.Queue[Optional[WatchEvent]]"]] = []

    # -- revision ----------------------------------------------------------
    @property
    def revision(self) -> int:
        with self._mu:
            return self._rev

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
        data = obj if trusted else _py_fast_deepcopy(obj)
        m = data["metadata"]
        m.setdefault("namespace", "default")
        if not m.get("uid"):
            m["uid"] = new_uid()
        m["resourceVersion"] = rev
        m["creationRevision"] = rev
        bucket[key] = _Item(data=data, revision=rev)
        return WatchEvent(ADDED, kind, key, rev, _py_fast_deepcopy(data))

    def create(self, kind: str, obj: dict, _trusted: bool = False) -> dict:
        """``_trusted`` marks ``obj`` as privately owned (the typed client's
        freshly built wire dict), which skips the defensive copy.  The
        returned dict is the event's copy: read-only by contract."""
        with self._mu:
            ev = self._insert_locked(self._objects.setdefault(kind, {}), kind, obj, _trusted)
            self._emit(ev)
            return ev.object

    def create_many(self, kind: str, objs: list[dict],
                    _trusted: bool = False) -> list[Optional[dict]]:
        """Batch create under ONE lock acquisition: per item exactly
        :meth:`create` (same defaulting, same ADDED event, events in list
        order).  An item that fails (already exists, malformed) yields None
        in its slot and the rest of the batch still commits."""
        results: list[Optional[dict]] = []
        with self._mu:
            bucket = self._objects.setdefault(kind, {})
            for obj in objs:
                try:
                    ev = self._insert_locked(bucket, kind, obj, _trusted)
                except Exception:  # noqa: BLE001 - one bad item, not the batch
                    results.append(None)
                    continue
                self._emit(ev)
                results.append(ev.object)
        return results

    def update(
        self, kind: str, obj: dict, expect_rev: Optional[int] = None, _trusted: bool = False
    ) -> dict:
        """CAS write.  ``expect_rev`` defaults to obj.metadata.resourceVersion;
        0 there forces the write (last write wins)."""
        with self._mu:
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
            data = obj if _trusted else _py_fast_deepcopy(obj)
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
                    final = _py_fast_deepcopy(data)
                    self._emit(WatchEvent(DELETED, kind, key, rev, final))
                    return final
            bucket[key] = _Item(data=data, revision=rev)
            ev_copy = _py_fast_deepcopy(data)
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
        path ever mutates in place."""
        results: list[Optional[str]] = []
        with self._mu:
            bucket = self._objects.setdefault("Pod", {})
            for namespace, name, node_name in items:
                key = object_key(namespace, name)
                item = bucket.get(key)
                if item is None:
                    results.append("not found")
                    continue
                spec = item.data.setdefault("spec", {})
                cur = spec.get("nodeName", "")
                if cur and cur != node_name:
                    results.append(f"conflict: already bound to {cur}")
                    continue
                rev = self._next_rev()
                spec["nodeName"] = node_name
                item.data["metadata"]["resourceVersion"] = rev
                item.revision = rev
                ev_obj = {
                    **item.data,
                    "spec": dict(spec),
                    "metadata": dict(item.data["metadata"]),
                }
                self._emit(WatchEvent(MODIFIED, "Pod", key, rev, ev_obj))
                results.append(None)
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
        with self._mu:
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
                marked = _py_fast_deepcopy(item.data)
                self._emit(WatchEvent(MODIFIED, kind, key, rev, marked))
                return marked
            del bucket[key]
            final = _py_fast_deepcopy(item.data)
            final["metadata"]["deletionRevision"] = rev
            self._emit(WatchEvent(DELETED, kind, key, rev, final))
            return final

    # -- reads -------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._mu:
            item = self._objects.get(kind, {}).get(object_key(namespace, name))
            if item is None:
                raise NotFoundError(f"{kind} {namespace}/{name}")
            return _py_fast_deepcopy(item.data)

    def list(self, kind: str, namespace: Optional[str] = None) -> tuple[list[dict], int]:
        """Returns (objects sorted by namespace/name, list revision): the
        revision to start a watch from, the reflector's LIST-then-WATCH
        contract (``tools/cache/reflector.go:239``)."""
        with self._mu:
            out = []
            for item in self._objects.get(kind, {}).values():
                ns = item.data["metadata"].get("namespace", "")
                if namespace is None or ns == namespace:
                    out.append(_py_fast_deepcopy(item.data))
            out.sort(key=lambda d: (d["metadata"]["namespace"], d["metadata"]["name"]))
            return out, self._rev

    # -- watch -------------------------------------------------------------
    def watch(self, kind: Optional[str] = None, from_revision: Optional[int] = None) -> Watch:
        """Watch events for ``kind`` (None = all kinds) strictly after
        ``from_revision`` (None = now).  Raises ``ExpiredRevisionError`` if
        the revision has fallen out of the event-log window."""
        with self._mu:
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
            self._watchers.append((kind, q))
            return Watch(self, q)

    def _remove_watch(self, q) -> None:
        with self._mu:
            self._watchers = [(k, w) for (k, w) in self._watchers if w is not q]

    def _emit(self, ev: WatchEvent) -> None:
        # WatchEvent.object is shared read-only: one private copy is made
        # at emit time and handed to the log and every watcher (the
        # informer parses it into fresh typed objects)
        self._log.append(ev)  # deque maxlen trims the window
        for kind, q in self._watchers:
            if kind is None or kind == ev.kind:
                q.put(ev)
