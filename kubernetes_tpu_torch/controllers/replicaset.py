"""ReplicaSet controller: keep N replicas of a pod template alive.

Capability of ``pkg/controller/replicaset`` (861 LoC; the expectations and
adoption patterns from ``controller_utils.go`` / ``controller_ref_manager.go``):

- reconciles |owned pods| to ``spec.replicas`` by creating/deleting pods;
- **adoption**: selector-matching pods with no controller owner are
  claimed by stamping an ownerReference;
- **expectations**: in-flight creates/deletes are remembered so a sync
  storm doesn't double-create before the informer catches up;
- deletion preference: unbound (pending) pods die first, mirroring the
  reference's pod-deletion cost ranking;
- creates go out in slow-start batches of 1, 2, 4, ... pods in parallel,
  and deletes all in parallel (the reference's ``slowStartBatch`` and its
  goroutine a delete), on at most ``PARALLEL_WRITES`` threads; the JAX
  controller writes them one at a time.  The pods' names are drawn in
  order before the writes go out, so they are the JAX controller's.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from ..api import types as api
from ..api.meta import ObjectMeta, OwnerReference
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller

_suffix = itertools.count(1)

# the writes one sync has in flight at once (the reference has a goroutine
# a write; a thread a write here holds a connection to the apiserver each)
PARALLEL_WRITES = 8


class Expectations:
    """Per-RS counters of in-flight creates/deletes (controller_utils.go).

    Locked like the reference's ControllerExpectations (a ThreadSafeStore):
    ``expect``/``forget``/``satisfied`` run on sync workers while
    ``observe_create``/``observe_delete`` run on the informer's pod-event
    thread — the read-decrement-write pairs lose counts without the lock.
    """

    def __init__(self):
        self._exp: dict[str, tuple[int, int]] = {}
        self._mu = threading.Lock()

    def expect(self, key: str, creates: int, deletes: int) -> None:
        with self._mu:
            self._exp[key] = (creates, deletes)

    def observe_create(self, key: str) -> None:
        with self._mu:
            c, d = self._exp.get(key, (0, 0))
            if c > 0:
                self._exp[key] = (c - 1, d)

    def observe_delete(self, key: str) -> None:
        with self._mu:
            c, d = self._exp.get(key, (0, 0))
            if d > 0:
                self._exp[key] = (c, d - 1)

    def satisfied(self, key: str) -> bool:
        with self._mu:
            c, d = self._exp.get(key, (0, 0))
            return c <= 0 and d <= 0

    def forget(self, key: str) -> None:
        with self._mu:
            self._exp.pop(key, None)


class ReplicaSetController(Controller):
    name = "replicaset"
    KIND = "ReplicaSet"  # subclassed for ReplicationController, whose
    # semantics are this controller with a map selector (pkg/controller/
    # replication is the same code pattern in the reference)

    def __init__(self, clientset, informers=None, burst_replicas: int = 500, **kw):
        super().__init__(clientset, informers, **kw)
        self.expectations = Expectations()
        self.burst_replicas = burst_replicas
        self._writers: Optional[ThreadPoolExecutor] = None
        self._writers_mu = threading.Lock()
        self.watch(self.KIND)
        from ..client.informer import Handler, PodOwnerIndex

        self.pod_index = PodOwnerIndex(self.informers.informer("Pod"))
        self.informers.informer("Pod").add_handler(
            Handler(
                on_add=lambda pod: self._pod_event(pod, "add"),
                on_update=lambda old, new: self._pod_event(new, "update"),
                on_delete=lambda pod: self._pod_event(pod, "delete"),
            )
        )

    def _pod_event(self, pod: api.Pod, event: str) -> None:
        key = self._rs_key_for_pod(pod)
        if key is None:
            return
        # expectations observe only the event kinds they count
        if event == "add":
            self.expectations.observe_create(key)
        elif event == "delete":
            self.expectations.observe_delete(key)
        self.queue.add(key)

    def _rs_key_for_pod(self, pod: api.Pod) -> Optional[str]:
        ref = pod.meta.controller_ref()
        if ref is not None:
            if ref.kind != self.KIND:
                return None
            return f"{pod.meta.namespace}/{ref.name}"
        # orphan: wake every RS in the namespace whose selector matches
        for rs in self.informer(self.KIND).list():
            if rs.meta.namespace == pod.meta.namespace and rs.selector.matches(pod.meta.labels):
                return rs.meta.key
        return None

    # -- reconcile ---------------------------------------------------------
    def _owned_and_orphans(self, rs: api.ReplicaSet):
        """O(pods-of-this-RS) via the owner-uid index, not O(cluster-pods)."""
        owned = [
            p
            for p in self.pod_index.owned_by(rs.meta.uid)
            if p.meta.namespace == rs.meta.namespace
            and p.status.phase not in (api.SUCCEEDED, api.FAILED)
        ]
        orphans = []
        if not rs.selector.is_empty():
            for pod in self.pod_index.orphans_in(rs.meta.namespace):
                if pod.status.phase in (api.SUCCEEDED, api.FAILED):
                    continue
                if rs.selector.matches(pod.meta.labels):
                    orphans.append(pod)
        return owned, orphans

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        # the informer's copy (the reference's lister): a sync follows each
        # pod event, and the JAX controller GETs the set over the wire
        rs = self.informer(self.KIND).get(key)
        if rs is None:
            self.expectations.forget(key)
            return
        if not self.expectations.satisfied(key):
            return  # wait for the informer to observe in-flight changes

        owned, orphans = self._owned_and_orphans(rs)
        # adoption (controller_ref_manager.go): claim matching orphans
        for pod in orphans:
            try:
                self.clientset.pods.guaranteed_update(
                    pod.meta.name,
                    lambda p: self._stamp_owner(p, rs),
                    pod.meta.namespace,
                )
                owned.append(pod)
            except NotFoundError:
                continue

        diff = len(owned) - rs.replicas
        if diff < 0:
            n = min(-diff, self.burst_replicas)
            self.expectations.expect(key, n, 0)
            names = [f"{rs.meta.name}-{next(_suffix):06d}" for _ in range(n)]
            created = []  # list.append is atomic: the writers share it

            def _create(name: str) -> None:
                self._create_pod(rs, name)
                created.append(name)

            try:
                done, size = 0, 1
                while done < n:  # slowStartBatch: a failed batch stops the rest
                    batch = names[done:done + size]
                    self._parallel([lambda name=name: _create(name) for name in batch])
                    done += len(batch)
                    size = 2 * size
            finally:
                # the creates that failed or never went out will not be observed
                for _ in range(n - len(created)):
                    self.expectations.observe_create(key)
        elif diff > 0:
            n = min(diff, self.burst_replicas)
            # prefer deleting pods that aren't running yet (unbound first)
            victims = sorted(owned, key=lambda p: (bool(p.spec.node_name), p.meta.name))[:n]
            self.expectations.expect(key, 0, n)

            def _delete(pod: api.Pod) -> None:
                try:
                    self.clientset.pods.delete(pod.meta.name, pod.meta.namespace)
                except NotFoundError:
                    self.expectations.observe_delete(key)

            self._parallel([lambda pod=pod: _delete(pod) for pod in victims])

        # status
        ready = sum(1 for p in owned if p.status.phase == api.RUNNING)
        if (
            rs.status_replicas != len(owned)
            or rs.status_ready_replicas != ready
            or rs.status_observed_generation != rs.meta.generation
        ):
            def _status(cur: api.ReplicaSet) -> api.ReplicaSet:
                cur.status_replicas = len(owned)
                cur.status_ready_replicas = ready
                cur.status_observed_generation = cur.meta.generation
                return cur

            self.clientset.client_for(self.KIND).guaranteed_update(name, _status, namespace)

    def _stamp_owner(self, pod: api.Pod, rs: api.ReplicaSet) -> api.Pod:
        if pod.meta.controller_ref() is None:
            pod.meta.owner_references.append(
                OwnerReference(kind=self.KIND, name=rs.meta.name, uid=rs.meta.uid, controller=True)
            )
        return pod

    def _parallel(self, writes: list[Callable[[], None]]) -> None:
        """Run ``writes`` together and wait for all; the first failure is
        raised once every write has ended."""
        if len(writes) == 1:
            writes[0]()
            return
        with self._writers_mu:
            if self._writers is None:
                self._writers = ThreadPoolExecutor(PARALLEL_WRITES,
                                                   thread_name_prefix=f"{self.name}-write")
            pool = self._writers
        errors = [f.exception() for f in [pool.submit(w) for w in writes]]
        err = next((e for e in errors if e is not None), None)
        if err is not None:
            raise err

    def stop(self) -> None:
        super().stop()
        with self._writers_mu:
            if self._writers is not None:
                self._writers.shutdown(wait=True)
                self._writers = None

    def _create_pod(self, rs: api.ReplicaSet, name: str) -> None:
        pod = api.Pod(
            meta=ObjectMeta(
                name=name,
                namespace=rs.meta.namespace,
                labels=dict(rs.template.labels),
                owner_references=[
                    OwnerReference(kind=self.KIND, name=rs.meta.name, uid=rs.meta.uid, controller=True)
                ],
            ),
            spec=api.PodSpec.from_dict(rs.template.spec.to_dict()),
        )
        try:
            self.clientset.pods.create(pod)
        except AlreadyExistsError:
            self.expectations.observe_create(rs.meta.key)


class ReplicationControllerController(ReplicaSetController):
    """``pkg/controller/replication``: identical reconcile over the RC
    kind (map selector; ``ReplicationController.selector`` adapts)."""

    name = "replication"
    KIND = "ReplicationController"
