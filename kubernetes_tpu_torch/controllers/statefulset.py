"""StatefulSet controller: ordered, identity-preserving replicas.

Capability of ``pkg/controller/statefulset/stateful_set.go`` (+
``stateful_set_control.go``): pods are named ``<set>-<ordinal>``; with the
default OrderedReady policy, ordinal N is created only after 0..N-1 are
Running, scale-down removes the highest ordinal first and one at a time,
and RollingUpdate replaces outdated pods from the highest ordinal down
(respecting ``partition``)."""

from __future__ import annotations

import re

from ..api import types as api
from ..api.apps import StatefulSet
from ..api.meta import ObjectMeta, OwnerReference
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller
from .deployment import template_hash

HASH_LABEL = "pod-template-hash"


def ordinal_of(set_name: str, pod_name: str) -> int | None:
    m = re.fullmatch(re.escape(set_name) + r"-(\d+)", pod_name)
    return int(m.group(1)) if m else None


class StatefulSetController(Controller):
    name = "statefulset"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("StatefulSet")
        from ..client.informer import Handler, PodOwnerIndex

        self.pod_index = PodOwnerIndex(self.informers.informer("Pod"))
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._pod_event,
            on_update=lambda old, new: self._pod_event(new),
            on_delete=self._pod_event,
        ))

    def _pod_event(self, pod: api.Pod) -> None:
        ref = pod.meta.controller_ref()
        if ref is not None and ref.kind == "StatefulSet":
            self.queue.add(f"{pod.meta.namespace}/{ref.name}")

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            ss = self.clientset.statefulsets.get(name, namespace)
        except NotFoundError:
            return
        owned = {}
        for p in self.pod_index.owned_by(ss.meta.uid):
            if p.meta.namespace != namespace:
                continue
            o = ordinal_of(name, p.meta.name)
            if o is not None:
                owned[o] = p

        want_hash = template_hash(ss.template)
        ordered = ss.pod_management_policy == "OrderedReady"

        # -- replace failed replicas (stateful_set_control.go: failed pods
        # are deleted and recreated with the same identity) ------------------
        for o in list(owned):
            if owned[o].status.phase in (api.FAILED, api.SUCCEEDED):
                self._delete_pod(owned[o])
                del owned[o]

        # -- scale up: create missing ordinals [0, replicas) -----------------
        created_blocking = False
        for i in range(ss.replicas):
            if i in owned:
                if ordered and owned[i].status.phase != api.RUNNING:
                    created_blocking = True  # wait for this ordinal first
                    break
                continue
            self._create_pod(ss, i, want_hash)
            created_blocking = True
            if ordered:
                break  # one at a time, wait for Running
        # -- scale down: delete highest ordinal first ------------------------
        extra = sorted((o for o in owned if o >= ss.replicas), reverse=True)
        if extra and not created_blocking:
            victims = extra if not ordered else extra[:1]
            for o in victims:
                self._delete_pod(owned[o])

        # -- rolling update: replace outdated, highest ordinal first ---------
        if (
            ss.update_strategy == "RollingUpdate"
            and not created_blocking
            and not extra
            and all(owned[o].status.phase == api.RUNNING
                    for o in owned if o < ss.replicas)
        ):
            for o in sorted((o for o in owned if o < ss.replicas), reverse=True):
                if o < ss.partition:
                    continue
                if owned[o].meta.labels.get(HASH_LABEL) != want_hash:
                    # delete; the next sync recreates the ordinal with the
                    # new template (identity preserved through the name)
                    self._delete_pod(owned[o])
                    break  # one at a time

        in_range = [owned[o] for o in owned if o < ss.replicas]
        ready = sum(1 for p in in_range if p.status.phase == api.RUNNING)
        updated = sum(1 for p in in_range if p.meta.labels.get(HASH_LABEL) == want_hash)

        def _status(cur: StatefulSet) -> StatefulSet:
            cur.status_replicas = len(in_range)
            cur.status_ready_replicas = ready
            cur.status_current_replicas = len(in_range)
            cur.status_updated_replicas = updated
            cur.status_observed_generation = cur.meta.generation
            return cur

        self.clientset.statefulsets.guaranteed_update(name, _status, namespace)

    def _create_pod(self, ss: StatefulSet, ordinal: int, want_hash: str) -> None:
        labels = dict(ss.template.labels)
        labels[HASH_LABEL] = want_hash
        labels["statefulset.kubernetes.io/pod-name"] = f"{ss.meta.name}-{ordinal}"
        pod = api.Pod(
            meta=ObjectMeta(
                name=f"{ss.meta.name}-{ordinal}",
                namespace=ss.meta.namespace,
                labels=labels,
                owner_references=[OwnerReference(
                    kind="StatefulSet", name=ss.meta.name, uid=ss.meta.uid, controller=True)],
            ),
            spec=api.PodSpec.from_dict(ss.template.spec.to_dict()),
        )
        try:
            self.clientset.pods.create(pod)
        except AlreadyExistsError:
            pass

    def _delete_pod(self, pod: api.Pod) -> None:
        try:
            self.clientset.pods.delete(pod.meta.name, pod.meta.namespace)
        except NotFoundError:
            pass
