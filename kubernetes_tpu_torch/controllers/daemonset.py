"""DaemonSet controller: one pod per matching node.

Capability of ``pkg/controller/daemon/daemoncontroller.go`` (1,971 LoC).
Distinctive reference behavior reproduced here: the daemon controller does
its OWN scheduling — it imports the scheduler's predicates
(``daemoncontroller.go`` nodeShouldRunDaemonPod runs GeneralPredicates +
taint checks against a simulated pod) and writes ``spec.nodeName``
directly instead of leaving pods to the scheduler.  RollingUpdate deletes
up to ``maxUnavailable`` outdated pods per sync; their replacements are
created with the new template on the next pass."""

from __future__ import annotations

from ..api import types as api
from ..api.apps import DaemonSet
from ..api.meta import ObjectMeta, OwnerReference
from ..scheduler.nodeinfo import NodeInfo
from ..scheduler.predicates import (
    PredicateContext,
    compute_metadata,
    general_predicates,
    pod_fits_on_node,
    pod_tolerates_node_taints,
)
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller
from .deployment import template_hash

# the subset the reference's nodeShouldRunDaemonPod evaluates
_DAEMON_PREDICATES = {
    "GeneralPredicates": general_predicates,
    "PodToleratesNodeTaints": pod_tolerates_node_taints,
}

HASH_LABEL = "pod-template-hash"


class DaemonSetController(Controller):
    name = "daemonset"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("DaemonSet")
        self.watch("Node", key_fn=lambda node: self._all_ds_keys())
        from ..client.informer import Handler, PodOwnerIndex

        self.pod_index = PodOwnerIndex(self.informers.informer("Pod"))
        self.informers.informer("Pod").add_handler(Handler(
            on_add=self._pod_event,
            on_update=lambda old, new: self._pod_event(new),
            on_delete=self._pod_event,
        ))

    def _all_ds_keys(self):
        for ds in self.informer("DaemonSet").list():
            self.queue.add(ds.meta.key)
        return None  # keys already enqueued

    def _pod_event(self, pod: api.Pod) -> None:
        ref = pod.meta.controller_ref()
        if ref is not None and ref.kind == "DaemonSet":
            self.queue.add(f"{pod.meta.namespace}/{ref.name}")

    # -- scheduling check --------------------------------------------------
    def _node_should_run(self, ds: DaemonSet, node: api.Node,
                         node_infos: dict[str, NodeInfo]) -> bool:
        if node.spec.unschedulable:
            # daemon pods ignore unschedulable (reference: they tolerate it)
            pass
        sim = self._new_pod(ds, node.meta.name, persist=False)
        info = node_infos.get(node.meta.name) or NodeInfo(node)
        ctx = PredicateContext(node_infos)
        meta = compute_metadata(sim, ctx)
        ok, _ = pod_fits_on_node(sim, meta, info, ctx, predicates=_DAEMON_PREDICATES)
        return ok

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            ds = self.clientset.daemonsets.get(name, namespace)
        except NotFoundError:
            return
        nodes, _ = self.clientset.nodes.list()
        # node -> NodeInfo with current pods for the resource-fit check,
        # EXCLUDING this DaemonSet's own pods — simulating the daemon pod on
        # a node that already runs it must not fail the fit and evict the
        # healthy pod (reference daemoncontroller.go simulate())
        node_infos: dict[str, NodeInfo] = {n.meta.name: NodeInfo(n) for n in nodes}
        for p in self.clientset.pods.list(None)[0]:
            ref = p.meta.controller_ref()
            if ref is not None and ref.kind == "DaemonSet" and ref.uid == ds.meta.uid:
                continue
            if p.spec.node_name in node_infos and p.status.phase not in (api.SUCCEEDED, api.FAILED):
                node_infos[p.spec.node_name].add_pod(p)

        owned = [p for p in self.pod_index.owned_by(ds.meta.uid)
                 if p.meta.namespace == namespace
                 and p.status.phase not in (api.SUCCEEDED, api.FAILED)]
        by_node: dict[str, list[api.Pod]] = {}
        for p in owned:
            by_node.setdefault(p.spec.node_name, []).append(p)

        want_hash = template_hash(ds.template)
        desired = current = ready = updated = mis = 0
        to_delete: list[api.Pod] = []
        outdated: list[api.Pod] = []

        for node in nodes:
            should = self._node_should_run(ds, node, node_infos)
            have = by_node.pop(node.meta.name, [])
            if should:
                desired += 1
                if not have:
                    self._create_pod(ds, node.meta.name, want_hash)
                    continue
                current += 1
                keep, extra = have[0], have[1:]
                to_delete.extend(extra)  # duplicates on one node
                if keep.status.phase == api.RUNNING:
                    ready += 1
                if keep.meta.labels.get(HASH_LABEL) == want_hash:
                    updated += 1
                else:
                    outdated.append(keep)
            else:
                mis += len(have)
                to_delete.extend(have)

        # pods on nodes that no longer exist
        for orphan_pods in by_node.values():
            to_delete.extend(orphan_pods)

        if ds.update_strategy == "RollingUpdate":
            # deletion budget = maxUnavailable minus already-unavailable
            # daemons (reference rollingUpdate.go getUnavailableNumbers):
            # never take down more than maxUnavailable nodes at once
            unavailable = desired - ready
            budget = max(0, ds.max_unavailable - unavailable)
            to_delete.extend(outdated[:budget])
        for p in to_delete:
            try:
                self.clientset.pods.delete(p.meta.name, p.meta.namespace)
            except NotFoundError:
                pass

        def _status(cur: DaemonSet) -> DaemonSet:
            cur.status_desired = desired
            cur.status_current = current
            cur.status_ready = ready
            cur.status_updated = updated
            cur.status_mis_scheduled = mis
            return cur

        self.clientset.daemonsets.guaranteed_update(name, _status, namespace)

    def _new_pod(self, ds: DaemonSet, node_name: str, persist: bool, want_hash: str = "") -> api.Pod:
        labels = dict(ds.template.labels)
        if want_hash:
            labels[HASH_LABEL] = want_hash
        spec = api.PodSpec.from_dict(ds.template.spec.to_dict())
        spec.node_name = node_name
        return api.Pod(
            meta=ObjectMeta(
                name=f"{ds.meta.name}-{node_name}",
                namespace=ds.meta.namespace,
                labels=labels,
                owner_references=[OwnerReference(
                    kind="DaemonSet", name=ds.meta.name, uid=ds.meta.uid, controller=True)],
            ),
            spec=spec,
        )

    def _create_pod(self, ds: DaemonSet, node_name: str, want_hash: str) -> None:
        try:
            self.clientset.pods.create(self._new_pod(ds, node_name, persist=True, want_hash=want_hash))
        except AlreadyExistsError:
            pass
