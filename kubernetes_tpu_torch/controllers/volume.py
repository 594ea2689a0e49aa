"""Volume lifecycle controllers: PV↔PVC binding + attach/detach.

Capability of ``pkg/controller/volume`` (5,517 LoC):

- ``PersistentVolumeController`` — the claim↔volume binder
  (``persistentvolume/pv_controller.go`` / ``pv_controller_base.go``):
  a phase machine driving PVCs Pending→Bound(→Lost) and PVs
  Available→Bound→Released(→deleted/Available), with best-match binding
  (smallest satisfying volume), pre-binding via ``claim.volume_name``,
  dynamic provisioning through StorageClass provisioners, and the
  Retain/Delete/Recycle reclaim policies.

- ``AttachDetachController`` — the desired-vs-actual attachment
  reconciler (``attachdetach/attach_detach_controller.go``): computes
  which bound PVs each node needs from the pods scheduled there and
  writes ``node.status.volumesAttached``; volumes no longer used by any
  pod on the node are detached.

Both are standard informer→workqueue→sync loops (SURVEY.md §2.5 / P3).
"""

from __future__ import annotations

from ..api import types as api
from ..api.types import PersistentVolume, PersistentVolumeClaim
from ..store.store import ConflictError, NotFoundError
from .base import Controller


def _modes_satisfied(want: list[str], have: list[str]) -> bool:
    return set(want) <= set(have)


class _VolumeTakenError(Exception):
    """Bind raced another claim to the same PV; the loser stays Pending."""


class PersistentVolumeController(Controller):
    """Reference ``pv_controller.go``: syncClaim/syncVolume phase machine."""

    name = "persistentvolume"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        # claims drive binding; volume/class churn re-syncs affected claims
        self.watch("PersistentVolumeClaim")
        self.watch("PersistentVolume", key_fn=self._volume_key)
        self.watch("StorageClass", key_fn=self._class_key)

    def _requeue_pending_claims(self) -> None:
        for pvc in self.informer("PersistentVolumeClaim").list():
            if pvc.phase == "Pending":
                self.queue.add(pvc.meta.key)

    def _volume_key(self, pv: PersistentVolume):
        # a PV event re-syncs its bound claim if any, else all pending claims
        # get a chance to bind to it (cheap at control-plane scale)
        if pv.claim_ref:
            return pv.claim_ref
        self._requeue_pending_claims()
        return f"\x00volume/{pv.meta.name}"

    def _class_key(self, sc):
        # a class appearing/changing may unblock provisioning of any
        # pending claim naming it (or none, for the default class)
        self._requeue_pending_claims()
        return None

    # -- claim side --------------------------------------------------------
    def sync(self, key: str) -> None:
        if key.startswith("\x00volume/"):
            self._sync_volume(key.split("/", 1)[1])
            return
        namespace, name = key.split("/", 1)
        try:
            pvc = self.clientset.persistentvolumeclaims.get(name, namespace)
        except NotFoundError:
            # deleted claim: release any PV still pointing at it
            self._release_volumes_of(f"{namespace}/{name}")
            return
        if pvc.phase == "Bound":
            self._check_bound(pvc)
        else:
            self._bind_pending(pvc)

    def _bind_pending(self, pvc: PersistentVolumeClaim) -> None:
        pvs = self.clientset.persistentvolumes.list()[0]
        match = None
        if pvc.volume_name:
            # pre-bound claim (reference: claim.Spec.VolumeName set by user)
            match = next((pv for pv in pvs if pv.meta.name == pvc.volume_name), None)
            if match is None or (match.claim_ref and match.claim_ref != pvc.meta.key):
                return  # wait for the named volume
        else:
            # smallest satisfying Available volume of the same class
            candidates = [
                pv
                for pv in pvs
                if pv.phase == "Available"
                and not pv.claim_ref
                and pv.storage_class == pvc.storage_class
                and _modes_satisfied(pvc.access_modes, pv.access_modes)
                and pv.capacity.get("storage", api.Quantity(0)) >= pvc.request_storage
            ]
            if candidates:
                match = min(candidates, key=lambda pv: pv.capacity.get("storage", api.Quantity(0)))
        if match is None:
            match = self._provision(pvc)
        if match is None:
            return  # stays Pending; a future PV/class event re-queues
        self._bind(pvc, match)

    def _provision(self, pvc: PersistentVolumeClaim):
        """Dynamic provisioning (reference ``pv_controller.go
        provisionClaim``): a StorageClass with a provisioner mints a PV
        sized to the request.  A claim naming no class uses the default
        class (reference: the DefaultStorageClass admission plugin)."""
        classes = self.clientset.storageclasses.list()[0]
        if pvc.storage_class:
            sc = next((c for c in classes if c.meta.name == pvc.storage_class), None)
        else:
            sc = next((c for c in classes if c.is_default), None)
        if sc is None or not sc.provisioner:
            return None
        name = f"pvc-{pvc.meta.namespace}-{pvc.meta.name}"
        pv = PersistentVolume(
            meta=api.ObjectMeta(name=name, annotations={"pv.kubernetes.io/provisioned-by": sc.provisioner}),
            capacity={"storage": pvc.request_storage},
            access_modes=list(pvc.access_modes),
            storage_class=pvc.storage_class or sc.meta.name,
            reclaim_policy=sc.reclaim_policy,
            phase="Available",
        )
        try:
            return self.clientset.persistentvolumes.create(pv)
        except ConflictError:
            # name collision ("a-b"/"c" vs "a"/"b-c") or an idempotent
            # re-provision: reuse only a PV that is ours or unclaimed
            existing = self.clientset.persistentvolumes.get(name)
            if existing.claim_ref in ("", pvc.meta.key):
                return existing
            return None

    def _bind(self, pvc: PersistentVolumeClaim, pv: PersistentVolume) -> None:
        claim_key = pvc.meta.key

        def _set_pv(cur: PersistentVolume) -> PersistentVolume:
            if cur.claim_ref not in ("", claim_key):
                # lost the race to another claim (reference syncUnboundClaim
                # re-verifies claimRef before binding)
                raise _VolumeTakenError(cur.meta.name)
            cur.claim_ref = claim_key
            cur.phase = "Bound"
            return cur

        try:
            self.clientset.persistentvolumes.guaranteed_update(pv.meta.name, _set_pv)
        except _VolumeTakenError:
            return  # claim stays Pending; next PV event retries

        def _set_pvc(cur: PersistentVolumeClaim) -> PersistentVolumeClaim:
            cur.volume_name = pv.meta.name
            cur.phase = "Bound"
            return cur

        self.clientset.persistentvolumeclaims.guaranteed_update(
            pvc.meta.name, _set_pvc, pvc.meta.namespace
        )

    def _check_bound(self, pvc: PersistentVolumeClaim) -> None:
        """Bound claim whose PV vanished goes Lost (reference
        syncClaim's bound-claim verification)."""
        try:
            pv = self.clientset.persistentvolumes.get(pvc.volume_name)
        except NotFoundError:
            pv = None
        if pv is None or pv.claim_ref != pvc.meta.key:
            def _lost(cur: PersistentVolumeClaim) -> PersistentVolumeClaim:
                cur.phase = "Lost"
                return cur

            self.clientset.persistentvolumeclaims.guaranteed_update(
                pvc.meta.name, _lost, pvc.meta.namespace
            )

    # -- volume side -------------------------------------------------------
    def _release_volumes_of(self, claim_key: str) -> None:
        for pv in self.clientset.persistentvolumes.list()[0]:
            if pv.claim_ref == claim_key:
                self._sync_volume(pv.meta.name)

    def _sync_volume(self, name: str) -> None:
        try:
            pv = self.clientset.persistentvolumes.get(name)
        except NotFoundError:
            return
        if not pv.claim_ref:
            return
        try:
            ns, claim_name = pv.claim_ref.split("/", 1)
            pvc = self.clientset.persistentvolumeclaims.get(claim_name, ns)
        except (NotFoundError, ValueError):
            pvc = None
        if pvc is not None and pvc.volume_name in ("", pv.meta.name):
            return  # claim still around (or pre-bind in progress): nothing to do
        # claim gone: apply the reclaim policy (reference reclaimVolume)
        if pv.reclaim_policy == "Delete":
            try:
                self.clientset.persistentvolumes.delete(pv.meta.name)
            except NotFoundError:
                pass
            return
        def _reclaim(cur: PersistentVolume) -> PersistentVolume:
            if cur.reclaim_policy == "Recycle":
                cur.claim_ref = ""
                cur.phase = "Available"
            else:  # Retain
                cur.phase = "Released"
            return cur

        self.clientset.persistentvolumes.guaranteed_update(pv.meta.name, _reclaim)


class AttachDetachController(Controller):
    """Reference ``attachdetach``: desired attachments per node from the
    scheduled pods' bound claims; actual = node.status.volumesAttached.

    The node comes from the Node informer's cache and a node's pods from
    a by-node index over the Pod informer (the reference's listers); the
    JAX controller GETs the node over the wire and walks every pod of the
    cluster on each node update."""

    name = "attachdetach"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        from ..client.informer import PodNodeIndex

        self._pod_index = PodNodeIndex(self.informers.informer("Pod"))
        self.watch("Node")
        self.watch("Pod", key_fn=self._pod_key)
        self.watch("PersistentVolumeClaim", key_fn=self._claim_key)

    def _pod_key(self, pod: api.Pod):
        return pod.spec.node_name or None  # only scheduled pods matter

    def _claim_key(self, pvc: PersistentVolumeClaim):
        # a claim binding/unbinding changes the desired set of every node
        # running a pod that references it
        for pod in self.informer("Pod").list():
            if not pod.spec.node_name:
                continue
            if pod.meta.namespace == pvc.meta.namespace and any(
                vol.pvc_name == pvc.meta.name for vol in pod.spec.volumes
            ):
                self.queue.add(pod.spec.node_name)
        return None

    def _desired_for(self, node_name: str) -> list[str]:
        pvcs = {c.meta.key: c for c in self.informer("PersistentVolumeClaim").list()}
        want: list[str] = []
        for pod in sorted(self._pod_index.pods_on(node_name), key=lambda p: p.meta.key):
            if pod.status.phase in (api.SUCCEEDED, api.FAILED):
                continue
            for vol in pod.spec.volumes:
                if not vol.pvc_name:
                    continue
                pvc = pvcs.get(f"{pod.meta.namespace}/{vol.pvc_name}")
                if pvc is not None and pvc.phase == "Bound" and pvc.volume_name:
                    if pvc.volume_name not in want:
                        want.append(pvc.volume_name)
        return sorted(want)

    def sync(self, key: str) -> None:
        node = self.informer("Node").get(key)
        if node is None:
            return
        desired = self._desired_for(key)
        # unmount-before-detach (the reference reconciler consults
        # node.status.volumesInUse): a volume the kubelet still has
        # mounted stays attached even when no pod wants it anymore
        in_use = set(node.status.volumes_in_use)
        keep = [v for v in node.status.volumes_attached
                if v in in_use and v not in desired]
        want = sorted(set(desired) | set(keep))
        if sorted(node.status.volumes_attached) == want:
            return

        def _set(cur: api.Node) -> api.Node:
            cur.status.volumes_attached = list(want)
            return cur

        try:
            self.clientset.nodes.guaranteed_update(key, _set)
        except NotFoundError:
            pass
