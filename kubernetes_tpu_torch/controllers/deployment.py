"""Deployment controller: declarative rollouts over ReplicaSets.

Capability of ``pkg/controller/deployment`` (3,175 LoC;
``syncDeployment :559``, strategies in ``rolling.go``/``sync.go``):

- one ReplicaSet per pod-template hash; template change → new RS;
- RollingUpdate: scale the new RS up and old RSes down within
  maxSurge/maxUnavailable; Recreate: old to zero first, then new up;
- status aggregation (replicas/updated/ready/observedGeneration).

Rollback = applying an old template again (hash matches the old RS, which
becomes "new" — the reference models it the same way, ``rollback.go``).
"""

from __future__ import annotations

import hashlib
import json

from ..api import types as api
from ..api.meta import ObjectMeta, OwnerReference
from ..store.store import AlreadyExistsError
from .base import Controller


def template_hash(template: api.PodTemplateSpec) -> str:
    payload = json.dumps(template.to_dict(), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:10]


class DeploymentController(Controller):
    name = "deployment"
    REVISION_ANNOTATION = api.DEPLOYMENT_REVISION_ANNOTATION

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("Deployment")
        self.watch("ReplicaSet", key_fn=self._dep_key_for_rs)

    def _dep_key_for_rs(self, rs: api.ReplicaSet):
        ref = rs.meta.controller_ref()
        if ref is not None and ref.kind == "Deployment":
            return f"{rs.meta.namespace}/{ref.name}"
        return None

    # -- helpers -----------------------------------------------------------
    def _owned_rses(self, dep: api.Deployment) -> list[api.ReplicaSet]:
        out = []
        for rs in self.informer("ReplicaSet").list():
            ref = rs.meta.controller_ref()
            if (
                rs.meta.namespace == dep.meta.namespace
                and ref is not None
                and ref.kind == "Deployment"
                and ref.uid == dep.meta.uid
            ):
                out.append(rs)
        return out

    def _new_rs(self, dep: api.Deployment, rses: list[api.ReplicaSet]):
        want = template_hash(dep.template)
        for rs in rses:
            if rs.meta.labels.get("pod-template-hash") == want:
                return rs
        return None

    def _create_new_rs(self, dep: api.Deployment, replicas: int,
                       rses: list[api.ReplicaSet]) -> api.ReplicaSet:
        h = template_hash(dep.template)
        next_rev = 1 + max(
            (
                int(rs.meta.annotations.get(self.REVISION_ANNOTATION, "0"))
                for rs in rses
            ),
            default=0,
        )
        labels = dict(dep.template.labels)
        labels["pod-template-hash"] = h
        template = api.PodTemplateSpec(labels=labels, spec=api.PodSpec.from_dict(dep.template.spec.to_dict()))
        selector = api.LabelSelector.from_dict(dep.selector.to_dict())
        selector.match_labels["pod-template-hash"] = h
        rs = api.ReplicaSet(
            meta=ObjectMeta(
                name=f"{dep.meta.name}-{h}",
                namespace=dep.meta.namespace,
                labels=labels,
                annotations={self.REVISION_ANNOTATION: str(next_rev)},
                owner_references=[
                    OwnerReference(kind="Deployment", name=dep.meta.name, uid=dep.meta.uid, controller=True)
                ],
            ),
            replicas=replicas,
            selector=selector,
            template=template,
        )
        try:
            return self.clientset.replicasets.create(rs)
        except AlreadyExistsError:
            return self.clientset.replicasets.get(rs.meta.name, rs.meta.namespace)

    def _ensure_revision(self, new_rs, rses: list[api.ReplicaSet]) -> None:
        """The reference's revision bookkeeping (``deployment/sync.go``
        getNewReplicaSet): the RS matching the current template carries the
        HIGHEST revision; re-applying an old template (rollback-by-reapply)
        bumps that RS's revision rather than minting a new RS — rollout
        history/undo read these annotations."""
        revisions = [
            int(rs.meta.annotations.get(self.REVISION_ANNOTATION, "0")) for rs in rses
        ]
        max_rev = max(revisions, default=0)
        if new_rs is None:
            return  # _create_new_rs stamps max+1
        cur = int(new_rs.meta.annotations.get(self.REVISION_ANNOTATION, "0"))
        if cur == max_rev and cur != 0:
            return

        def _stamp(r: api.ReplicaSet) -> api.ReplicaSet:
            r.meta.annotations[self.REVISION_ANNOTATION] = str(max_rev + 1)
            return r

        self.clientset.replicasets.guaranteed_update(
            new_rs.meta.name, _stamp, new_rs.meta.namespace
        )

    def _scale_rs(self, rs: api.ReplicaSet, replicas: int) -> None:
        if rs.replicas == replicas:
            return

        def _scale(cur: api.ReplicaSet) -> api.ReplicaSet:
            cur.replicas = replicas
            return cur

        self.clientset.replicasets.guaranteed_update(rs.meta.name, _scale, rs.meta.namespace)

    # -- reconcile ---------------------------------------------------------
    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        # the informer's copy (the reference's lister): a sync follows each
        # status change of an owned ReplicaSet, and the JAX controller GETs
        # the Deployment over the wire
        dep = self.informer("Deployment").get(key)
        if dep is None:
            return
        rses = self._owned_rses(dep)
        new_rs = self._new_rs(dep, rses)
        self._ensure_revision(new_rs, rses)
        old_rses = [rs for rs in rses if new_rs is None or rs.meta.uid != new_rs.meta.uid]
        old_total = sum(rs.replicas for rs in old_rses)

        if dep.paused:
            # rollout pause (deployment/sync.go): SCALE still reconciles,
            # the rollout does not — no new RS for a template change, no
            # old→new shifting.  The delta lands on the newest RS (the
            # single-RS steady state is the dominant paused case).
            if rses:
                total = sum(rs.replicas for rs in rses)
                if total != dep.replicas:
                    newest = max(
                        rses,
                        key=lambda rs: int(rs.meta.annotations.get(
                            self.REVISION_ANNOTATION, "0") or 0))
                    self._scale_rs(
                        newest,
                        max(0, newest.replicas + dep.replicas - total))
        elif dep.strategy == "Recreate":
            for rs in old_rses:
                self._scale_rs(rs, 0)
            old_active = sum(rs.status_replicas for rs in old_rses)
            if old_active == 0:
                if new_rs is None:
                    new_rs = self._create_new_rs(dep, dep.replicas, rses)
                self._scale_rs(new_rs, dep.replicas)
        else:  # RollingUpdate
            if new_rs is None:
                # surge head-room for the first step of the rollout
                initial = max(min(dep.replicas, dep.replicas + dep.max_surge - old_total), 0)
                new_rs = self._create_new_rs(dep, initial, rses)
            else:
                # scale new up within maxSurge
                max_total = dep.replicas + dep.max_surge
                allowed_up = max(max_total - (old_total + new_rs.replicas), 0)
                want_new = min(new_rs.replicas + allowed_up, dep.replicas)
                if want_new != new_rs.replicas:
                    self._scale_rs(new_rs, want_new)
                # scale old down within maxUnavailable, counting only READY
                # new replicas as available coverage
                min_available = dep.replicas - dep.max_unavailable
                available = new_rs.status_ready_replicas + sum(
                    rs.status_ready_replicas for rs in old_rses
                )
                can_remove = max(available - min_available, 0)
                for rs in sorted(old_rses, key=lambda r: r.meta.name):
                    if can_remove <= 0:
                        break
                    step = min(rs.replicas, can_remove)
                    if step > 0:
                        self._scale_rs(rs, rs.replicas - step)
                        can_remove -= step

        # status
        all_rses = self._owned_rses(dep)
        new_rs_now = self._new_rs(dep, all_rses)
        total = sum(rs.status_replicas for rs in all_rses)
        ready = sum(rs.status_ready_replicas for rs in all_rses)
        updated = new_rs_now.status_replicas if new_rs_now else 0
        if (
            dep.status_replicas != total
            or dep.status_ready_replicas != ready
            or dep.status_updated_replicas != updated
            or dep.status_observed_generation != dep.meta.generation
        ):
            def _status(cur: api.Deployment) -> api.Deployment:
                cur.status_replicas = total
                cur.status_ready_replicas = ready
                cur.status_updated_replicas = updated
                cur.status_observed_generation = cur.meta.generation
                return cur

            self.clientset.deployments.guaranteed_update(name, _status, namespace)
