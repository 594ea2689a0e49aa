"""Job controller: run pods to completion.

Capability of ``pkg/controller/job/jobcontroller.go`` (741 LoC):
``syncJob`` counts active/succeeded/failed pods owned by the Job, creates
up to ``parallelism`` active pods while fewer than ``completions`` have
succeeded, marks the Complete condition when done, and the Failed
condition when ``backoffLimit`` restarts are exhausted or
``activeDeadlineSeconds`` passes (measured from the Job's creation using
the controller's injected clock)."""

from __future__ import annotations

import itertools

from ..api import types as api
from ..api.apps import Job
from ..api.meta import ObjectMeta, OwnerReference
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller
from .replicaset import Expectations

_suffix = itertools.count(1)


class JobController(Controller):
    name = "job"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.expectations = Expectations()
        self.watch("Job")
        from ..client.informer import Handler, PodOwnerIndex

        self.pod_index = PodOwnerIndex(self.informers.informer("Pod"))
        self.informers.informer("Pod").add_handler(Handler(
            on_add=lambda pod: self._pod_event(pod, "add"),
            on_update=lambda old, new: self._pod_event(new, "update"),
            on_delete=lambda pod: self._pod_event(pod, "delete"),
        ))

    def _pod_event(self, pod: api.Pod, event: str) -> None:
        ref = pod.meta.controller_ref()
        if ref is None or ref.kind != "Job":
            return
        key = f"{pod.meta.namespace}/{ref.name}"
        if event == "add":
            self.expectations.observe_create(key)
        elif event == "delete":
            self.expectations.observe_delete(key)
        self.queue.add(key)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            job = self.clientset.jobs.get(name, namespace)
        except NotFoundError:
            self.expectations.forget(key)
            return
        if job.complete or job.failed:
            return
        if not self.expectations.satisfied(key):
            return
        # persist startTime so the deadline survives controller restarts
        # (reference jobcontroller.go sets job.Status.StartTime once)
        if not job.status_start_time:
            start = self.clock()

            def _stamp(cur: Job) -> Job:
                if not cur.status_start_time:
                    cur.status_start_time = start
                return cur

            job = self.clientset.jobs.guaranteed_update(name, _stamp, namespace)

        owned = [p for p in self.pod_index.owned_by(job.meta.uid)
                 if p.meta.namespace == namespace]
        active = [p for p in owned if p.status.phase in (api.PENDING, api.RUNNING)]
        succeeded = sum(1 for p in owned if p.status.phase == api.SUCCEEDED)
        failed = sum(1 for p in owned if p.status.phase == api.FAILED)

        conditions = list(job.status_conditions)
        deadline_exceeded = (
            job.active_deadline_seconds is not None
            and self.clock() - job.status_start_time >= job.active_deadline_seconds
        )
        if failed > job.backoff_limit or deadline_exceeded:
            reason = "DeadlineExceeded" if deadline_exceeded else "BackoffLimitExceeded"
            conditions.append({"type": "Failed", "status": "True", "reason": reason})
            for p in active:  # kill remaining pods on failure
                try:
                    self.clientset.pods.delete(p.meta.name, namespace)
                except NotFoundError:
                    pass
            active = []
        elif self._done(job, succeeded):
            conditions.append({"type": "Complete", "status": "True"})
        else:
            want_active = self._wanted_active(job, succeeded)
            diff = want_active - len(active)
            if diff > 0:
                self.expectations.expect(key, diff, 0)
                for _ in range(diff):
                    self._create_pod(job)
            elif diff < 0:
                victims = sorted(active, key=lambda p: (bool(p.spec.node_name), p.meta.name))[:-diff]
                self.expectations.expect(key, 0, len(victims))
                for p in victims:
                    try:
                        self.clientset.pods.delete(p.meta.name, namespace)
                    except NotFoundError:
                        self.expectations.observe_delete(key)

        def _status(cur: Job) -> Job:
            cur.status_active = len(active)
            cur.status_succeeded = succeeded
            cur.status_failed = failed
            cur.status_conditions = conditions
            return cur

        self.clientset.jobs.guaranteed_update(name, _status, namespace)

    def _done(self, job: Job, succeeded: int) -> bool:
        if job.completions is None:
            # work-queue style: done when any pod succeeded
            return succeeded > 0
        return succeeded >= job.completions

    def _wanted_active(self, job: Job, succeeded: int) -> int:
        if job.completions is None:
            return job.parallelism
        return min(job.parallelism, max(0, job.completions - succeeded))

    def _create_pod(self, job: Job) -> None:
        spec = api.PodSpec.from_dict(job.template.spec.to_dict())
        if spec.restart_policy == "Always":
            spec.restart_policy = "OnFailure"  # jobs never restart-forever
        pod = api.Pod(
            meta=ObjectMeta(
                name=f"{job.meta.name}-{next(_suffix):06d}",
                namespace=job.meta.namespace,
                labels=dict(job.template.labels),
                owner_references=[OwnerReference(
                    kind="Job", name=job.meta.name, uid=job.meta.uid, controller=True)],
            ),
            spec=spec,
        )
        try:
            self.clientset.pods.create(pod)
        except AlreadyExistsError:
            self.expectations.observe_create(job.meta.key)
