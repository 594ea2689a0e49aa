"""CronJob controller: create Jobs on a cron schedule.

Capability of ``pkg/controller/cronjob/cronjob_controller.go`` (935 LoC).
The reference polls every 10s rather than watching; here the controller is
level-triggered the same way — ``tick()`` (or a queued sync) evaluates
every CronJob against the injected clock, creates Jobs for unmet schedule
times, applies the concurrency policy, and prunes finished Jobs beyond the
history limits."""

from __future__ import annotations

from ..api.apps import CronJob, Job
from ..api.meta import ObjectMeta, OwnerReference
from ..api.selectors import LabelSelector
from ..api.types import PodTemplateSpec
from ..store.store import AlreadyExistsError, NotFoundError
from ..utils.cron import CronSchedule
from .base import Controller


class CronJobController(Controller):
    name = "cronjob"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("CronJob")
        self.watch("Job", key_fn=self._job_owner_key)

    def _job_owner_key(self, job):
        ref = job.meta.controller_ref()
        if ref is None or ref.kind != "CronJob":
            return None
        return f"{job.meta.namespace}/{ref.name}"

    def tick(self) -> None:
        """Enqueue every CronJob (the reference's 10s ``syncAll`` poll) —
        from the informer cache, not a wire LIST per poll."""
        for cj in self.informer("CronJob").list():
            self.queue.add(cj.meta.key)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        try:
            cj = self.clientset.cronjobs.get(name, namespace)
        except NotFoundError:
            return
        if cj.suspend:
            return
        now = self.clock()
        schedule = CronSchedule.parse(cj.schedule)

        owned = [j for j in self.clientset.jobs.list(namespace)[0]
                 if any(r.kind == "CronJob" and r.uid == cj.meta.uid
                        for r in j.meta.owner_references)]
        running = [j for j in owned if not j.complete and not j.failed]

        # reconcile status.active against observed running jobs
        active_names = sorted(j.meta.name for j in running)

        last = cj.status_last_schedule_time
        if not last:
            last = now - 61.0  # first sync: look one schedule window back
        unmet = schedule.unmet_since(last, now)
        started = None
        if unmet:
            run_time = unmet[-1]  # most recent unmet time wins (reference)
            too_late = (
                cj.starting_deadline_seconds is not None
                and now - run_time > cj.starting_deadline_seconds
            )
            if not too_late:
                if running and cj.concurrency_policy == "Forbid":
                    pass  # skip this run
                else:
                    if running and cj.concurrency_policy == "Replace":
                        for j in running:
                            self._delete_job(j)
                            if j.meta.name in active_names:
                                active_names.remove(j.meta.name)
                        running = []
                    started = self._create_job(cj, run_time)
                    if started:
                        active_names.append(started)

        self._prune_history(cj, owned)

        def _status(cur: CronJob) -> CronJob:
            cur.status_active = sorted(set(active_names))
            if started is not None:
                cur.status_last_schedule_time = now
            return cur

        self.clientset.cronjobs.guaranteed_update(name, _status, namespace)

    def _create_job(self, cj: CronJob, run_time: float) -> str | None:
        tpl = cj.job_template or {}
        # deterministic name from the scheduled minute (reference
        # getJobFromTemplate: <cronjob>-<minute-epoch>)
        job_name = f"{cj.meta.name}-{int(run_time) // 60}"
        job = Job(
            meta=ObjectMeta(
                name=job_name,
                namespace=cj.meta.namespace,
                labels=dict((tpl.get("labels") or {}) or cj.meta.labels),
                owner_references=[OwnerReference(
                    kind="CronJob", name=cj.meta.name, uid=cj.meta.uid, controller=True)],
            ),
            parallelism=int(tpl.get("parallelism", 1)),
            completions=tpl.get("completions", 1),
            backoff_limit=int(tpl.get("backoffLimit", 6)),
            selector=LabelSelector.from_dict(tpl.get("selector")),
            template=PodTemplateSpec.from_dict(tpl.get("template")),
        )
        try:
            self.clientset.jobs.create(job)
        except AlreadyExistsError:
            return None  # this schedule time already ran
        return job_name

    def _delete_job(self, job: Job) -> None:
        try:
            self.clientset.jobs.delete(job.meta.name, job.meta.namespace)
        except NotFoundError:
            pass
        # cascade to the job's pods (the GC would also get these via
        # ownerRefs; doing it inline keeps Replace semantics immediate)
        for p in self.clientset.pods.list(job.meta.namespace)[0]:
            ref = p.meta.controller_ref()
            if ref is not None and ref.kind == "Job" and ref.name == job.meta.name:
                try:
                    self.clientset.pods.delete(p.meta.name, p.meta.namespace)
                except NotFoundError:
                    pass

    def _prune_history(self, cj: CronJob, owned: list[Job]) -> None:
        done_ok = sorted((j for j in owned if j.complete), key=lambda j: j.meta.creation_revision)
        done_bad = sorted((j for j in owned if j.failed), key=lambda j: j.meta.creation_revision)
        for j in done_ok[: max(0, len(done_ok) - cj.successful_jobs_history_limit)]:
            self._delete_job(j)
        for j in done_bad[: max(0, len(done_bad) - cj.failed_jobs_history_limit)]:
            self._delete_job(j)
