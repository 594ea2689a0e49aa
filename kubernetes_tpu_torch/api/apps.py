"""Workload API types beyond Deployment/ReplicaSet: Job, CronJob,
DaemonSet, StatefulSet.

Capability equivalents of the reference's internal types in
``pkg/apis/batch/types.go`` (Job :51, CronJob :192) and
``pkg/apis/apps/types.go`` / ``pkg/apis/extensions/types.go``
(StatefulSet, DaemonSet) at the depth the controllers reconcile.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from .meta import ObjectMeta
from .selectors import LabelSelector
from .types import PodTemplateSpec, register_kind


@register_kind
@dataclass
class Job:
    """Run-to-completion workload (reference ``pkg/apis/batch/types.go:51``,
    controller ``pkg/controller/job/jobcontroller.go``)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    parallelism: int = 1
    completions: Optional[int] = 1  # None => work-queue style
    backoff_limit: int = 6
    active_deadline_seconds: Optional[int] = None
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status_active: int = 0
    status_succeeded: int = 0
    status_failed: int = 0
    status_conditions: list[dict] = field(default_factory=list)  # Complete | Failed
    status_start_time: float = 0.0  # controller clock at first sync

    KIND = "Job"

    @property
    def complete(self) -> bool:
        return any(c.get("type") == "Complete" and c.get("status") == "True"
                   for c in self.status_conditions)

    @property
    def failed(self) -> bool:
        return any(c.get("type") == "Failed" and c.get("status") == "True"
                   for c in self.status_conditions)

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "parallelism": self.parallelism,
                "completions": self.completions,
                "backoffLimit": self.backoff_limit,
                "activeDeadlineSeconds": self.active_deadline_seconds,
                "selector": self.selector.to_dict(),
                "template": self.template.to_dict(),
            },
            "status": {
                "active": self.status_active,
                "succeeded": self.status_succeeded,
                "failed": self.status_failed,
                "conditions": list(self.status_conditions),
                "startTime": self.status_start_time,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        comp = spec.get("completions", 1)
        ads = spec.get("activeDeadlineSeconds")
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            parallelism=int(spec.get("parallelism", 1)),
            completions=None if comp is None else int(comp),
            backoff_limit=int(spec.get("backoffLimit", 6)),
            active_deadline_seconds=None if ads is None else int(ads),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            status_active=int(status.get("active", 0)),
            status_succeeded=int(status.get("succeeded", 0)),
            status_failed=int(status.get("failed", 0)),
            status_conditions=list(status.get("conditions") or []),
            status_start_time=float(status.get("startTime", 0.0)),
        )


@register_kind
@dataclass
class CronJob:
    """Time-based Job creator (reference ``pkg/apis/batch/types.go:192``
    CronJob, controller ``pkg/controller/cronjob/cronjob_controller.go``).

    ``schedule`` is a 5-field cron expression; the controller evaluates it
    against the injected clock."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    schedule: str = "* * * * *"
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    suspend: bool = False
    starting_deadline_seconds: Optional[int] = None
    job_template: Optional[dict] = None  # Job spec dict (template for spawned Jobs)
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1
    status_active: list[str] = field(default_factory=list)  # names of running Jobs
    status_last_schedule_time: float = 0.0

    KIND = "CronJob"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "schedule": self.schedule,
                "concurrencyPolicy": self.concurrency_policy,
                "suspend": self.suspend,
                "startingDeadlineSeconds": self.starting_deadline_seconds,
                "jobTemplate": copy.deepcopy(self.job_template),
                "successfulJobsHistoryLimit": self.successful_jobs_history_limit,
                "failedJobsHistoryLimit": self.failed_jobs_history_limit,
            },
            "status": {
                "active": list(self.status_active),
                "lastScheduleTime": self.status_last_schedule_time,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CronJob":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        sds = spec.get("startingDeadlineSeconds")
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            schedule=spec.get("schedule", "* * * * *"),
            concurrency_policy=spec.get("concurrencyPolicy", "Allow"),
            suspend=bool(spec.get("suspend", False)),
            starting_deadline_seconds=None if sds is None else int(sds),
            job_template=copy.deepcopy(spec.get("jobTemplate")),
            successful_jobs_history_limit=int(spec.get("successfulJobsHistoryLimit", 3)),
            failed_jobs_history_limit=int(spec.get("failedJobsHistoryLimit", 1)),
            status_active=list(status.get("active") or []),
            status_last_schedule_time=float(status.get("lastScheduleTime", 0.0)),
        )


@register_kind
@dataclass
class DaemonSet:
    """One pod per matching node (reference ``pkg/apis/extensions/types.go``
    DaemonSet; controller ``pkg/controller/daemon/daemoncontroller.go`` —
    notably it does its OWN scheduling with the scheduler's predicates)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    update_strategy: str = "RollingUpdate"  # RollingUpdate | OnDelete
    max_unavailable: int = 1
    status_desired: int = 0
    status_current: int = 0
    status_ready: int = 0
    status_updated: int = 0
    status_mis_scheduled: int = 0

    KIND = "DaemonSet"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "selector": self.selector.to_dict(),
                "template": self.template.to_dict(),
                "updateStrategy": self.update_strategy,
                "maxUnavailable": self.max_unavailable,
            },
            "status": {
                "desiredNumberScheduled": self.status_desired,
                "currentNumberScheduled": self.status_current,
                "numberReady": self.status_ready,
                "updatedNumberScheduled": self.status_updated,
                "numberMisscheduled": self.status_mis_scheduled,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DaemonSet":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            update_strategy=spec.get("updateStrategy", "RollingUpdate"),
            max_unavailable=int(spec.get("maxUnavailable", 1)),
            status_desired=int(status.get("desiredNumberScheduled", 0)),
            status_current=int(status.get("currentNumberScheduled", 0)),
            status_ready=int(status.get("numberReady", 0)),
            status_updated=int(status.get("updatedNumberScheduled", 0)),
            status_mis_scheduled=int(status.get("numberMisscheduled", 0)),
        )


@register_kind
@dataclass
class StatefulSet:
    """Ordered, identity-preserving replicas (reference
    ``pkg/apis/apps/types.go`` StatefulSet; controller
    ``pkg/controller/statefulset/stateful_set.go``).  Pods are named
    ``<set>-<ordinal>`` and created/deleted in ordinal order."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    replicas: int = 1
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    pod_management_policy: str = "OrderedReady"  # OrderedReady | Parallel
    update_strategy: str = "RollingUpdate"  # RollingUpdate | OnDelete
    partition: int = 0
    status_replicas: int = 0
    status_ready_replicas: int = 0
    status_current_replicas: int = 0
    status_updated_replicas: int = 0
    status_observed_generation: int = 0

    KIND = "StatefulSet"

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "replicas": self.replicas,
                "selector": self.selector.to_dict(),
                "template": self.template.to_dict(),
                "serviceName": self.service_name,
                "podManagementPolicy": self.pod_management_policy,
                "updateStrategy": self.update_strategy,
                "partition": self.partition,
            },
            "status": {
                "replicas": self.status_replicas,
                "readyReplicas": self.status_ready_replicas,
                "currentReplicas": self.status_current_replicas,
                "updatedReplicas": self.status_updated_replicas,
                "observedGeneration": self.status_observed_generation,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StatefulSet":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            replicas=int(spec.get("replicas", 1)),
            selector=LabelSelector.from_dict(spec.get("selector")),
            template=PodTemplateSpec.from_dict(spec.get("template")),
            service_name=spec.get("serviceName", ""),
            pod_management_policy=spec.get("podManagementPolicy", "OrderedReady"),
            update_strategy=spec.get("updateStrategy", "RollingUpdate"),
            partition=int(spec.get("partition", 0)),
            status_replicas=int(status.get("replicas", 0)),
            status_ready_replicas=int(status.get("readyReplicas", 0)),
            status_current_replicas=int(status.get("currentReplicas", 0)),
            status_updated_replicas=int(status.get("updatedReplicas", 0)),
            status_observed_generation=int(status.get("observedGeneration", 0)),
        )
