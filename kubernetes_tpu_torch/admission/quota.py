"""Quota usage evaluators (reference ``pkg/quota`` — ``Evaluator`` per
group-kind, ``pkg/quota/evaluator/core/pods.go`` for pod compute usage).

``usage_for(kind, obj)`` maps an object to the quota resources it consumes;
``add_usage``/``sub_usage`` are the ledger arithmetic used by both the
ResourceQuota admission plugin (synchronous enforcement) and the quota
controller (asynchronous full recalculation).
"""

from __future__ import annotations

from typing import Optional

from ..api.quantity import Quantity
from ..api.types import CPU, MEMORY

# quota resource names (reference pkg/api/types.go ResourceName consts)
PODS = "pods"
REQUESTS_CPU = "requests.cpu"
REQUESTS_MEMORY = "requests.memory"
LIMITS_CPU = "limits.cpu"
LIMITS_MEMORY = "limits.memory"

# kinds counted with simple object-count quota resources
# (reference: services, secrets, configmaps, replicationcontrollers,
# resourcequotas, persistentvolumeclaims all countable)
COUNTED_KINDS = {
    "Service": "services",
    "Secret": "secrets",
    "ConfigMap": "configmaps",
    "ReplicaSet": "count/replicasets",
    "Deployment": "count/deployments",
    "Job": "count/jobs",
    "PersistentVolumeClaim": "persistentvolumeclaims",
}


def _pod_terminal(obj: dict) -> bool:
    phase = (obj.get("status") or {}).get("phase", "Pending")
    return phase in ("Succeeded", "Failed")


def usage_for(kind: str, obj: Optional[dict]) -> dict[str, Quantity]:
    """Quota resources consumed by one object (empty if not quota-tracked).

    Pod usage follows the reference's rule (``evaluator/core/pods.go``):
    terminal pods consume nothing; cpu/memory usage = sum of container
    requests (and limits for the limits.* resources).  Terminal-pod usage
    is reclaimed by the quota CONTROLLER at the phase transition, never by
    the admission delete path (see ResourceQuota.validate)."""
    if obj is None:
        return {}
    if kind == "Pod":
        if _pod_terminal(obj):
            return {}
        usage: dict[str, Quantity] = {PODS: Quantity(1)}
        req_cpu = Quantity(0)
        req_mem = Quantity(0)
        lim_cpu = Quantity(0)
        lim_mem = Quantity(0)
        for c in (obj.get("spec") or {}).get("containers") or []:
            res = c.get("resources") or {}
            req = res.get("requests") or {}
            lim = res.get("limits") or {}
            req_cpu += Quantity(req.get(CPU, 0))
            req_mem += Quantity(req.get(MEMORY, 0))
            lim_cpu += Quantity(lim.get(CPU, 0))
            lim_mem += Quantity(lim.get(MEMORY, 0))
        if not req_cpu.is_zero():
            usage[REQUESTS_CPU] = req_cpu
            usage[CPU] = req_cpu  # bare "cpu" aliases requests.cpu
        if not req_mem.is_zero():
            usage[REQUESTS_MEMORY] = req_mem
            usage[MEMORY] = req_mem
        if not lim_cpu.is_zero():
            usage[LIMITS_CPU] = lim_cpu
        if not lim_mem.is_zero():
            usage[LIMITS_MEMORY] = lim_mem
        return usage
    counted = COUNTED_KINDS.get(kind)
    if counted:
        return {counted: Quantity(1)}
    return {}


def matches_scopes(scopes: list[str], kind: str, obj: Optional[dict]) -> bool:
    """Reference quota scopes (``pkg/quota/evaluator/core/pods.go``
    podMatchesScopeFunc): BestEffort / NotBestEffort / Terminating /
    NotTerminating select which pods a scoped quota tracks."""
    if not scopes:
        return True
    if kind != "Pod" or obj is None:
        return False
    best_effort = _is_best_effort(obj)
    terminating = ((obj.get("spec") or {}).get("activeDeadlineSeconds")) is not None
    for scope in scopes:
        if scope == "BestEffort" and not best_effort:
            return False
        if scope == "NotBestEffort" and best_effort:
            return False
        if scope == "Terminating" and not terminating:
            return False
        if scope == "NotTerminating" and terminating:
            return False
    return True


def _is_best_effort(obj: dict) -> bool:
    for c in (obj.get("spec") or {}).get("containers") or []:
        res = c.get("resources") or {}
        for section in ("requests", "limits"):
            for name in (CPU, MEMORY):
                if not Quantity((res.get(section) or {}).get(name, 0)).is_zero():
                    return False
    return True


def add_usage(a: dict[str, Quantity], b: dict[str, Quantity]) -> dict[str, Quantity]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, Quantity(0)) + v
    return out


def sub_usage(a: dict[str, Quantity], b: dict[str, Quantity]) -> dict[str, Quantity]:
    out = dict(a)
    for k, v in b.items():
        cur = out.get(k, Quantity(0)) - v
        out[k] = cur if Quantity(0) < cur else Quantity(0)
    return out


def exceeds(hard: dict[str, Quantity], used: dict[str, Quantity]) -> list[str]:
    """Resources where used > hard (only resources the quota constrains)."""
    over = []
    for name, ceiling in hard.items():
        if ceiling < used.get(name, Quantity(0)):
            over.append(name)
    return over
