"""Built-in admission plugins.

Capability equivalents of the reference's default plugin set for this era
(``kubeapiserver/options/plugins.go``; implementations under
``plugin/pkg/admission/``):

- NamespaceLifecycle   — ``namespace/lifecycle/admission.go``
- LimitRanger          — ``limitranger/admission.go``
- ServiceAccount       — ``serviceaccount/admission.go``
- DefaultTolerationSeconds — ``defaulttolerationseconds/admission.go``
- LimitPodHardAntiAffinityTopology — ``antiaffinity/admission.go``
- Priority             — ``priority/admission.go`` (PodPriority gate)
- ResourceQuota        — ``resourcequota/admission.go`` (always LAST:
  nothing may mutate the object after usage is charged)
"""

from __future__ import annotations

import logging

from ..api.quantity import Quantity
from ..store.store import NotFoundError
from ..api.types import HOSTNAME_LABEL, TAINT_NODE_NOT_READY, TAINT_NODE_UNREACHABLE
from . import plugins_ext as _PluginsExt
from . import quota as quotalib
from .framework import (
    CREATE,
    DELETE,
    AdmissionChain,
    AdmissionPlugin,
    Attributes,
)

# Namespaces that always exist and can never be deleted (reference
# ``namespace/lifecycle/admission.go`` immortalNamespaces).
IMMORTAL_NAMESPACES = {"default", "kube-system", "kube-public"}


class PodPrepareForCreate(AdmissionPlugin):
    """Resets client-supplied pod status on create: every pod starts
    Pending (reference ``pkg/registry/core/pod/strategy.go
    PrepareForCreate`` wipes Status).  This also makes the ResourceQuota
    charge/release ledger symmetric — a pod can never enter the cluster
    already terminal, so everything released at delete was charged at
    create."""

    name = "PodPrepareForCreate"
    operations = (CREATE,)

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        attrs.obj["status"] = {"phase": "Pending"}


class NamespaceLifecycle(AdmissionPlugin):
    name = "NamespaceLifecycle"
    operations = (CREATE, DELETE)

    def validate(self, attrs: Attributes) -> None:
        from ..api.types import CLUSTER_SCOPED_KINDS

        if attrs.operation == DELETE:
            if attrs.kind == "Namespace" and attrs.name in IMMORTAL_NAMESPACES:
                self.deny(f"namespace {attrs.name} is immortal")
            return
        if attrs.kind in CLUSTER_SCOPED_KINDS or attrs.kind == "Namespace":
            return
        if attrs.namespace in IMMORTAL_NAMESPACES:
            return
        try:
            ns = attrs.store.get("Namespace", "", attrs.namespace)
        except KeyError:
            self.deny(f"namespace {attrs.namespace} not found")
            return
        phase = (ns.get("status") or {}).get("phase", "Active")
        deleting = (ns.get("metadata") or {}).get("deletionRevision") is not None
        if phase == "Terminating" or deleting:
            self.deny(f"namespace {attrs.namespace} is terminating")


class LimitRanger(AdmissionPlugin):
    """Applies LimitRange defaults to pod containers and enforces min/max
    (reference ``limitranger/admission.go``)."""

    name = "LimitRanger"
    operations = (CREATE,)

    def _ranges(self, attrs: Attributes) -> list[dict]:
        items, _ = attrs.store.list("LimitRange", attrs.namespace)
        return items

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        for lr in self._ranges(attrs):
            for item in (lr.get("spec") or {}).get("limits") or []:
                if item.get("type", "Container") != "Container":
                    continue
                defaults = item.get("default") or {}
                default_req = item.get("defaultRequest") or {}
                for c in (attrs.obj.get("spec") or {}).get("containers") or []:
                    res = c.setdefault("resources", {})
                    req = res.setdefault("requests", {})
                    lim = res.setdefault("limits", {})
                    for name, v in default_req.items():
                        req.setdefault(name, v)
                    for name, v in defaults.items():
                        lim.setdefault(name, v)
                        # limit defaults also backfill requests (reference:
                        # derived from limit when only default is set)
                        req.setdefault(name, v)

    def validate(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        for lr in self._ranges(attrs):
            for item in (lr.get("spec") or {}).get("limits") or []:
                if item.get("type", "Container") != "Container":
                    continue
                lo = item.get("min") or {}
                hi = item.get("max") or {}
                for c in (attrs.obj.get("spec") or {}).get("containers") or []:
                    res = c.get("resources") or {}
                    req = res.get("requests") or {}
                    lim = res.get("limits") or {}
                    for name, floor in lo.items():
                        got = Quantity(req.get(name, 0))
                        if got < Quantity(floor):
                            self.deny(
                                f"minimum {name} usage per Container is {floor}; "
                                f"container {c.get('name')} requests {got}"
                            )
                    for name, ceiling in hi.items():
                        got = max(
                            Quantity(lim.get(name, 0)), Quantity(req.get(name, 0))
                        )
                        if Quantity(ceiling) < got:
                            self.deny(
                                f"maximum {name} usage per Container is {ceiling}; "
                                f"container {c.get('name')} uses {got}"
                            )


class ServiceAccount(AdmissionPlugin):
    """Defaults ``spec.serviceAccountName`` and requires the referenced
    ServiceAccount to exist (reference ``serviceaccount/admission.go``;
    "default" may be absent — its controller may not have created it yet)."""

    name = "ServiceAccount"
    operations = (CREATE,)

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        spec = attrs.obj.setdefault("spec", {})
        if not spec.get("serviceAccountName"):
            spec["serviceAccountName"] = "default"

    def validate(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        name = (attrs.obj.get("spec") or {}).get("serviceAccountName", "default")
        if name == "default":
            return
        try:
            attrs.store.get("ServiceAccount", attrs.namespace, name)
        except KeyError:
            self.deny(f"service account {attrs.namespace}/{name} not found")


class DefaultTolerationSeconds(AdmissionPlugin):
    """Adds default 300s NoExecute tolerations for node.alpha not-ready /
    unreachable taints (reference ``defaulttolerationseconds/admission.go``)."""

    name = "DefaultTolerationSeconds"
    operations = (CREATE,)

    NOT_READY = TAINT_NODE_NOT_READY
    UNREACHABLE = TAINT_NODE_UNREACHABLE
    DEFAULT_SECONDS = 300

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        spec = attrs.obj.setdefault("spec", {})
        tolerations = spec.setdefault("tolerations", [])
        keys = {t.get("key") for t in tolerations}
        for key in (self.NOT_READY, self.UNREACHABLE):
            if key not in keys:
                tolerations.append({
                    "key": key,
                    "operator": "Exists",
                    "effect": "NoExecute",
                    "tolerationSeconds": self.DEFAULT_SECONDS,
                })


class LimitPodHardAntiAffinityTopology(AdmissionPlugin):
    """Denies required pod anti-affinity with a topology key other than
    hostname (reference ``antiaffinity/admission.go``)."""

    name = "LimitPodHardAntiAffinityTopology"
    operations = (CREATE,)

    def validate(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        affinity = (attrs.obj.get("spec") or {}).get("affinity") or {}
        for term in affinity.get("podAntiAffinityRequired") or []:
            key = term.get("topologyKey", "")
            if key and key != HOSTNAME_LABEL:
                self.deny(
                    "required pod anti-affinity has topologyKey "
                    f"{key}; only {HOSTNAME_LABEL} is allowed"
                )


class Priority(AdmissionPlugin):
    """Resolves ``priorityClassName`` into ``spec.priority`` (reference
    ``priority/admission.go``, PodPriority feature)."""

    name = "Priority"
    operations = (CREATE,)

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod":
            return
        spec = attrs.obj.setdefault("spec", {})
        cls_name = spec.get("priorityClassName", "")
        if cls_name:
            try:
                pc = attrs.store.get("PriorityClass", "", cls_name)
            except KeyError:
                self.deny(f"no PriorityClass with name {cls_name} was found")
                return
            spec["priority"] = int(pc.get("value", 0))
            return
        if spec.get("priority"):
            # non-zero priority stands; 0 means "unset" on this wire form
            # (PodSpec always serializes the field, so absence can't signal)
            return
        for pc in attrs.store.list("PriorityClass", None)[0]:
            if pc.get("globalDefault"):
                spec["priority"] = int(pc.get("value", 0))
                spec["priorityClassName"] = pc["metadata"]["name"]
                return


class ResourceQuota(AdmissionPlugin):
    """Synchronous quota enforcement: charges usage against every matching
    ResourceQuota in the namespace with a CAS on ``status.used`` before the
    object is stored; releases it on delete.  Runs LAST (reference
    ``resourcequota/admission.go`` — the plugin registry pins it to the end
    so later mutation can't dodge the ledger).  Leaked charges from failed
    writes are healed by the quota controller's full recalculation."""

    name = "ResourceQuota"
    operations = (CREATE, DELETE)

    def validate(self, attrs: Attributes) -> None:
        release = attrs.operation == DELETE
        obj = attrs.obj if attrs.operation == CREATE else attrs.old_obj
        # Deleting a TERMINAL pod releases nothing here: its usage was
        # already dropped by the quota controller's churn-driven resync at
        # the Succeeded/Failed transition, and decrementing again would
        # deflate status.used below the truth (over-admission).  Releasing
        # only live usage mirrors the reference, where admission never
        # lowers used past what replenishment computed; the controller
        # MUST run alongside this plugin to reclaim terminal-pod usage.
        usage = quotalib.usage_for(attrs.kind, obj)
        if not usage:
            return
        quotas, _ = attrs.store.list("ResourceQuota", attrs.namespace)
        charged: list[dict] = []
        for rq in quotas:
            scopes = (rq.get("spec") or {}).get("scopes") or []
            if not quotalib.matches_scopes(scopes, attrs.kind, obj):
                continue
            try:
                self._charge(attrs, rq, usage, release=release)
            except NotFoundError:
                # quota vanished between list and CAS: it constrains nothing
                # anymore, skip it
                continue
            except Exception:
                # deny (or any CAS failure) on a later quota: undo charges
                # already applied to earlier quotas so the failed write
                # leaves no quota inflated; a failed undo must not mask the
                # original error — the controller resync heals the leak
                for prev in charged:
                    try:
                        self._charge(attrs, prev, usage, release=True)
                    except Exception as undo_err:  # noqa: BLE001
                        # an inflated quota self-heals at the controller's
                        # next resync; warn so the interim over-restriction
                        # has a visible cause (the ORIGINAL error re-raises
                        # below — the undo failure must not mask it)
                        logging.getLogger("kubernetes_tpu_torch.admission").warning(
                            "quota undo failed for %s/%s (%s); controller "
                            "resync will reconcile",
                            attrs.namespace, prev["metadata"]["name"],
                            undo_err)
                raise
            if not release:
                charged.append(rq)

    def _charge(self, attrs: Attributes, rq: dict, usage, release: bool) -> None:
        name = rq["metadata"]["name"]
        plugin = self

        def _apply(cur: dict) -> dict:
            status = cur.setdefault("status", {})
            hard = {k: Quantity(v) for k, v in (status.get("hard") or (cur.get("spec") or {}).get("hard") or {}).items()}
            used = {k: Quantity(v) for k, v in (status.get("used") or {}).items()}
            if release:
                new_used = quotalib.sub_usage(used, usage)
            else:
                new_used = quotalib.add_usage(used, usage)
                over = quotalib.exceeds(hard, new_used)
                if over:
                    plugin.deny(
                        f"exceeded quota: {name}, requested: "
                        + ",".join(f"{r}={usage.get(r)}" for r in over if r in usage)
                        + ", limited: "
                        + ",".join(f"{r}={hard[r]}" for r in over)
                    )
            status["used"] = {k: str(v) for k, v in new_used.items()}
            return cur

        attrs.store.guaranteed_update("ResourceQuota", attrs.namespace, name, _apply)


def default_chain() -> AdmissionChain:
    """The default plugin order (quota last, like the reference's
    ``plugins.go`` recommended order)."""
    return AdmissionChain([
        PodPrepareForCreate(),
        NamespaceLifecycle(),
        LimitRanger(),
        ServiceAccount(),
        _PluginsExt.ServiceIPAllocator(),
        _PluginsExt.DefaultStorageClass(),
        _PluginsExt.PodPreset(),
        DefaultTolerationSeconds(),
        LimitPodHardAntiAffinityTopology(),
        Priority(),
        _PluginsExt.DenyEscalatingExec(),
        # inert until PodSecurityPolicy objects exist (opt-in like the
        # reference's plugin enablement)
        _PluginsExt.PodSecurityPolicyPlugin(),
        _PluginsExt.NetworkPolicyValidation(),
        ResourceQuota(),
    ])
