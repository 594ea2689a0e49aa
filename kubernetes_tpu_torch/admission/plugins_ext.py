"""Extended admission plugins (toward the reference's full default set).

Capability equivalents of ``plugin/pkg/admission/*``:

- DefaultStorageClass        — ``storageclass/default/admission.go``
- PodPreset                  — ``podpreset/admission.go``
- AlwaysPullImages           — ``alwayspullimages/admission.go``
- PodNodeSelector            — ``podnodeselector/admission.go``
- ImagePolicyWebhook         — ``imagepolicy/admission.go``
- GenericAdmissionWebhook    — ``webhook/admission.go`` (external
  validating webhooks with a failure policy)
- NodeRestriction            — ``noderestriction/admission.go``

Webhook transports are injectable callables (tests pass functions; the
HTTP form posts JSON like the scheduler extender does), because the
webhook CONTRACT — review request in, allow/deny out, failure policy on
error — is the capability, not the socket.

``OwnerReferencesPermissionEnforcement`` takes any authorizer with
``authorize(attrs) -> (decision, reason)``; ``attrs`` carries ``user``
(with ``name``), ``verb``, ``resource``, ``namespace``, ``name`` and
``path``, and the decision ``"allow"`` admits (the JAX package's
authorizer contract; the port has no authorizer of its own yet)."""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional

from ..api.selectors import LabelSelector
from ..store.store import NotFoundError
from .framework import CREATE, DELETE, UPDATE, AdmissionPlugin, Attributes


class DefaultStorageClass(AdmissionPlugin):
    """PVCs created without a class get the cluster default
    (``storageclass/default/admission.go``: exactly one class annotated
    default; ambiguous defaults deny)."""

    name = "DefaultStorageClass"
    operations = (CREATE,)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "PersistentVolumeClaim" and super().handles(attrs)

    def admit(self, attrs: Attributes) -> None:
        spec = attrs.obj.setdefault("spec", {})
        if spec.get("storageClassName"):
            return
        defaults = [
            d for d in attrs.store.list("StorageClass", None)[0] if d.get("isDefault")
        ]
        if not defaults:
            return
        if len(defaults) > 1:
            self.deny("more than one default StorageClass")
        spec["storageClassName"] = defaults[0]["metadata"]["name"]


class PodPreset(AdmissionPlugin):
    """Inject env/volumes from matching PodPresets into pods at create
    (``podpreset/admission.go``); a merge CONFLICT (the pod already sets a
    key the preset would set, with a different value) skips the entire
    preset — no partial application."""

    name = "PodPreset"
    operations = (CREATE,)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def admit(self, attrs: Attributes) -> None:
        labels = (attrs.obj.get("metadata") or {}).get("labels") or {}
        spec = attrs.obj.setdefault("spec", {})
        applied = []
        for raw in attrs.store.list("PodPreset", attrs.namespace)[0]:
            preset_spec = raw.get("spec") or {}
            sel = LabelSelector.from_dict(preset_spec.get("selector"))
            if not sel.matches(labels):
                continue
            env = preset_spec.get("env") or {}
            conflict = any(
                k in (c.get("env") or {}) and c["env"][k] != v
                for c in spec.get("containers") or []
                for k, v in env.items()
            ) or any(
                v.get("name") == pv.get("name") and v != pv
                for v in spec.get("volumes") or []
                for pv in preset_spec.get("volumes") or []
            )
            if conflict:
                continue  # the whole preset is skipped, nothing applied
            for c in spec.setdefault("containers", []):
                merged = dict(env)
                merged.update(c.get("env") or {})
                if merged:
                    c["env"] = merged
            have = {v.get("name") for v in spec.get("volumes") or []}
            for vol in preset_spec.get("volumes") or []:
                if vol.get("name") not in have:
                    spec.setdefault("volumes", []).append(dict(vol))
            applied.append(raw["metadata"]["name"])
        if applied:
            meta = attrs.obj.setdefault("metadata", {})
            anns = meta.setdefault("annotations", {})
            for name in applied:
                anns[f"podpreset.admission.kubernetes.io/podpreset-{name}"] = "applied"


class AlwaysPullImages(AdmissionPlugin):
    """Force imagePullPolicy=Always (``alwayspullimages/admission.go``:
    multi-tenant nodes must not serve cached private images)."""

    name = "AlwaysPullImages"
    operations = (CREATE, UPDATE)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def admit(self, attrs: Attributes) -> None:
        for c in (attrs.obj.get("spec") or {}).get("containers") or []:
            c["imagePullPolicy"] = "Always"

    def validate(self, attrs: Attributes) -> None:
        for c in (attrs.obj.get("spec") or {}).get("containers") or []:
            if c.get("imagePullPolicy") != "Always":
                self.deny(f"container {c.get('name')} must pull Always")


class PodNodeSelector(AdmissionPlugin):
    """Merge the namespace's node-selector annotation into pods; a pod
    selector conflicting with the namespace's is denied
    (``podnodeselector/admission.go``)."""

    name = "PodNodeSelector"
    operations = (CREATE,)
    ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def _namespace_selector(self, attrs: Attributes) -> dict:
        try:
            ns = attrs.store.get("Namespace", "", attrs.namespace)
        except NotFoundError:
            return {}
        raw = ((ns.get("metadata") or {}).get("annotations") or {}).get(self.ANNOTATION, "")
        out = {}
        for part in raw.split(","):
            part = part.strip()
            if part and "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    def admit(self, attrs: Attributes) -> None:
        want = self._namespace_selector(attrs)
        if not want:
            return
        spec = attrs.obj.setdefault("spec", {})
        sel = spec.setdefault("nodeSelector", {})
        for k, v in want.items():
            if k in sel and sel[k] != v:
                self.deny(f"pod node selector {k}={sel[k]} conflicts with namespace {k}={v}")
            sel[k] = v


class ImagePolicyWebhook(AdmissionPlugin):
    """Ask an external image-policy service whether the pod's images are
    allowed (``imagepolicy/admission.go``).  ``default_allow`` is the
    failure policy when the backend is unreachable."""

    name = "ImagePolicyWebhook"
    operations = (CREATE,)

    def __init__(self, backend: Optional[Callable[[dict], dict]] = None,
                 url: Optional[str] = None, default_allow: bool = False,
                 timeout: float = 5.0):
        if backend is None and url is None:
            # surface misconfiguration at wiring time, not as a perpetual
            # "backend unreachable" that the failure policy silently eats
            raise ValueError("ImagePolicyWebhook needs a backend or a url")
        self.backend = backend
        self.url = url
        self.default_allow = default_allow
        self.timeout = timeout

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def _review(self, payload: dict) -> dict:
        if self.backend is not None:
            return self.backend(payload)
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def validate(self, attrs: Attributes) -> None:
        images = [c.get("image", "") for c in
                  (attrs.obj.get("spec") or {}).get("containers") or []]
        payload = {"spec": {"containers": [{"image": i} for i in images],
                            "namespace": attrs.namespace}}
        try:
            result = self._review(payload)
        except Exception:
            if self.default_allow:
                return
            self.deny("image policy backend unreachable (failure policy: deny)")
        if not (result.get("status") or {}).get("allowed", False):
            reason = (result.get("status") or {}).get("reason", "image rejected")
            self.deny(reason)


class GenericAdmissionWebhook(AdmissionPlugin):
    """External validating webhooks (``webhook/admission.go``): each rule
    names the kinds it reviews; ``fail_open`` webhooks admit on backend
    error, fail-closed ones deny."""

    name = "GenericAdmissionWebhook"
    operations = (CREATE, UPDATE, DELETE)

    def __init__(self, webhooks: Optional[list[dict]] = None, timeout: float = 5.0):
        # each: {name, kinds: [..] | ["*"], backend: callable | url: str,
        #        fail_open: bool}
        self.webhooks = webhooks or []
        self.timeout = timeout

    def _call(self, hook: dict, payload: dict) -> dict:
        backend = hook.get("backend")
        if backend is not None:
            return backend(payload)
        req = urllib.request.Request(
            hook["url"], data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def validate(self, attrs: Attributes) -> None:
        payload = {
            "request": {
                "operation": attrs.operation,
                "kind": attrs.kind,
                "namespace": attrs.namespace,
                "name": attrs.name,
                "object": attrs.obj,
                "oldObject": attrs.old_obj,
                "userInfo": {"username": attrs.user},
            }
        }
        for hook in self.webhooks:
            kinds = hook.get("kinds", ["*"])
            if "*" not in kinds and attrs.kind not in kinds:
                continue
            try:
                result = self._call(hook, payload)
            except Exception:
                if hook.get("fail_open", False):
                    continue
                self.deny(f"webhook {hook.get('name')} unreachable (fail closed)")
            response = result.get("response") or {}
            if not response.get("allowed", False):
                msg = (response.get("status") or {}).get("message", "denied")
                self.deny(f"webhook {hook.get('name')}: {msg}")


class ServiceIPAllocator(AdmissionPlugin):
    """ClusterIP + NodePort allocation at service create (the capability
    of the reference's service REST registry allocators,
    ``pkg/registry/core/service`` — placed on the write path the way all
    of this framework's registry behavior is)."""

    name = "ServiceIPAllocator"
    operations = (CREATE,)

    def __init__(self, service_cidr: str = "10.0.0.0/16",
                 node_port_range: tuple[int, int] = (30000, 32767)):
        import ipaddress

        self.network = ipaddress.ip_network(service_cidr)
        self.node_port_range = node_port_range

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Service" and super().handles(attrs)

    def admit(self, attrs: Attributes) -> None:
        import ipaddress

        spec = attrs.obj.setdefault("spec", {})
        existing, _ = attrs.store.list("Service", None)
        used_ips = {s.get("spec", {}).get("clusterIP", "") for s in existing}
        used_ports = {
            p.get("nodePort", 0)
            for s in existing
            for p in s.get("spec", {}).get("ports", [])
        }
        ip = spec.get("clusterIP", "")
        if ip == "":
            for candidate in self.network.hosts():
                c = str(candidate)
                if c not in used_ips:
                    spec["clusterIP"] = c
                    break
            else:
                self.deny("service CIDR exhausted")
        elif ip != "None":
            try:
                addr = ipaddress.ip_address(ip)
            except ValueError:
                self.deny(f"invalid clusterIP {ip!r}")
            if addr not in self.network:
                self.deny(f"clusterIP {ip} not in service CIDR {self.network}")
            if ip in used_ips:
                self.deny(f"clusterIP {ip} already allocated")
        if spec.get("type") in ("NodePort", "LoadBalancer"):
            lo, hi = self.node_port_range
            for port in spec.get("ports", []):
                np = int(port.get("nodePort", 0) or 0)
                if np == 0:
                    for candidate in range(lo, hi + 1):
                        if candidate not in used_ports:
                            port["nodePort"] = candidate
                            used_ports.add(candidate)
                            break
                    else:
                        self.deny("node port range exhausted")
                elif np in used_ports:
                    self.deny(f"node port {np} already allocated")
                elif not (lo <= np <= hi):
                    self.deny(f"node port {np} outside range {lo}-{hi}")
                else:
                    used_ports.add(np)


class NodeRestriction(AdmissionPlugin):
    """Kubelets (``system:node:<name>``) may only modify their own Node
    object and pods bound to them (``noderestriction/admission.go``)."""

    name = "NodeRestriction"
    operations = (CREATE, UPDATE, DELETE)
    PREFIX = "system:node:"

    def validate(self, attrs: Attributes) -> None:
        if not attrs.user.startswith(self.PREFIX):
            return
        node_name = attrs.user[len(self.PREFIX):]
        if attrs.kind == "Node":
            if attrs.name != node_name:
                self.deny(f"node {node_name} may not modify node {attrs.name}")
            return
        if attrs.kind == "Pod":
            ref = attrs.obj if attrs.operation != DELETE else attrs.old_obj
            bound = ((ref or {}).get("spec") or {}).get("nodeName", "")
            if bound != node_name:
                self.deny(f"node {node_name} may only manage its own pods")
            return
        self.deny(f"node {node_name} may not write {attrs.kind} objects")


class NamespaceAutoProvision(AdmissionPlugin):
    """Create the namespace on first use instead of rejecting
    (``autoprovision/admission.go`` — the permissive sibling of
    NamespaceLifecycle's exists-check)."""

    name = "NamespaceAutoProvision"
    operations = (CREATE,)

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.kind == "Namespace":
            return
        try:
            attrs.store.get("Namespace", "", attrs.namespace)
        except NotFoundError:
            from ..api.cluster import Namespace
            from ..api.meta import ObjectMeta
            from ..store.store import AlreadyExistsError

            try:
                attrs.store.create(
                    "Namespace",
                    Namespace(meta=ObjectMeta(name=attrs.namespace)).to_dict(),
                )
            except AlreadyExistsError:
                pass  # racing creates are fine; anything else surfaces


class SecurityContextDeny(AdmissionPlugin):
    """Reject privileged containers (``securitycontextdeny/admission.go``
    at the depth this pod model carries security context)."""

    name = "SecurityContextDeny"
    operations = (CREATE, UPDATE)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def validate(self, attrs: Attributes) -> None:
        for c in (attrs.obj.get("spec") or {}).get("containers") or []:
            if (c.get("securityContext") or {}).get("privileged"):
                self.deny(f"container {c.get('name')} requests privileged mode")


class AlwaysAdmit(AdmissionPlugin):
    """``admit/admission.go`` — the no-op plugin (testing/default glue)."""

    name = "AlwaysAdmit"
    operations = (CREATE, UPDATE, DELETE)


class AlwaysDeny(AdmissionPlugin):
    """``deny/admission.go`` — rejects everything (lockdown/testing)."""

    name = "AlwaysDeny"
    operations = (CREATE, UPDATE, DELETE)

    def validate(self, attrs: Attributes) -> None:
        self.deny("AlwaysDeny rejects all requests")


class DenyEscalatingExec(AdmissionPlugin):
    """Reject exec/attach on privileged pods
    (``plugin/pkg/admission/exec/admission.go`` DenyEscalatingExec):
    create-exec rights must not escalate into the host through a
    privileged or host-namespace container."""

    name = "DenyEscalatingExec"
    operations = ("CONNECT",)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and attrs.operation == "CONNECT"

    def validate(self, attrs: Attributes) -> None:
        pod = attrs.old_obj or {}
        spec = pod.get("spec") or {}
        for flag in ("hostPID", "hostIPC", "hostNetwork"):
            if spec.get(flag):
                self.deny(f"cannot exec into a pod sharing the host's "
                          f"{flag[4:].lower()} namespace")
        for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
            if (c.get("securityContext") or {}).get("privileged"):
                self.deny(
                    f"cannot exec into privileged container {c.get('name')!r}")


ALLOW = "allow"


@dataclass
class AuthzUser:
    name: str = ""


@dataclass
class AuthzRequest:
    """What an authorizer is asked (reference ``authorizer.Attributes``)."""

    user: AuthzUser
    verb: str
    resource: str
    namespace: str = ""
    name: str = ""
    path: str = ""


class OwnerReferencesPermissionEnforcement(AdmissionPlugin):
    """``plugin/pkg/admission/gc/gc_admission.go``: changing an object's
    ownerReferences requires DELETE rights on the object — otherwise a
    user with only update rights could trick the garbage collector into
    deleting objects for them (set an ownerRef to something they can
    delete, remove the owner, GC does the rest)."""

    name = "OwnerReferencesPermissionEnforcement"
    operations = (UPDATE,)

    def __init__(self, authorizer=None):
        # authorizer is optional: without one, ownerRef changes by
        # non-privileged identities are denied outright (fail closed)
        self.authorizer = authorizer

    def validate(self, attrs: Attributes) -> None:
        new_refs = ((attrs.obj or {}).get("metadata") or {}).get("ownerReferences") or []
        old_refs = ((attrs.old_obj or {}).get("metadata") or {}).get("ownerReferences") or []
        if new_refs == old_refs:
            return
        user = attrs.user or ""
        if user.startswith("system:") or not user:
            # controllers (and the unauthenticated in-proc path) manage
            # ownership legitimately — the reference exempts them via RBAC
            return
        if self.authorizer is not None:
            from ..api.types import KIND_PLURALS

            decision, _ = self.authorizer.authorize(AuthzRequest(
                user=AuthzUser(name=user), verb="delete",
                resource=KIND_PLURALS.get(attrs.kind, attrs.kind.lower()),
                namespace=attrs.namespace, name=attrs.name))
            if decision == ALLOW:
                return
        self.deny("cannot set/change ownerReferences without delete "
                  "permission on the object")


class PersistentVolumeLabel(AdmissionPlugin):
    """``plugin/pkg/admission/persistentvolume/label``: stamp cloud
    topology labels (zone/region) onto PersistentVolumes at create time
    so the volume-zone predicate can act on them."""

    name = "PersistentVolumeLabel"
    operations = (CREATE,)

    ZONE = "failure-domain.beta.kubernetes.io/zone"
    REGION = "failure-domain.beta.kubernetes.io/region"

    def __init__(self, cloud=None):
        self.cloud = cloud  # CloudProvider with zones(); None = inert

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "PersistentVolume" and super().handles(attrs)

    def admit(self, attrs: Attributes) -> None:
        if self.cloud is None or self.cloud.zones() is None:
            return
        meta = attrs.obj.setdefault("metadata", {})
        labels = meta.setdefault("labels", {})
        if self.ZONE in labels:
            return
        # the volume's disk lives where its (cloud) source does; the fake
        # cloud keys zone by the spec's source instance/disk name
        source = ((attrs.obj.get("spec") or {}).get("diskID")
                  or meta.get("name", ""))
        try:
            zone, region = self.cloud.zones().get_zone(source)
        except KeyError:
            return
        if zone:
            labels[self.ZONE] = zone
        if region:
            labels[self.REGION] = region


class Initializers(AdmissionPlugin):
    """``plugin/pkg/admission/initialization`` (alpha in the reference
    era): objects created with ``metadata.initializers.pending`` are
    hidden from ordinary LISTs until every initializer controller removes
    its entry; this plugin enforces the protocol — only the FIRST pending
    initializer may be removed per update, and new objects may not
    self-declare an empty-but-present result."""

    name = "Initializers"
    operations = (CREATE, UPDATE)

    def validate(self, attrs: Attributes) -> None:
        if attrs.operation == CREATE:
            init = ((attrs.obj or {}).get("metadata") or {}).get("initializers")
            if init is not None and "result" in init:
                # a creator may arrive WITH pending initializers (the
                # reference's initializer admission stamps them) but must
                # not self-declare completion
                self.deny("cannot create an object with a self-declared "
                          "initializer result")
            return
        new_pending = [i.get("name") for i in
                       (((attrs.obj or {}).get("metadata") or {})
                        .get("initializers") or {}).get("pending") or []]
        old_pending = [i.get("name") for i in
                       (((attrs.old_obj or {}).get("metadata") or {})
                        .get("initializers") or {}).get("pending") or []]
        if new_pending == old_pending:
            return
        # removal must be prefix-order: the first pending initializer is
        # the only one allowed to complete
        if old_pending and new_pending == old_pending[1:]:
            return
        if not old_pending and new_pending:
            self.deny("cannot add initializers after creation")
        self.deny("initializers must be removed in order, first first")


class PodSecurityPolicyPlugin(AdmissionPlugin):
    """``plugin/pkg/admission/security/podsecuritypolicy``: a pod is
    admitted by the FIRST policy (name order) that allows everything it
    requests — privilege, host namespaces, user range, volume kinds; the
    admitting policy's name is stamped on the pod.  With no policies
    registered the plugin is inert (the cluster hasn't opted into PSP)."""

    name = "PodSecurityPolicy"
    operations = (CREATE,)

    ANNOTATION = "kubernetes.io/psp"

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "Pod" and super().handles(attrs)

    def _violations(self, policy: dict, pod: dict) -> list:
        spec = pod.get("spec") or {}
        pspec = policy.get("spec") or {}
        out = []
        for flag, allowed_key in (("hostPID", "hostPID"), ("hostIPC", "hostIPC"),
                                  ("hostNetwork", "hostNetwork")):
            if spec.get(flag) and not pspec.get(allowed_key):
                out.append(f"{flag} is not allowed")
        run_rule = (pspec.get("runAsUser") or {}).get("rule", "RunAsAny")
        for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
            sc = c.get("securityContext") or {}
            if sc.get("privileged") and not pspec.get("privileged"):
                out.append(f"privileged container {c.get('name')!r} is not allowed")
            if run_rule == "MustRunAs":
                uid = sc.get("runAsUser")
                lo = (pspec.get("runAsUser") or {}).get("min", 0)
                hi = (pspec.get("runAsUser") or {}).get("max", 1 << 31)
                if uid is None or not (lo <= uid <= hi):
                    out.append(
                        f"container {c.get('name')!r} runAsUser {uid} outside "
                        f"[{lo}, {hi}]")
        allowed_kinds = pspec.get("allowedVolumeKinds")
        if allowed_kinds is None:
            allowed_kinds = ["*"]
        # NOTE: [] is a VALID policy (deny all volumes) — never coerce an
        # empty list to the wildcard
        if "*" not in allowed_kinds:
            for v in spec.get("volumes") or []:
                kind = v.get("diskKind") or ("pvc" if v.get("pvcName") else "")
                if kind and kind not in allowed_kinds:
                    out.append(f"volume kind {kind!r} is not allowed")
        return out

    def validate(self, attrs: Attributes) -> None:
        if attrs.store is None:
            return
        policies, _ = attrs.store.list("PodSecurityPolicy", "")
        if not policies:
            return  # PSP not in use
        failures = {}
        for policy in sorted(policies,
                             key=lambda p: (p.get("metadata") or {}).get("name", "")):
            bad = self._violations(policy, attrs.obj or {})
            pname = (policy.get("metadata") or {}).get("name", "")
            if not bad:
                # stamp the admitting policy (validate runs after admit;
                # the annotation write here is the reference's behavior)
                ((attrs.obj or {}).setdefault("metadata", {})
                 .setdefault("annotations", {}))[self.ANNOTATION] = pname
                return
            failures[pname] = bad[0]
        detail = "; ".join(f"{n}: {m}" for n, m in failures.items())
        self.deny(f"no PodSecurityPolicy admits this pod ({detail})")


class NetworkPolicyValidation(AdmissionPlugin):
    """Validation for the networking group (reference
    ``pkg/apis/networking/validation/validation.go``): the podSelector
    must parse as a label selector, each port needs a TCP/UDP protocol
    and a numeric port in 1-65535 or a named port, and each peer must
    carry exactly one of podSelector / namespaceSelector."""

    name = "NetworkPolicyValidation"
    operations = (CREATE, UPDATE)

    def handles(self, attrs: Attributes) -> bool:
        return attrs.kind == "NetworkPolicy" and super().handles(attrs)

    def _check_selector(self, d, path: str) -> None:
        from ..api import selectors as _sel

        try:
            sel = LabelSelector.from_dict(d)
        except (ValueError, TypeError, KeyError, AttributeError) as e:
            self.deny(f"{path}: invalid selector: {e}")
            return
        ops = (_sel.IN, _sel.NOT_IN, _sel.EXISTS, _sel.DOES_NOT_EXIST,
               _sel.GT, _sel.LT)
        for r in sel.match_expressions:
            if r.operator not in ops:
                self.deny(f"{path}: unknown operator {r.operator!r}")

    def validate(self, attrs: Attributes) -> None:
        spec = (attrs.obj or {}).get("spec") or {}
        if not isinstance(spec, dict):
            self.deny("spec: must be an object")
        # podSelector is REQUIRED (types.go:46 "This field is NOT
        # optional"): an omitted selector must not silently decode to
        # the empty selector and isolate every pod in the namespace
        if not isinstance(spec.get("podSelector"), dict):
            self.deny("spec.podSelector: required field (an explicit {} "
                      "selects all pods in the namespace)")
        self._check_selector(spec.get("podSelector"), "spec.podSelector")
        ingress = spec.get("ingress") or []
        if not isinstance(ingress, list):
            self.deny("spec.ingress: must be a list")
        for i, rule in enumerate(ingress):
            if not isinstance(rule, dict):
                self.deny(f"spec.ingress[{i}]: must be an object")
            ports = rule.get("ports") or []
            peers = rule.get("from") or []
            if not isinstance(ports, list):
                self.deny(f"spec.ingress[{i}].ports: must be a list")
            if not isinstance(peers, list):
                self.deny(f"spec.ingress[{i}].from: must be a list")
            for j, port in enumerate(ports):
                if not isinstance(port, dict):
                    self.deny(f"spec.ingress[{i}].ports[{j}]: "
                              f"must be an object")
                proto = port.get("protocol", "TCP")
                if proto not in ("TCP", "UDP"):
                    self.deny(f"spec.ingress[{i}].ports[{j}].protocol: "
                              f"unsupported value {proto!r}")
                p = port.get("port")
                if p is not None:
                    if isinstance(p, bool) or not isinstance(p, (int, str)):
                        self.deny(f"spec.ingress[{i}].ports[{j}].port: "
                                  f"must be a number or named port")
                    if isinstance(p, int) and not (1 <= p <= 65535):
                        self.deny(f"spec.ingress[{i}].ports[{j}].port: "
                                  f"must be between 1 and 65535")
                    if isinstance(p, str) and not p:
                        self.deny(f"spec.ingress[{i}].ports[{j}].port: "
                                  f"named port must not be empty")
            for j, peer in enumerate(peers):
                if not isinstance(peer, dict):
                    self.deny(f"spec.ingress[{i}].from[{j}]: "
                              f"must be an object")
                has_pod = "podSelector" in peer
                has_ns = "namespaceSelector" in peer
                if has_pod == has_ns:  # both or neither
                    self.deny(f"spec.ingress[{i}].from[{j}]: exactly one "
                              f"of podSelector or namespaceSelector "
                              f"is required")
                sel = peer.get("podSelector") if has_pod else peer.get("namespaceSelector")
                self._check_selector(sel, f"spec.ingress[{i}].from[{j}]")
