"""kubectl-equivalent CLI.

Capability of the reference's kubectl core verbs (``pkg/kubectl``, SURVEY.md
§2.8) at the depth this control plane serves:

  get / describe / create -f / apply -f / delete / scale / cordon /
  uncordon / drain / events / top nodes

``apply`` is declarative create-or-update keyed on the last-applied
configuration annotation (the essential of the reference's 3-way strategic
merge, ``cmd/apply.go``): unchanged manifests are left alone, changed ones
update spec/labels while preserving cluster-owned fields.  ``drain``
cordons then evicts (``cmd/drain.go``).  Manifests are YAML or JSON, one or
many documents; a manifest that parses as JSON is read with ``json``.
PyYAML is imported only by the paths that read or write YAML (``-o
yaml``, a manifest that is not JSON, ``describe`` of a kind without a
describer, ``edit``, ``config``, ``convert``, ``apply
view-last-applied``), so the other verbs run without it.

Speaks to an API server over HTTP (``--server``), or to an in-process
clientset when embedded (tests, single-binary demos).
"""

from __future__ import annotations

import argparse
import io
import json
import re
import sys
from typing import Optional

from ..api import types as api
from ..api.types import kind_for_plural
from ..client.clientset import Clientset
from ..client.remote import RemoteStore
from ..store.store import AlreadyExistsError, NotFoundError

LAST_APPLIED = "kubectl.kubernetes.io/last-applied-configuration"


class _NoYAMLError(Exception):
    """Stands in for ``yaml.YAMLError`` where PyYAML is not installed: no
    code raises it, so an ``except`` naming it catches nothing more."""


class _LazyYAML:
    """PyYAML, imported at its first use."""

    def __getattr__(self, name):
        try:
            import yaml as module
        except ImportError:
            if name == "YAMLError":
                return _NoYAMLError
            raise
        return getattr(module, name)


yaml = _LazyYAML()

# populated from the live subparser table each time main() builds it, so
# `kubectl completion` always reflects the real verb set
ALL_VERBS: list[str] = []


class _AbortMutation(Exception):
    """Raised inside a guaranteed_update mutate to cancel the write: a CLI
    verb that refuses an operation must not commit a no-op revision (a
    spurious MODIFIED event would wake every watcher)."""


class _NoopMutation(Exception):
    """The mutation produced an identical object — report success but skip
    the write (no revision bump, no content-free MODIFIED event)."""


def _update_if_changed(client, name, mutate, namespace):
    """guaranteed_update that aborts when the object comes out unchanged.
    Returns True if a write happened, False on a no-op."""

    def _mutate(obj):
        before = obj.to_dict()
        new = mutate(obj)
        if new.to_dict() == before:
            raise _NoopMutation
        return new

    try:
        client.guaranteed_update(name, _mutate, namespace)
        return True
    except _NoopMutation:
        return False


def _build_subjects(users, groups, serviceaccounts):
    """RBAC subject list from --user/--group/--serviceaccount flags,
    deduplicated, ns:name both halves required (shared by create
    rolebinding/clusterrolebinding and set subject — upstream
    set_subject.go validates identically).  Returns (subjects, error):
    exactly one is non-None."""
    from ..api.rbac import Subject

    subjects: list = []
    seen: set = set()

    def _add(s):
        ident = (s.kind, s.name, s.namespace)
        if ident not in seen:
            seen.add(ident)
            subjects.append(s)

    for u in users:
        _add(Subject(kind="User", name=u))
    for g in groups:
        _add(Subject(kind="Group", name=g))
    for sa in serviceaccounts:
        sa_ns, _, sa_name = sa.partition(":")
        if not sa_ns or not sa_name:
            return None, f"error: --serviceaccount wants ns:name, got {sa!r}\n"
        _add(Subject(kind="ServiceAccount", name=sa_name, namespace=sa_ns))
    if not subjects:
        return None, ("error: at least one of --user/--group/"
                      "--serviceaccount is required\n")
    return subjects, None


def _parse_selector(spec: str):
    """kubectl's selector grammar — the SAME parser the wire API uses
    (``api.selectors.parse_selector_string``: equality, set-based ``in``/
    ``notin``, exists), so ``-l`` accepts exactly what
    ``?labelSelector=`` does.  Returns a LabelSelector or None on a
    malformed (or effectively empty) selector — an empty selector must
    NOT silently mean match-all, because delete -l rides on it."""
    from ..api.selectors import parse_selector_string

    try:
        return parse_selector_string(spec)
    except ValueError:
        return None


def _labels_match(obj, want) -> bool:
    return want.matches(obj.meta.labels)


_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")


def _valid_label_value(v: str) -> bool:
    """``validation.IsValidLabelValue``: ≤63 chars, empty allowed,
    alphanumeric ends with -_. allowed in the middle (label.go
    validates values at parse time; annotate does not)."""
    return len(v) <= 63 and bool(_LABEL_VALUE_RE.match(v))
REVISION_ANNOTATION = api.DEPLOYMENT_REVISION_ANNOTATION


def _jsonpath(doc, expr: str) -> list:
    """The jsonpath subset ``get -o jsonpath=`` actually gets used for
    (reference ``pkg/util/jsonpath``): ``{.a.b}``, ``{.items[2].x}``, and
    ``{.items[*].x}`` fan-out.  Multiple ``{...}`` groups concatenate."""
    import re

    out: list = []
    exprs = re.findall(r"\{([^}]*)\}", expr) or [expr]
    for e in exprs:
        nodes = [doc]
        for part in [p for p in e.strip().lstrip(".").split(".") if p]:
            m = re.fullmatch(r"([^\[\]]*)(?:\[(\*|-?\d+)\])?", part)
            if m is None:
                raise ValueError(f"bad jsonpath segment {part!r}")
            field_name, idx = m.group(1), m.group(2)
            next_nodes = []
            for n in nodes:
                v = n[field_name] if field_name else n
                if idx is None:
                    next_nodes.append(v)
                elif idx == "*":
                    next_nodes.extend(v)
                else:
                    next_nodes.append(v[int(idx)])
            nodes = next_nodes
        out.extend(nodes)
    return out

# kind -> plural resource name, from the one type registry (RESTMapper
# analogue) — new kinds (incl. CRDs) become kubectl-addressable on import.
KIND_TO_RESOURCE = api.KIND_PLURALS

_SHORT_NAMES = {
    "po": "pods",
    "no": "nodes",
    "svc": "services",
    "rs": "replicasets",
    "rc": "replicationcontrollers",
    "deploy": "deployments",
    "netpol": "networkpolicies",
    "ev": "events",
    "ns": "namespaces",
    "ds": "daemonsets",
    "sts": "statefulsets",
    "cj": "cronjobs",
    "hpa": "horizontalpodautoscalers",
    "pdb": "poddisruptionbudgets",
    "pv": "persistentvolumes",
    "pvc": "persistentvolumeclaims",
    "sa": "serviceaccounts",
    "quota": "resourcequotas",
    "cm": "configmaps",
    "ep": "endpoints",
    "limits": "limitranges",
    "pc": "priorityclasses",
    "csr": "certificatesigningrequests",
}


def _resource_aliases() -> dict[str, str]:
    """plural, singular (kind lowercased), and short names all resolve."""
    out = dict(_SHORT_NAMES)
    for kind, plural in KIND_TO_RESOURCE.items():
        out[plural] = plural
        out[kind.lower()] = plural
    return out


def _resolve(resource: str):
    # Alias -> (plural, kind), computed per call so kinds registered
    # after module import (CRD-style) resolve immediately.
    plural = _resource_aliases().get(resource, resource)
    return plural, kind_for_plural(plural)


class Kubectl:
    def __init__(self, clientset: Clientset, out=None):
        self.cs = clientset
        self.out = out or sys.stdout

    def _print(self, *cols_rows) -> None:
        rows = [r for r in cols_rows]
        widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
        for r in rows:
            self.out.write("  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip() + "\n")

    # -- get --watch --------------------------------------------------------
    def get_watch(self, resource: str, namespace: Optional[str] = None,
                  selector: str = "", timeout: float = 30.0) -> int:
        """``kubectl get RES -w``: print the current table, then stream
        event rows until ``timeout`` (the reference streams forever;
        bounded here so scripts and tests terminate)."""
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        want = None
        if selector:
            want = _parse_selector(selector)
            if want is None:
                self.out.write(f"error: bad selector {selector!r}\n")
                return 1
        client = self.cs.client_for(kind)
        ns_scope = namespace if namespace is not None else client.default_namespace
        # LIST at a revision, then WATCH strictly after it: events landing
        # between the table and the stream are never lost
        rev = self._print_table(kind, client, ns_scope, want)
        watch = self.cs.store.watch(kind, from_revision=rev)
        import time as _time

        deadline = _time.monotonic() + timeout
        try:
            while _time.monotonic() < deadline:
                ev = watch.get(timeout=min(0.5, max(0.0, deadline - _time.monotonic())))
                if ev is None:
                    continue
                from ..store.store import WATCH_GAP

                if ev.type == WATCH_GAP:
                    # the stream lost continuity (410 on resume): relist
                    # like the reflector does — reprint the table at the
                    # fresh revision and watch on from there
                    watch.stop()
                    rev = self._print_table(kind, client, ns_scope, want)
                    watch = self.cs.store.watch(kind, from_revision=rev)
                    continue
                obj = api.from_dict(ev.object) if isinstance(ev.object, dict) else ev.object
                # the stream scopes like the table: one namespace (unless
                # the kind is cluster-scoped, where ns is always "")
                if (kind not in api.CLUSTER_SCOPED_KINDS
                        and obj.meta.namespace != ns_scope):
                    continue
                if want is not None and not _labels_match(obj, want):
                    continue
                row = self._row(kind, obj)
                self.out.write(f"{ev.type:<9} " + "  ".join(str(c) for c in row) + "\n")
        finally:
            watch.stop()
        return 0

    def _print_table(self, kind, client, ns_scope, want) -> int:
        """List + filter + print the table; returns the list revision
        (shared by ``get`` and ``get -w``)."""
        objs, rev = client.list(ns_scope)
        if want is not None:
            objs = [o for o in objs if _labels_match(o, want)]
        rows = [self._headers(kind)] + [self._row(kind, o) for o in objs]
        self._print(*rows)
        return rev

    # -- get ---------------------------------------------------------------
    def get(self, resource: str, name: Optional[str] = None, namespace: Optional[str] = None,
            output: str = "", selector: str = "", sort_by: str = "",
            show_labels: bool = False, no_headers: bool = False) -> int:
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        client = self.cs.client_for(kind)
        if name:
            if selector:
                self.out.write("error: a name cannot be combined with -l\n")
                return 1
            try:
                objs = [client.get(name, namespace)]
            except NotFoundError:
                self.out.write(f'Error: {resource} "{name}" not found\n')
                return 1
        else:
            objs, _ = client.list(namespace)
            if selector:
                want = _parse_selector(selector)
                if want is None:
                    self.out.write(f"error: bad selector {selector!r}\n")
                    return 1
                objs = [o for o in objs if _labels_match(o, want)]
        if sort_by:
            # --sort-by '{.spec.nodeName}' (pkg/kubectl sorting_printer.go):
            # numbers sort numerically, everything else as strings
            def _sort_key(vals):
                v = vals[0] if vals else ""
                if isinstance(v, bool):
                    return (1, str(v))
                if isinstance(v, (int, float)):
                    return (0, v)
                try:
                    return (0, float(v))
                except (TypeError, ValueError):
                    return (1, str(v))

            try:
                keyed = [(_sort_key(_jsonpath(o.to_dict(), sort_by)), o)
                         for o in objs]
            except (KeyError, IndexError, TypeError, ValueError) as e:
                self.out.write(f"error: sort-by: {e}\n")
                return 1
            objs = [o for _, o in sorted(keyed, key=lambda kv: kv[0])]
        if output.startswith("custom-columns="):
            # -o custom-columns=HDR:.path,HDR2:.path (custom_column_printer)
            spec = output[len("custom-columns="):]
            cols = []
            for part in spec.split(","):
                hdr, _, path = part.partition(":")
                if not hdr or not path:
                    self.out.write(f"error: bad custom-columns spec {part!r}\n")
                    return 1
                cols.append((hdr, path))
            rows = [] if no_headers else [tuple(h for h, _ in cols)]
            for o in objs:
                doc = o.to_dict()
                row = []
                for _, path in cols:
                    try:
                        vals = _jsonpath(doc, "{" + path + "}")
                        row.append(",".join(str(v) for v in vals) or "<none>")
                    except (KeyError, IndexError, TypeError, ValueError):
                        row.append("<none>")
                rows.append(tuple(row))
            if rows:
                self._print(*rows)
            return 0
        if output == "json":
            docs = [o.to_dict() for o in objs]
            self.out.write(json.dumps(docs[0] if name else {"items": docs}, indent=2) + "\n")
            return 0
        if output == "yaml":
            docs = [o.to_dict() for o in objs]
            self.out.write(yaml.safe_dump(docs[0] if name else {"items": docs}))
            return 0
        if output and output != "wide" and not output.startswith("jsonpath="):
            self.out.write(f"error: unsupported output format {output!r}\n")
            return 1
        if output.startswith("jsonpath="):
            docs = [o.to_dict() for o in objs]
            doc = docs[0] if name else {"items": docs}
            try:
                values = _jsonpath(doc, output[len("jsonpath="):])
            except (KeyError, IndexError, TypeError, ValueError) as e:
                self.out.write(f"error: jsonpath: {e}\n")
                return 1
            self.out.write(" ".join(str(v) for v in values) + "\n")
            return 0
        wide = output == "wide"
        header = self._headers(kind)
        if wide:
            header = header + self._wide_headers(kind)
        if show_labels:
            header = header + ("LABELS",)
        rows = [] if no_headers else [header]
        for o in objs:
            row = self._row(kind, o)
            if wide:
                row = row + self._wide_row(kind, o)
            if show_labels:
                row = row + (",".join(f"{k}={v}" for k, v in sorted(o.meta.labels.items()))
                             or "<none>",)
            rows.append(row)
        if rows:
            self._print(*rows)
        return 0

    def _wide_headers(self, kind: str):
        return {"Pod": ("IP",), "Node": ("ADDRESSES", "CIDR"),
                "Service": ("CLUSTER-IP", "PORTS")}.get(kind, ())

    def _wide_row(self, kind: str, o):
        if kind == "Pod":
            return (o.status.pod_ip or "<none>",)
        if kind == "Node":
            addrs = ",".join(a.get("address", "") for a in o.status.addresses)
            return (addrs or "<none>", o.spec.pod_cidr or "<none>")
        if kind == "Service":
            ports = ",".join(str(p.port) for p in o.ports)
            return (o.cluster_ip or "<none>", ports or "<none>")
        return ()

    def _headers(self, kind: str):
        return {
            "Pod": ("NAME", "STATUS", "NODE", "PRIORITY"),
            "Node": ("NAME", "READY", "UNSCHEDULABLE", "CPU", "MEMORY"),
            "Deployment": ("NAME", "DESIRED", "CURRENT", "UP-TO-DATE", "READY"),
            "ReplicaSet": ("NAME", "DESIRED", "CURRENT", "READY"),
            "Service": ("NAME", "SELECTOR"),
            "Event": ("OBJECT", "TYPE", "REASON", "MESSAGE"),
            "Job": ("NAME", "ACTIVE", "SUCCEEDED", "FAILED"),
            "DaemonSet": ("NAME", "DESIRED", "CURRENT", "READY"),
            "StatefulSet": ("NAME", "DESIRED", "CURRENT", "READY"),
            "Namespace": ("NAME", "STATUS"),
        }.get(kind, ("NAME",))

    def _row(self, kind: str, o):
        if kind == "Pod":
            return (o.meta.name, o.status.phase, o.spec.node_name or "<none>", o.spec.priority)
        if kind == "Node":
            ready = o.status.condition(api.NODE_READY)
            return (
                o.meta.name,
                ready.status if ready else "Unknown",
                o.spec.unschedulable,
                str(o.status.allocatable.get(api.CPU, "")),
                str(o.status.allocatable.get(api.MEMORY, "")),
            )
        if kind == "Deployment":
            return (o.meta.name, o.replicas, o.status_replicas, o.status_updated_replicas,
                    o.status_ready_replicas)
        if kind == "ReplicaSet":
            return (o.meta.name, o.replicas, o.status_replicas, o.status_ready_replicas)
        if kind == "Service":
            return (o.meta.name, ",".join(f"{k}={v}" for k, v in o.selector.items()))
        if kind == "Event":
            return (o.involved_key, o.type, o.reason, o.message[:80])
        if kind == "Job":
            return (o.meta.name, o.status_active, o.status_succeeded, o.status_failed)
        if kind == "DaemonSet":
            return (o.meta.name, o.status_desired, o.status_current, o.status_ready)
        if kind == "StatefulSet":
            return (o.meta.name, o.replicas, o.status_current_replicas, o.status_ready_replicas)
        if kind == "Namespace":
            return (o.meta.name, o.phase)
        return (o.meta.name,)

    # -- describe (pkg/kubectl describe.go: per-kind describers) -----------
    def describe(self, resource: str, name: str, namespace: Optional[str] = None) -> int:
        resource, kind = _resolve(resource)
        try:
            obj = self.cs.client_for(kind).get(name, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        describer = {"Pod": self._describe_pod, "Node": self._describe_node,
                     "Deployment": self._describe_deployment,
                     "Service": self._describe_service}.get(kind)
        if describer is not None:
            describer(obj)
        else:
            self.out.write(yaml.safe_dump(obj.to_dict(), sort_keys=False))
        events, _ = self.cs.events.list()
        related = [e for e in events if e.involved_key.endswith(f"/{name}") or e.involved_key == name]
        if related:
            self.out.write("Events:\n")
            for e in related[-10:]:
                self.out.write(f"  {e.type}\t{e.reason}\t{e.message}\n")
        return 0

    def _kv(self, key: str, value) -> None:
        self.out.write(f"{key + ':':<22}{value}\n")

    def _labels_line(self, labels: dict) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "<none>"

    def _describe_pod(self, pod) -> None:
        self._kv("Name", pod.meta.name)
        self._kv("Namespace", pod.meta.namespace)
        self._kv("Node", pod.spec.node_name or "<none>")
        self._kv("Labels", self._labels_line(pod.meta.labels))
        self._kv("Annotations", self._labels_line(pod.meta.annotations))
        self._kv("Status", pod.status.phase)
        self._kv("IP", pod.status.pod_ip or "<none>")
        if pod.spec.priority:
            self._kv("Priority", pod.spec.priority)
        self.out.write("Containers:\n")
        statuses = {s.name: s for s in pod.status.container_statuses}
        for c in pod.spec.containers:
            self.out.write(f"  {c.name}:\n")
            self.out.write(f"    Image:    {c.image or '<none>'}\n")
            req = ", ".join(f"{k}={v}" for k, v in c.resources.requests.items())
            if req:
                self.out.write(f"    Requests: {req}\n")
            st = statuses.get(c.name)
            if st is not None:
                self.out.write(f"    Ready:    {st.ready}\n")
                self.out.write(f"    Restarts: {st.restart_count}\n")
        if pod.spec.tolerations:
            tols = "; ".join(f"{t.key or '<all>'}:{t.effect or '<all>'}"
                             for t in pod.spec.tolerations)
            self._kv("Tolerations", tols)
        conds = [f"{c.get('type')}={c.get('status')}" for c in pod.status.conditions]
        if conds:
            self._kv("Conditions", ", ".join(conds))

    def _describe_node(self, node) -> None:
        self._kv("Name", node.meta.name)
        self._kv("Labels", self._labels_line(node.meta.labels))
        self._kv("Unschedulable", node.spec.unschedulable)
        if node.spec.taints:
            self._kv("Taints", "; ".join(
                f"{t.key}={t.value}:{t.effect}" for t in node.spec.taints))
        if node.spec.pod_cidr:
            self._kv("PodCIDR", node.spec.pod_cidr)
        conds = [f"{c.type}={c.status}" for c in node.status.conditions]
        self._kv("Conditions", ", ".join(conds) or "<none>")
        self._kv("Capacity", ", ".join(
            f"{k}={v}" for k, v in node.status.capacity.items()))
        self._kv("Allocatable", ", ".join(
            f"{k}={v}" for k, v in node.status.allocatable.items()))
        pods = [p for p in self.cs.pods.list()[0]
                if p.spec.node_name == node.meta.name]
        self.out.write(f"Non-terminated Pods:  ({len(pods)} in total)\n")
        for p in pods[:20]:
            self.out.write(f"  {p.meta.namespace}/{p.meta.name}  {p.status.phase}\n")

    def _describe_deployment(self, dep) -> None:
        self._kv("Name", dep.meta.name)
        self._kv("Namespace", dep.meta.namespace)
        self._kv("Selector", self._labels_line(dep.selector.match_labels))
        self._kv("Replicas", f"{dep.replicas} desired | "
                             f"{dep.status_updated_replicas} updated | "
                             f"{dep.status_replicas} total | "
                             f"{dep.status_ready_replicas} ready")
        self._kv("StrategyType", dep.strategy)
        if dep.strategy == "RollingUpdate":
            self._kv("RollingUpdateStrategy",
                     f"{dep.max_unavailable} max unavailable, "
                     f"{dep.max_surge} max surge")
        images = ", ".join(c.image for c in dep.template.spec.containers if c.image)
        self._kv("Pod Template Image", images or "<none>")
        rses = [rs for rs in self.cs.replicasets.list(dep.meta.namespace)[0]
                if (ref := rs.meta.controller_ref()) is not None
                and ref.uid == dep.meta.uid]
        if rses:
            self._kv("ReplicaSets", ", ".join(
                f"{rs.meta.name} ({rs.status_replicas}/{rs.replicas})"
                for rs in rses))

    def _describe_service(self, svc) -> None:
        self._kv("Name", svc.meta.name)
        self._kv("Namespace", svc.meta.namespace)
        self._kv("Selector", self._labels_line(svc.selector))
        self._kv("Type", svc.type)
        self._kv("IP", svc.cluster_ip or "<none>")
        if svc.status_load_balancer:
            self._kv("LoadBalancer Ingress", ", ".join(svc.status_load_balancer))
        for p in svc.ports:
            self._kv("Port", f"{p.name or '<unset>'}  {p.port}/{p.protocol}"
                             + (f" -> {p.target_port}" if p.target_port else ""))
        try:
            eps = self.cs.endpoints.get(svc.meta.name, svc.meta.namespace)
            addrs = [f"{a.ip}:{p.port}" for s in eps.subsets
                     for a in s.addresses for p in s.ports]
            self._kv("Endpoints", ", ".join(addrs) or "<none>")
        except (NotFoundError, KeyError):
            self._kv("Endpoints", "<none>")

    # -- create / apply / delete ------------------------------------------
    def _load_manifests(self, path: str) -> list[dict]:
        from ..api.scheme import convert_to_internal

        text = sys.stdin.read() if path == "-" else open(path).read()
        # versioned wire documents (apps/v1beta1, extensions/v1beta1,
        # batch/v2alpha1, ...) decode through the scheme — reference-era
        # YAML applies unchanged
        try:
            docs = [json.loads(text)]  # a JSON text is one YAML document
        except ValueError:
            docs = yaml.safe_load_all(text)
        return [convert_to_internal(d) for d in docs if d]

    def create(self, filename: str) -> int:
        from ..admission.framework import AdmissionDenied
        from ..client.remote import ForbiddenError

        rc = 0
        for doc in self._load_manifests(filename):
            kind = doc.get("kind", "")
            if kind not in KIND_TO_RESOURCE:
                self.out.write(f"error: unknown kind {kind!r} in manifest\n")
                rc = 1
                continue
            try:
                obj = self.cs.client_for(kind).create(api.from_dict(doc))
                self.out.write(f"{KIND_TO_RESOURCE[kind]}/{obj.meta.name} created\n")
            except AlreadyExistsError:
                self.out.write(f"Error: {kind} already exists\n")
                rc = 1
            except (AdmissionDenied, ForbiddenError) as e:
                # the reference surfaces admission/authz denials as
                # "Error from server (Forbidden)" — in-proc raises
                # AdmissionDenied, the wire raises ForbiddenError (403)
                self.out.write(f"Error from server (Forbidden): {e}\n")
                rc = 1
        return rc

    def apply(self, filename: str, prune: bool = False,
              selector: str = "") -> int:
        """Declarative apply; with ``--prune -l selector``, objects that
        carry the last-applied annotation, match the selector, and are
        ABSENT from the manifest set are deleted (cmd/apply.go prune —
        same guard rails: never touches objects apply didn't create)."""
        applied: set[tuple[str, str, str]] = set()  # (kind, ns, name)
        want = None
        if prune:
            if not selector:
                self.out.write("error: --prune requires -l selector\n")
                return 1
            want = _parse_selector(selector)
            if want is None:
                self.out.write(f"error: bad selector {selector!r}\n")
                return 1
        for doc in self._load_manifests(filename):
            kind = doc.get("kind", "")
            if kind not in KIND_TO_RESOURCE:
                self.out.write(f"error: unknown kind {kind!r} in manifest\n")
                return 1
            client = self.cs.client_for(kind)
            manifest = json.dumps(doc, sort_keys=True)
            meta = doc.get("metadata") or {}
            name = meta.get("name", "")
            ns = meta.get("namespace", client.default_namespace)
            applied.add((kind, ns, name))
            try:
                cur = client.get(name, ns)
            except (NotFoundError, KeyError):
                obj = api.from_dict(doc)
                obj.meta.annotations[LAST_APPLIED] = manifest
                client.create(obj)
                self.out.write(f"{KIND_TO_RESOURCE[kind]}/{name} created\n")
                continue
            if cur.meta.annotations.get(LAST_APPLIED) == manifest:
                self.out.write(f"{KIND_TO_RESOURCE[kind]}/{name} unchanged\n")
                continue

            def _merge(live):
                desired = api.from_dict(doc)
                desired.meta = live.meta  # preserve cluster-owned identity
                desired.meta.labels = dict((doc.get("metadata") or {}).get("labels") or {})
                desired.meta.annotations = dict(live.meta.annotations)
                desired.meta.annotations[LAST_APPLIED] = manifest
                if hasattr(live, "status"):
                    desired.status = live.status  # status is cluster-owned
                return desired

            client.guaranteed_update(name, _merge, ns)
            self.out.write(f"{KIND_TO_RESOURCE[kind]}/{name} configured\n")
        if want is not None:
            self._prune(applied, want)
        return 0

    def _prune(self, applied: set, want) -> None:
        """Delete previously-applied, selector-matching objects absent
        from this apply set.  Scope: every kind that appeared in the
        manifests, and for namespaced kinds ONLY the namespaces the
        manifests touched — pruning is destructive, so it must never
        reach into a namespace the apply set never mentioned (the
        reference's prune visits only the apply set's namespaces;
        cluster-scoped kinds have no namespace guard)."""
        namespaces = sorted({ns for _, ns, _ in applied})
        for kind in {k for k, _, _ in applied}:
            client = self.cs.client_for(kind)
            scopes = [None] if kind in api.CLUSTER_SCOPED_KINDS else namespaces
            for scope in scopes:
                for obj in client.list(scope)[0]:
                    ident = (kind, obj.meta.namespace, obj.meta.name)
                    if ident in applied:
                        continue
                    if LAST_APPLIED not in obj.meta.annotations:
                        continue  # apply never owned it; never prune it
                    if not _labels_match(obj, want):
                        continue
                    try:
                        client.delete(obj.meta.name, obj.meta.namespace)
                    except NotFoundError:
                        continue
                    self.out.write(
                        f"{KIND_TO_RESOURCE[kind]}/{obj.meta.name} pruned\n")

    # -- apply *-last-applied (cmd/apply_{view,set,edit}_last_applied.go) --
    def _get_for_last_applied(self, resource: str, name: str,
                              namespace: Optional[str]):
        """(client, obj, display) or None after writing the error."""
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return None
        client = self.cs.client_for(kind)
        try:
            return client, client.get(name, namespace), f"{resource}/{name}"
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return None

    def apply_view_last_applied(self, resource: str, name: str,
                                namespace: Optional[str] = None,
                                output: str = "yaml") -> int:
        if output not in ("yaml", "json"):
            self.out.write(f"error: unexpected -o output mode {output!r} "
                           f"(yaml|json)\n")
            return 1
        got = self._get_for_last_applied(resource, name, namespace)
        if got is None:
            return 1
        _, obj, display = got
        raw = obj.meta.annotations.get(LAST_APPLIED)
        if raw is None:
            self.out.write(
                f"error: no last-applied-configuration annotation found on "
                f"{display}\n")
            return 1
        doc = json.loads(raw)
        if output == "json":
            self.out.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
        else:
            self.out.write(yaml.safe_dump(doc, sort_keys=False))
        return 0

    def _write_last_applied(self, client, name: str, ns, manifest: str) -> None:
        """Annotation write through the no-op guard: an unchanged
        annotation must not commit a revision and wake every watcher."""

        def _set(live):
            live.meta.annotations[LAST_APPLIED] = manifest
            return live

        _update_if_changed(client, name, _set, ns)

    def apply_set_last_applied(self, filename: str,
                               create_annotation: bool = False) -> int:
        """Overwrite each manifest object's last-applied annotation with
        the file's content; absent annotations are an error unless
        --create-annotation (the reference's guard: set-last-applied on
        an object apply never owned is usually a mistake)."""
        try:
            docs = self._load_manifests(filename)  # scheme-converted, like apply
        except (OSError, yaml.YAMLError) as e:
            self.out.write(f"error: {e}\n")
            return 1
        for doc in docs:
            kind = doc.get("kind", "")
            if kind not in KIND_TO_RESOURCE:
                self.out.write(f"error: unknown kind {kind!r}\n")
                return 1
            meta = doc.get("metadata") or {}
            name = meta.get("name", "")
            client = self.cs.client_for(kind)
            ns = meta.get("namespace", client.default_namespace)
            manifest = json.dumps(doc, sort_keys=True)
            try:
                cur = client.get(name, ns)
            except (NotFoundError, KeyError):
                self.out.write(f'Error: {KIND_TO_RESOURCE[kind]} "{name}" '
                               f'not found\n')
                return 1
            if LAST_APPLIED not in cur.meta.annotations and not create_annotation:
                self.out.write(
                    f"error: {KIND_TO_RESOURCE[kind]}/{name} has no "
                    f"last-applied-configuration annotation; use "
                    f"--create-annotation to set one\n")
                return 1
            self._write_last_applied(client, name, ns, manifest)
            self.out.write(f"{KIND_TO_RESOURCE[kind]}/{name} configured\n")
        return 0

    def apply_edit_last_applied(self, resource: str, name: str,
                                namespace: Optional[str] = None) -> int:
        """annotation -> $EDITOR -> annotation (never touches the live
        spec; the next apply's 3-way merge consumes the edit)."""
        import os
        import subprocess
        import tempfile

        got = self._get_for_last_applied(resource, name, namespace)
        if got is None:
            return 1
        client, obj, display = got
        raw = obj.meta.annotations.get(LAST_APPLIED)
        if raw is None:
            self.out.write(
                f"error: no last-applied-configuration annotation found on "
                f"{display}\n")
            return 1
        editor = os.environ.get("EDITOR", "vi")
        with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
            yaml.safe_dump(json.loads(raw), f, sort_keys=False)
            tmp = f.name
        try:
            rc = subprocess.run([*editor.split(), tmp]).returncode
        except OSError as e:
            os.unlink(tmp)
            self.out.write(f"error: cannot run editor {editor!r}: {e}\n")
            return 1
        if rc != 0:
            os.unlink(tmp)
            self.out.write("Edit cancelled\n")
            return 1
        try:
            edited = yaml.safe_load(open(tmp).read())
        except yaml.YAMLError as e:
            self.out.write(f"error: edited file is not valid YAML: {e}\n"
                           f"your changes are preserved in {tmp}\n")
            return 1
        if not isinstance(edited, dict) or not edited:
            self.out.write(f"error: edited content must be a non-empty "
                           f"mapping; your changes are preserved in {tmp}\n")
            return 1
        original = json.loads(raw)
        if edited.get("kind") != original.get("kind") or (
                (edited.get("metadata") or {}).get("name")
                != (original.get("metadata") or {}).get("name")):
            self.out.write(
                f"error: kind and metadata.name may not change in "
                f"edit-last-applied; your changes are preserved in {tmp}\n")
            return 1
        os.unlink(tmp)
        self._write_last_applied(client, name, obj.meta.namespace,
                                 json.dumps(edited, sort_keys=True))
        self.out.write(f"{display} edited\n")
        return 0

    def delete(self, resource: str, name: Optional[str], namespace: Optional[str] = None,
               selector: str = "", cascade: str = "background") -> int:
        if name and selector:
            self.out.write("error: a name cannot be combined with -l\n")
            return 1
        if selector and not name:
            resource2, kind = _resolve(resource)
            if kind is None:
                self.out.write(f"error: unknown resource {resource!r}\n")
                return 1
            want = _parse_selector(selector)
            if want is None:
                self.out.write(f"error: bad selector {selector!r}\n")
                return 1
            client = self.cs.client_for(kind)
            # scope like every other verb: the default namespace, never
            # all-namespaces implicitly (delete is irreversible)
            ns_scope = namespace if namespace is not None else client.default_namespace
            victims = [o for o in client.list(ns_scope)[0] if _labels_match(o, want)]
            for o in victims:
                try:
                    client.delete(o.meta.name, o.meta.namespace)
                    self.out.write(f"{resource2}/{o.meta.name} deleted\n")
                except NotFoundError:
                    pass
            if not victims:
                self.out.write("No resources found\n")
            return 0
        return self._delete_one(resource, name, namespace, cascade)

    def _delete_one(self, resource: str, name: str, namespace: Optional[str] = None,
                    cascade: str = "background") -> int:
        resource, kind = _resolve(resource)
        client = self.cs.client_for(kind)
        try:
            if cascade == "orphan":
                # the orphan finalizer makes the GC release dependents
                # instead of cascading (graph_builder orphanDependents)
                def _mark(obj):
                    if "orphan" not in obj.meta.finalizers:
                        obj.meta.finalizers.append("orphan")
                    return obj

                client.guaranteed_update(name, _mark, namespace)
            client.delete(name, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} deleted\n")
        return 0

    def top_pods(self, namespace: Optional[str] = None) -> int:
        """``kubectl top pods``: per-pod memory from each node's kubelet
        stats endpoint (the heapster/metricsutil path at this depth)."""
        import json as _json
        import urllib.request

        from concurrent.futures import ThreadPoolExecutor

        rows = [("NAME", "NODE", "MEMORY")]
        ns = namespace or "default"
        nodes = [n for n in self.cs.nodes.list()[0] if n.status.kubelet_url]

        def fetch(node):
            try:
                with urllib.request.urlopen(
                    f"{node.status.kubelet_url}/stats/summary", timeout=5
                ) as r:
                    return node, _json.loads(r.read()), None
            except Exception as e:  # noqa: BLE001 - reported per node below
                return node, None, e

        unreachable = []
        with ThreadPoolExecutor(max_workers=16) as pool:
            for node, summary, err in pool.map(fetch, nodes):
                if err is not None:
                    unreachable.append((node.meta.name, err))
                    continue
                for entry in summary.get("pods", []):
                    ref = entry.get("podRef") or {}
                    if ref.get("namespace") != ns:
                        continue
                    mib = (entry.get("memory") or {}).get("usageBytes", 0) // (1 << 20)
                    rows.append((ref.get("name", ""), node.meta.name, f"{mib}Mi"))
        self._print(*rows)
        for name, err in unreachable:
            self.out.write(f"warning: could not fetch stats from node {name}: {err}\n")
        return 0 if len(rows) > 1 or not unreachable else 1

    # -- rollout (cmd/rollout, rollback.go) --------------------------------
    def _dep_and_rses(self, name: str, namespace: Optional[str]):
        dep = self.cs.deployments.get(name, namespace)
        rses = []
        for rs in self.cs.replicasets.list(namespace or "default")[0]:
            ref = rs.meta.controller_ref()
            if ref is not None and ref.kind == "Deployment" and ref.uid == dep.meta.uid:
                rses.append(rs)
        return dep, rses

    def rollout_status(self, name: str, namespace: Optional[str] = None) -> int:
        """``kubectl rollout status deployment NAME``: 0 when the rollout
        is complete, 1 while in progress (the reference polls; one shot
        here — loops live in the caller)."""
        try:
            dep, _ = self._dep_and_rses(name, namespace)
        except NotFoundError:
            self.out.write(f'Error: deployment "{name}" not found\n')
            return 1
        # completion also requires the CURRENT template's RS to be fully
        # rolled out — aggregate counters alone go stale the instant the
        # spec changes (reference guards with observedGeneration +
        # updatedReplicas-of-current-template)
        from ..controllers.deployment import template_hash

        want_hash = template_hash(dep.template)
        cur_rs = next(
            (rs for rs in self._dep_and_rses(name, namespace)[1]
             if rs.meta.labels.get("pod-template-hash") == want_hash),
            None,
        )
        if (
            cur_rs is not None
            and cur_rs.status_ready_replicas >= dep.replicas
            and dep.status_updated_replicas >= dep.replicas
            and dep.status_ready_replicas >= dep.replicas
            and dep.status_replicas == dep.replicas
        ):
            self.out.write(f'deployment "{name}" successfully rolled out\n')
            return 0
        self.out.write(
            f"Waiting for rollout: {dep.status_updated_replicas} of "
            f"{dep.replicas} updated, {dep.status_ready_replicas} ready\n"
        )
        return 1

    def rollout_history(self, name: str, namespace: Optional[str] = None) -> int:
        try:
            dep, rses = self._dep_and_rses(name, namespace)
        except NotFoundError:
            self.out.write(f'Error: deployment "{name}" not found\n')
            return 1
        self.out.write(f"deployment/{name}\nREVISION  REPLICASET\n")
        for rs in sorted(
            rses, key=lambda r: int(r.meta.annotations.get(REVISION_ANNOTATION, "0"))
        ):
            rev = rs.meta.annotations.get(REVISION_ANNOTATION, "0")
            self.out.write(f"{rev:<9} {rs.meta.name}\n")
        return 0

    def rollout_pause(self, name: str, pause: bool,
                      namespace: Optional[str] = None) -> int:
        """``kubectl rollout pause|resume`` (cmd/rollout/rollout_pause.go):
        flip spec.paused; the deployment controller reconciles scale but
        freezes rollout progress while paused."""
        def _mutate(dep):
            if dep.paused == pause:
                raise _AbortMutation
            dep.paused = pause
            return dep

        verb = "paused" if pause else "resumed"
        try:
            _update_if_changed(self.cs.deployments, name, _mutate, namespace)
        except _AbortMutation:
            self.out.write(f"error: deployment/{name} is already {verb}\n")
            return 1
        except (NotFoundError, KeyError):
            self.out.write(f'Error: deployment "{name}" not found\n')
            return 1
        self.out.write(f"deployment/{name} {verb}\n")
        return 0

    def rollout_undo(self, name: str, namespace: Optional[str] = None,
                     to_revision: int = 0) -> int:
        """``rollback.go``: re-apply the target revision's template (the
        previous one by default); the controller's hash matching then
        treats that RS as new again and bumps its revision."""
        try:
            dep, rses = self._dep_and_rses(name, namespace)
        except NotFoundError:
            self.out.write(f'Error: deployment "{name}" not found\n')
            return 1
        by_rev = {
            int(rs.meta.annotations.get(REVISION_ANNOTATION, "0")): rs for rs in rses
        }
        if not by_rev:
            self.out.write("error: no rollout history\n")
            return 1
        if to_revision:
            target = by_rev.get(to_revision)
            if target is None:
                self.out.write(f"error: revision {to_revision} not found\n")
                return 1
        else:
            revs = sorted(by_rev)
            if len(revs) < 2:
                self.out.write("error: no previous revision\n")
                return 1
            target = by_rev[revs[-2]]

        template = api.PodTemplateSpec.from_dict(target.template.to_dict())
        template.labels.pop("pod-template-hash", None)

        def _rollback(cur):
            cur.template = template
            return cur

        self.cs.deployments.guaranteed_update(name, _rollback, namespace)
        self.out.write(f"deployment/{name} rolled back\n")
        return 0

    def _kubelet_target(self, name: str, ns: str, container: str):
        """In-proc path resolution: pod -> node -> kubelet URL + container.
        Returns (url_base, container) or None after printing the error."""
        try:
            pod = self.cs.pods.get(name, ns)
        except NotFoundError:
            self.out.write(f'Error: pod "{name}" not found\n')
            return None
        if not pod.spec.node_name:
            self.out.write("error: pod is not scheduled yet\n")
            return None
        try:
            node = self.cs.nodes.get(pod.spec.node_name)
        except NotFoundError:
            self.out.write(f'error: node "{pod.spec.node_name}" not found\n')
            return None
        if not node.status.kubelet_url:
            self.out.write("error: node exposes no kubelet endpoint\n")
            return None
        c = container or (pod.spec.containers[0].name if pod.spec.containers else "")
        return node.status.kubelet_url, c, pod.spec.node_name

    def logs_follow(self, name: str, namespace: Optional[str] = None,
                    container: str = "", timeout: float = 10.0,
                    poll: float = 0.2, tail: int = 0) -> int:
        """``kubectl logs -f [--tail N]``: the last N existing lines (all
        when N=0), then new lines as they appear (the reference streams
        the kubelet's follow; a bounded poll here so scripts terminate)."""
        import time as _time

        seen = 0
        first = True
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            buf = io.StringIO()
            sub = Kubectl(self.cs, out=buf)
            if sub.logs(name, namespace, container) != 0:
                self.out.write(buf.getvalue())
                return 1
            lines = buf.getvalue().splitlines()
            if first and tail:
                # --tail bounds the backlog; everything AFTER it follows
                start = max(0, len(lines) - tail)
            else:
                start = seen
            for line in lines[start:]:
                self.out.write(line + "\n")
            seen = len(lines)
            first = False
            _time.sleep(poll)
        return 0

    def logs(self, name: str, namespace: Optional[str] = None,
             container: str = "", tail: int = 0) -> int:
        """``kubectl logs`` via the pod/log subresource (apiserver proxies
        to the owning node's kubelet read API)."""
        import urllib.error
        import urllib.request

        ns = namespace or "default"
        base = getattr(self.cs.store, "base_url", None)
        try:
            if base is None:
                # in-proc clientset: reach the kubelet URL directly
                resolved = self._kubelet_target(name, ns, container)
                if resolved is None:
                    return 1
                kubelet_url, c, _ = resolved
                url = f"{kubelet_url}/containerLogs/{ns}/{name}/{c}"
                if tail:
                    url += f"?tailLines={tail}"
                with urllib.request.urlopen(url, timeout=10) as r:
                    self.out.write(r.read().decode())
            else:
                path = f"/api/v1/namespaces/{ns}/pods/{name}/log"
                sep = "?"
                if container:
                    path += f"{sep}container={container}"
                    sep = "&"
                if tail:
                    path += f"{sep}tailLines={tail}"
                # through the store: same credential AND same TLS context
                self.out.write(self.cs.store.raw("GET", path).decode())
            return 0
        except urllib.error.HTTPError as e:
            self.out.write(f"error: {e.read().decode()}\n")
            return 1
        except Exception as e:
            self.out.write(f"error: {e}\n")
            return 1

    def exec(self, name: str, command: list[str], namespace: Optional[str] = None,
             container: str = "") -> int:
        """``kubectl exec POD -- cmd...`` via the pods/exec subresource."""
        import json as _json
        import urllib.error
        import urllib.request

        ns = namespace or "default"
        base = getattr(self.cs.store, "base_url", None)
        try:
            if base is None:
                resolved = self._kubelet_target(name, ns, container)
                if resolved is None:
                    return 1
                kubelet_url, c, exec_node = resolved
                # direct kubelet path: mint the cluster-key exec credential
                from ..auth.authn import kubelet_exec_token

                req = urllib.request.Request(
                    f"{kubelet_url}/exec/{ns}/{name}/{c}",
                    data=_json.dumps({"command": command}).encode(),
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {kubelet_exec_token(exec_node)}"},
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=30) as r:
                    out = _json.loads(r.read())
            else:
                path = f"/api/v1/namespaces/{ns}/pods/{name}/exec"
                if container:
                    path += f"?container={container}"
                out = _json.loads(self.cs.store.raw(
                    "POST", path, body={"command": command}, timeout=30))
        except urllib.error.HTTPError as e:
            self.out.write(f"error: {e.read().decode()}\n")
            return 1
        except Exception as e:
            self.out.write(f"error: {e}\n")
            return 1
        if out.get("stdout"):
            self.out.write(out["stdout"] + ("\n" if not out["stdout"].endswith("\n") else ""))
        return int(out.get("exitCode", 0))

    # -- scale / cordon / drain -------------------------------------------
    def scale(self, resource: str, name: str, replicas: int, namespace: Optional[str] = None) -> int:
        resource, kind = _resolve(resource)
        # the reference scaler set (kubectl/scale.go): Deployment, RS,
        # RC, StatefulSet (Job scales by parallelism, not supported here)
        if kind not in ("Deployment", "ReplicaSet", "ReplicationController",
                        "StatefulSet"):
            self.out.write(f"error: cannot scale {resource}\n")
            return 1

        def _scale(obj):
            obj.replicas = replicas
            return obj

        try:
            self.cs.client_for(kind).guaranteed_update(name, _scale, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} scaled to {replicas}\n")
        return 0

    def cordon(self, name: str, on: bool = True) -> int:
        def _set(node):
            node.spec.unschedulable = on
            return node

        try:
            self.cs.nodes.guaranteed_update(name, _set, "")
        except (NotFoundError, KeyError):
            self.out.write(f'Error: node "{name}" not found\n')
            return 1
        self.out.write(f"node/{name} {'cordoned' if on else 'uncordoned'}\n")
        return 0

    def drain(self, name: str, ignore_daemonsets: bool = False,
              force: bool = False) -> int:
        """cordon + evict every pod on the node (cmd/drain.go), with the
        reference's safety rails: DaemonSet pods are skipped only with
        --ignore-daemonsets (the DS controller would just recreate them),
        and UNMANAGED pods (no controller owner) abort the drain unless
        --force — they would not come back anywhere else."""
        pods, _ = self.cs.pods.list()
        mine = [p for p in pods if p.spec.node_name == name]
        ds_pods = [p for p in mine
                   if (ref := p.meta.controller_ref()) is not None
                   and ref.kind == "DaemonSet"]
        unmanaged = [p for p in mine if p.meta.controller_ref() is None]
        if ds_pods and not ignore_daemonsets:
            names = ", ".join(p.meta.name for p in ds_pods[:5])
            self.out.write(f"error: cannot delete DaemonSet-managed pods "
                           f"({names}); use --ignore-daemonsets\n")
            return 1
        if unmanaged and not force:
            names = ", ".join(p.meta.name for p in unmanaged[:5])
            self.out.write(f"error: cannot delete pods not managed by a "
                           f"controller ({names}); use --force\n")
            return 1
        rc = self.cordon(name, True)
        if rc:
            return rc
        skip = {p.meta.key for p in ds_pods}
        for pod in mine:
            if pod.meta.key in skip:
                self.out.write(f"pod/{pod.meta.name} ignored (DaemonSet-managed)\n")
                continue
            try:
                self.cs.pods.delete(pod.meta.name, pod.meta.namespace)
                self.out.write(f"pod/{pod.meta.name} evicted\n")
            except NotFoundError:
                pass
        self.out.write(f"node/{name} drained\n")
        return 0

    def top_nodes(self) -> int:
        nodes, _ = self.cs.nodes.list()
        pods, _ = self.cs.pods.list()
        from ..scheduler.units import CPU_MILLI, MEM_MIB, pod_request_vec

        usage: dict[str, list[int]] = {}
        for p in pods:
            if p.spec.node_name:
                vec = pod_request_vec(p)
                u = usage.setdefault(p.spec.node_name, [0, 0])
                u[0] += vec[CPU_MILLI]
                u[1] += vec[MEM_MIB]
        rows = [("NAME", "CPU(requested)", "MEMORY(requested)")]
        for n in nodes:
            u = usage.get(n.meta.name, [0, 0])
            rows.append((n.meta.name, f"{u[0]}m", f"{u[1]}Mi"))
        self._print(*rows)
        return 0

    # -- label / annotate (cmd/label.go, cmd/annotate.go) ------------------
    def _set_map(self, resource: str, name: Optional[str], pairs: list[str],
                 which: str, namespace: Optional[str], overwrite: bool,
                 resource_version: str = "", selector: str = "",
                 all_resources: bool = False) -> int:
        """Shared engine for label/annotate: "k=v" sets, "k-" removes.
        Reference semantics (``label.go:99 RunLabel`` /
        ``annotate.go:180 RunAnnotate``): setting an existing key without
        --overwrite is an error; removing an absent key prints
        ``label %q not found.`` but succeeds; the same key may not be
        both set and removed; --resource-version makes the update
        conditional on the object being at exactly that version (and is
        only valid against a single resource); --all / -l select every
        matching object of the type."""
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        sets, removes = {}, []
        for p in pairs:
            if p.endswith("-") and "=" not in p:
                removes.append(p[:-1])
            elif "=" in p:
                k, v = p.split("=", 1)
                if which == "labels" and not _valid_label_value(v):
                    self.out.write(f"error: invalid label value: {p!r}\n")
                    return 1
                sets[k] = v
            else:
                self.out.write(f"error: expected KEY=VALUE or KEY-, got {p!r}\n")
                return 1
        both = [k for k in removes if k in sets]
        if both:
            noun = "a label" if which == "labels" else "an annotation"
            self.out.write(f"error: can not both modify and remove {noun} "
                           f"in the same command\n")
            return 1
        if not sets and not removes:
            self.out.write(f"error: at least one {which[:-1]} update is required\n")
            return 1

        client = self.cs.client_for(kind)
        if all_resources or selector:
            if name:
                # the reference rejects a name combined with --all/-l
                # rather than silently fanning out past it
                self.out.write("error: a resource name may not be specified "
                               "together with --all or a selector\n")
                return 1
            if resource_version:
                self.out.write("error: --resource-version may only be used "
                               "with a single resource\n")
                return 1
            want = None
            if selector:
                want = _parse_selector(selector)
                if want is None:
                    self.out.write(f"error: bad selector {selector!r}\n")
                    return 1
            ns_scope = namespace if namespace is not None else client.default_namespace
            objs, _ = client.list(ns_scope)
            if want is not None:
                objs = [o for o in objs if _labels_match(o, want)]
            names = [o.meta.name for o in objs]
        elif name:
            names = [name]
        else:
            self.out.write("error: one or more resources must be specified "
                           "as <resource> <name> or <resource>/<name>\n")
            return 1

        verbed = "labeled" if which == "labels" else "annotated"
        failed = 0  # the reference visitor continues over the remaining
        # objects on a per-object error and aggregates — bulk runs must
        # not stop half-written
        for nm in names:
            err = []
            absent: set = set()  # collected here: guaranteed_update may
            # retry _mutate on a CAS conflict, and the message must not
            # print once per attempt

            def _mutate(obj):
                if resource_version and \
                        str(obj.meta.resource_version) != str(resource_version):
                    err.append(("conflict", obj.meta.resource_version))
                    raise _AbortMutation
                m = getattr(obj.meta, which)
                if not overwrite:
                    clobbered = [k for k, v in sets.items()
                                 if k in m and m[k] != v]
                    if clobbered:
                        err.append(("overwrite", clobbered[0]))
                        raise _AbortMutation
                absent.clear()
                absent.update(k for k in removes if k not in m)
                m.update(sets)
                for k in removes:
                    m.pop(k, None)
                return obj

            try:
                wrote = _update_if_changed(client, nm, _mutate, namespace)
                for k in sorted(absent):
                    self.out.write(f"{which[:-1]} \"{k}\" not found.\n")
            except _AbortMutation:
                why, detail = err[0]
                if why == "conflict":
                    self.out.write(
                        f"Error from server (Conflict): {resource} \"{nm}\" "
                        f"has been modified (resource version {detail}, "
                        f"requested {resource_version})\n")
                else:
                    self.out.write(
                        f"error: {resource} \"{nm}\": {detail!r} already has "
                        f"a value; use --overwrite\n")
                failed += 1
                continue
            except (NotFoundError, KeyError):
                self.out.write(f'Error: {resource} "{nm}" not found\n')
                failed += 1
                continue
            self.out.write(f"{resource}/{nm} "
                           f"{verbed if wrote else 'not ' + verbed}\n")
        return 1 if failed else 0

    def label(self, resource: str, name: Optional[str], pairs: list[str],
              namespace: Optional[str] = None, overwrite: bool = False,
              resource_version: str = "", selector: str = "",
              all_resources: bool = False) -> int:
        return self._set_map(resource, name, pairs, "labels", namespace,
                             overwrite, resource_version, selector,
                             all_resources)

    def annotate(self, resource: str, name: Optional[str], pairs: list[str],
                 namespace: Optional[str] = None, overwrite: bool = False,
                 resource_version: str = "", selector: str = "",
                 all_resources: bool = False) -> int:
        return self._set_map(resource, name, pairs, "annotations", namespace,
                             overwrite, resource_version, selector,
                             all_resources)

    # -- patch (cmd/patch.go) ----------------------------------------------
    def patch(self, resource: str, name: str, patch: str,
              namespace: Optional[str] = None, patch_type: str = "merge") -> int:
        """``kubectl patch``: merge (RFC 7386 recursive merge, null
        deletes) or json (RFC 6902 add/replace/remove) against the
        object's wire form, re-decoded through the type registry."""
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        try:
            doc = json.loads(patch)
        except json.JSONDecodeError as e:
            self.out.write(f"error: bad patch: {e}\n")
            return 1

        errors = []

        from ..api.patch import apply_patch

        def _mutate(obj):
            wire = obj.to_dict()
            try:
                patched = apply_patch(wire, doc, patch_type)
            except (KeyError, IndexError, ValueError, TypeError) as e:
                errors.append(str(e))
                raise _AbortMutation from e
            new = type(obj).from_dict(patched)
            new.meta.uid = obj.meta.uid  # identity is cluster-owned
            new.meta.resource_version = obj.meta.resource_version
            return new

        try:
            wrote = _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except _AbortMutation:
            self.out.write(f"error: cannot apply patch: {errors[0]}\n")
            return 1
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} patched"
                       f"{'' if wrote else ' (no change)'}\n")
        return 0

    # -- taint (cmd/taint.go) ----------------------------------------------
    def taint(self, name: str, specs: list[str]) -> int:
        """``kubectl taint nodes NAME key=value:Effect`` / ``key:Effect-``
        (removal).  Same key+effect replaces (with the reference's
        "overwrite" message)."""
        adds, removes = [], []
        for spec in specs:
            if spec.endswith("-"):
                body = spec[:-1]
                kv, _, effect = body.partition(":")
                key = kv.split("=", 1)[0]
                removes.append((key, effect))
                continue
            body, _, effect = spec.partition(":")
            if not effect:
                self.out.write(f"error: taint {spec!r} must specify an effect\n")
                return 1
            key, _, value = body.partition("=")
            adds.append(api.Taint(key=key, value=value, effect=effect))
        msgs = []
        missing = []

        def _mutate(node):
            msgs.clear()
            missing.clear()
            taints = list(node.spec.taints)
            for t in adds:
                before = len(taints)
                taints = [x for x in taints if not (x.key == t.key and x.effect == t.effect)]
                msgs.append("modified" if len(taints) != before else "tainted")
                taints.append(t)
            for key, effect in removes:
                kept = [x for x in taints
                        if not (x.key == key and (not effect or x.effect == effect))]
                if len(kept) == len(taints):
                    missing.append(f"{key}:{effect}" if effect else key)
                else:
                    msgs.append("untainted")
                taints = kept
            if missing:
                raise _AbortMutation
            node.spec.taints = taints
            return node

        try:
            wrote = _update_if_changed(self.cs.nodes, name, _mutate, "")
        except _AbortMutation:
            self.out.write(f"error: taint {missing[0]!r} not found\n")
            return 1
        except (NotFoundError, KeyError):
            self.out.write(f'Error: node "{name}" not found\n')
            return 1
        self.out.write(f"node/{name} {msgs[-1] if wrote and msgs else 'unchanged'}\n")
        return 0

    # -- expose / run / autoscale (imperative generators) ------------------
    def expose(self, resource: str, name: str, port: int, target_port: int = 0,
               svc_type: str = "ClusterIP", svc_name: str = "",
               namespace: Optional[str] = None) -> int:
        """``kubectl expose``: generate a Service selecting the workload's
        pods (reference ``cmd/expose.go`` + service generators)."""
        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet", "Service", "Pod"):
            self.out.write(f"error: cannot expose {resource}\n")
            return 1
        try:
            obj = self.cs.client_for(kind).get(name, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        if kind == "Deployment" or kind == "ReplicaSet":
            selector = dict(obj.selector.match_labels)
        elif kind == "Service":
            selector = dict(obj.selector)
        else:  # Pod
            selector = dict(obj.meta.labels)
        if not selector:
            self.out.write("error: couldn't find a selector to expose\n")
            return 1
        svc = api.Service(
            meta=api.ObjectMeta(name=svc_name or name,
                                namespace=namespace or obj.meta.namespace or "default"),
            selector=selector,
            ports=[api.ServicePort(port=port, target_port=target_port or port)],
            type=svc_type,
        )
        try:
            self.cs.services.create(svc)
        except AlreadyExistsError:
            self.out.write(f'Error: service "{svc.meta.name}" already exists\n')
            return 1
        self.out.write(f"service/{svc.meta.name} exposed\n")
        return 0

    def run(self, name: str, image: str, replicas: int = 1, restart: str = "Always",
            namespace: Optional[str] = None, labels: Optional[str] = None) -> int:
        """``kubectl run`` (reference ``cmd/run.go`` generator ladder):
        restart=Always → Deployment, OnFailure → Job, Never → bare Pod."""
        lbls = dict(p.split("=", 1) for p in (labels or "").split(",") if "=" in p)
        lbls.setdefault("run", name)
        ns = namespace or "default"
        container = api.Container(name=name, image=image)
        try:
            if restart == "Always":
                dep = api.Deployment(
                    meta=api.ObjectMeta(name=name, namespace=ns, labels=dict(lbls)),
                    replicas=replicas,
                    selector=api.LabelSelector.from_match_labels(dict(lbls)),
                    template=api.PodTemplateSpec(
                        labels=dict(lbls), spec=api.PodSpec(containers=[container])),
                )
                self.cs.deployments.create(dep)
                self.out.write(f"deployment/{name} created\n")
            elif restart == "OnFailure":
                from ..api.apps import Job

                job = Job(
                    meta=api.ObjectMeta(name=name, namespace=ns, labels=dict(lbls)),
                    selector=api.LabelSelector.from_match_labels(dict(lbls)),
                    template=api.PodTemplateSpec(
                        labels=dict(lbls),
                        spec=api.PodSpec(containers=[container], restart_policy="OnFailure")),
                )
                self.cs.client_for("Job").create(job)
                self.out.write(f"job/{name} created\n")
            elif restart == "Never":
                pod = api.Pod(
                    meta=api.ObjectMeta(name=name, namespace=ns, labels=dict(lbls)),
                    spec=api.PodSpec(containers=[container], restart_policy="Never"),
                )
                self.cs.pods.create(pod)
                self.out.write(f"pod/{name} created\n")
            else:
                self.out.write(f"error: invalid --restart {restart!r}\n")
                return 1
        except AlreadyExistsError:
            self.out.write(f'Error: "{name}" already exists\n')
            return 1
        return 0

    def autoscale(self, resource: str, name: str, min_replicas: int, max_replicas: int,
                  cpu_percent: int = 80, namespace: Optional[str] = None) -> int:
        """``kubectl autoscale``: generate an HPA targeting the workload."""
        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet"):
            self.out.write(f"error: cannot autoscale {resource}\n")
            return 1
        try:
            obj = self.cs.client_for(kind).get(name, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        from ..api.cluster import HorizontalPodAutoscaler

        hpa = HorizontalPodAutoscaler(
            meta=api.ObjectMeta(name=name,
                                namespace=namespace or obj.meta.namespace or "default"),
            target_kind=kind, target_name=name,
            min_replicas=min_replicas, max_replicas=max_replicas,
            target_cpu_utilization=cpu_percent,
        )
        try:
            self.cs.client_for("HorizontalPodAutoscaler").create(hpa)
        except AlreadyExistsError:
            self.out.write(f'Error: hpa "{name}" already exists\n')
            return 1
        self.out.write(f"horizontalpodautoscaler/{name} autoscaled\n")
        return 0

    # -- set image / set resources (cmd/set/) ------------------------------
    def set_image(self, resource: str, name: str, pairs: list[str],
                  namespace: Optional[str] = None) -> int:
        """``kubectl set image deployment/NAME container=image ...`` —
        the rolling-update trigger (template change → new RS hash)."""
        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet", "DaemonSet", "StatefulSet", "Pod"):
            self.out.write(f"error: cannot set image on {resource}\n")
            return 1
        want = {}
        for p in pairs:
            if "=" not in p:
                self.out.write(f"error: expected CONTAINER=IMAGE, got {p!r}\n")
                return 1
            c, img = p.split("=", 1)
            want[c] = img
        missing = []

        def _mutate(obj):
            missing.clear()
            containers = (obj.spec.containers if kind == "Pod"
                          else obj.template.spec.containers)
            by_name = {c.name: c for c in containers}
            for c, img in want.items():
                if c == "*":
                    for cont in containers:
                        cont.image = img
                elif c in by_name:
                    by_name[c].image = img
                else:
                    missing.append(c)
            if missing:
                raise _AbortMutation
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except _AbortMutation:
            self.out.write(f"error: unable to find container {missing[0]!r}\n")
            return 1
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} image updated\n")
        return 0

    def set_resources(self, resource: str, name: str, requests: str = "",
                      limits: str = "", namespace: Optional[str] = None) -> int:
        """``kubectl set resources`` — update every container's
        requests/limits from "cpu=100m,memory=128Mi" strings."""
        from ..api.quantity import Quantity

        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet", "DaemonSet", "StatefulSet"):
            self.out.write(f"error: cannot set resources on {resource}\n")
            return 1

        def _parse(s: str) -> dict:
            return {k: Quantity(v)
                    for k, v in (p.split("=", 1) for p in s.split(",") if "=" in p)}

        try:
            req, lim = _parse(requests), _parse(limits)
        except ValueError as e:
            self.out.write(f"error: {e}\n")
            return 1

        def _mutate(obj):
            for c in obj.template.spec.containers:
                c.resources.requests.update(req)
                c.resources.limits.update(lim)
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} resource requirements updated\n")
        return 0

    def set_env(self, resource: str, name: str, pairs: list[str],
                namespace: Optional[str] = None) -> int:
        """``kubectl set env`` — KEY=VALUE sets / KEY- removes on every
        container of the workload's template (cmd/set/set_env.go)."""
        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet", "DaemonSet", "StatefulSet"):
            self.out.write(f"error: cannot set env on {resource}\n")
            return 1
        sets, removes = {}, []
        for p in pairs:
            if p.endswith("-") and "=" not in p:
                removes.append(p[:-1])
            elif "=" in p:
                k2, _, v = p.partition("=")
                sets[k2] = v
            else:
                self.out.write(f"error: expected KEY=VALUE or KEY-, got {p!r}\n")
                return 1

        def _mutate(obj):
            for c in obj.template.spec.containers:
                c.env.update(sets)
                for k2 in removes:
                    c.env.pop(k2, None)
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} env updated\n")
        return 0

    def set_selector(self, resource: str, name: str, selector: str,
                     namespace: Optional[str] = None) -> int:
        """``kubectl set selector`` (cmd/set/set_selector.go): rewrite a
        Service's selector (equality map) or a workload's label
        selector."""
        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        # equality-only, like the reference ("selector must be
        # equality-based"): k=v[,k=v...]
        pairs: Optional[dict] = {}
        for part in [s.strip() for s in selector.split(",") if s.strip()]:
            k2, eq, v = part.partition("=")
            if not eq or not k2 or "!" in k2 or "=" in v:
                pairs = None
                break
            pairs[k2] = v
        if not pairs:
            self.out.write(f"error: bad selector {selector!r} "
                           f"(key=value[,key=value...])\n")
            return 1
        from ..api.selectors import LabelSelector

        def _mutate(obj):
            if kind == "Service":
                obj.selector = dict(pairs)
            elif hasattr(obj, "selector"):
                obj.selector = LabelSelector.from_match_labels(pairs)
            else:
                raise KeyError(kind)
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except NotFoundError:
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        except KeyError:
            self.out.write(f"error: cannot set selector on {resource}/{name}\n")
            return 1
        self.out.write(f"{resource}/{name} selector updated\n")
        return 0

    def set_subject(self, resource: str, name: str, users: list[str],
                    groups: list[str], serviceaccounts: list[str],
                    namespace: Optional[str] = None) -> int:
        """``kubectl set subject`` (cmd/set/set_subject.go): append
        users/groups/serviceaccounts to a (Cluster)RoleBinding's subject
        list, deduplicated (within the flags AND against the binding)."""
        resource, kind = _resolve(resource)
        if kind not in ("RoleBinding", "ClusterRoleBinding"):
            self.out.write(f"error: cannot set subject on {resource}\n")
            return 1
        want, err = _build_subjects(users, groups, serviceaccounts)
        if err is not None:
            self.out.write(err)
            return 1

        def _mutate(obj):
            have = {(s.kind, s.name, s.namespace) for s in obj.subjects}
            for s in want:
                if (s.kind, s.name, s.namespace) not in have:
                    have.add((s.kind, s.name, s.namespace))
                    obj.subjects.append(s)
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except NotFoundError:
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} subjects updated\n")
        return 0

    def set_serviceaccount(self, resource: str, name: str, sa_name: str,
                           namespace: Optional[str] = None) -> int:
        """``kubectl set serviceaccount`` (cmd/set/set_serviceaccount.go):
        point the workload template's serviceAccountName at ``sa_name``."""
        resource, kind = _resolve(resource)
        if kind not in ("Deployment", "ReplicaSet", "DaemonSet", "StatefulSet"):
            self.out.write(f"error: cannot set serviceaccount on {resource}\n")
            return 1

        def _mutate(obj):
            obj.template.spec.service_account_name = sa_name
            return obj

        try:
            _update_if_changed(self.cs.client_for(kind), name, _mutate, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        self.out.write(f"{resource}/{name} serviceaccount updated\n")
        return 0

    # -- auth can-i (cmd/auth/cani.go) -------------------------------------
    def auth_can_i(self, verb: str, resource: str, name: str = "",
                   namespace: Optional[str] = None) -> int:
        """POSTs a SelfSubjectAccessReview; the server evaluates its live
        authorizer for the calling identity.  Exit 0 yes / 1 no."""
        plural, _ = _resolve(resource)
        if getattr(self.cs.store, "base_url", None) is None:
            # in-proc clientset bypasses the filter chain entirely: every
            # verb IS allowed, so say so rather than guess at policy
            self.out.write("yes\n")
            return 0
        body = {"spec": {"resourceAttributes": {
            "verb": verb, "resource": plural, "name": name,
            "namespace": namespace or "default",
        }}}
        try:
            resp = self.cs.store.raw(
                "POST", "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
                body=body)
            status = json.loads(resp).get("status") or {}
        except Exception as e:
            self.out.write(f"error: {e}\n")
            return 1
        self.out.write("yes\n" if status.get("allowed") else "no\n")
        return 0 if status.get("allowed") else 1

    # -- discovery verbs ---------------------------------------------------
    def api_versions(self) -> int:
        versions = ["v1"]
        if getattr(self.cs.store, "base_url", None) is not None:
            try:
                versions = json.loads(self.cs.store.raw("GET", "/api")).get("versions", ["v1"])
                for g in json.loads(self.cs.store.raw("GET", "/apis")).get("groups", []):
                    versions.append(g["name"])
            except Exception as e:
                self.out.write(f"error: could not reach server: {e}\n")
                return 1
        for v in versions:
            self.out.write(v + "\n")
        return 0

    def api_resources(self) -> int:
        """Table of every servable resource, from live discovery (remote)
        or the type registry (in-proc) — CRDs included either way."""
        base = getattr(self.cs.store, "base_url", None)
        rows = [("NAME", "SHORTNAMES", "KIND", "NAMESPACED")]
        short_by_plural: dict[str, list] = {}
        for s, plural in _SHORT_NAMES.items():
            short_by_plural.setdefault(plural, []).append(s)
        if base is not None:
            try:
                resources = json.loads(self.cs.store.raw("GET", "/api/v1")).get("resources", [])
            except Exception as e:
                self.out.write(f"error: could not reach server: {e}\n")
                return 1
        else:
            resources = [
                {"name": plural, "kind": kind,
                 "namespaced": kind not in api.CLUSTER_SCOPED_KINDS}
                for kind, plural in sorted(api.KIND_PLURALS.items())
            ]
        for res in sorted(resources, key=lambda r: r["name"]):
            rows.append((res["name"], ",".join(short_by_plural.get(res["name"], [])),
                         res["kind"], res["namespaced"]))
        self._print(*rows)
        return 0

    def version(self) -> int:
        from .. import __version__

        self.out.write(f"Client Version: {__version__}\n")
        if getattr(self.cs.store, "base_url", None) is not None:
            try:
                data = json.loads(self.cs.store.raw("GET", "/version"))
                self.out.write(f"Server Version: {data['version']}\n")
            except Exception as e:
                self.out.write(f"error: could not reach server: {e}\n")
                return 1
        return 0

    def cluster_info(self) -> int:
        base = getattr(self.cs.store, "base_url", None)
        if base is None:
            self.out.write("Kubernetes master is running in-process\n")
            return 0
        try:
            ok = json.loads(self.cs.store.raw("GET", "/healthz")).get("status") == "ok"
        except Exception:
            ok = False
        self.out.write(f"Kubernetes master is running at {base} "
                       f"({'healthy' if ok else 'UNREACHABLE'})\n")
        return 0 if ok else 1

    # -- attach / cp / port-forward / proxy (streaming verbs) --------------
    def attach(self, name: str, namespace: Optional[str] = None,
               container: str = "") -> int:
        """``kubectl attach POD``: the container's output stream (no TTY
        at this depth — reference attach without stdin)."""
        import urllib.error
        import urllib.request

        ns = namespace or "default"
        base = getattr(self.cs.store, "base_url", None)
        try:
            if base is None:
                resolved = self._kubelet_target(name, ns, container)
                if resolved is None:
                    return 1
                kubelet_url, c, _ = resolved
                with urllib.request.urlopen(
                        f"{kubelet_url}/attach/{ns}/{name}/{c}", timeout=10) as r:
                    self.out.write(r.read().decode())
            else:
                path = f"/api/v1/namespaces/{ns}/pods/{name}/attach"
                if container:
                    path += f"?container={container}"
                self.out.write(self.cs.store.raw("GET", path).decode())
            return 0
        except urllib.error.HTTPError as e:
            self.out.write(f"error: {e.read().decode()}\n")
            return 1
        except Exception as e:
            self.out.write(f"error: {e}\n")
            return 1

    def cp(self, src: str, dst: str, namespace: Optional[str] = None,
           container: str = "") -> int:
        """``kubectl cp`` — ``local pod:/path`` or ``pod:/path local``
        (reference cmd/cp.go: tar over exec; here the pods/cp
        subresource)."""
        import urllib.error
        import urllib.parse as _up
        import urllib.request

        ns = namespace or "default"

        def remote_parts(spec: str):
            if ":" not in spec:
                return None
            pod, _, path = spec.partition(":")
            return pod, path

        src_r, dst_r = remote_parts(src), remote_parts(dst)
        if (src_r is None) == (dst_r is None):
            self.out.write("error: exactly one of SRC/DST must be POD:PATH\n")
            return 1
        pod, path = src_r or dst_r
        base = getattr(self.cs.store, "base_url", None)
        try:
            if base is None:
                resolved = self._kubelet_target(pod, ns, container)
                if resolved is None:
                    return 1
                kubelet_url, c, node = resolved
                from ..auth.authn import kubelet_exec_token

                target = (f"{kubelet_url}/cp/{ns}/{pod}/{c}"
                          f"?path={_up.quote(path)}")
                auth = {"Authorization": f"Bearer {kubelet_exec_token(node)}"}
                if src_r is not None:  # pod -> local
                    req = urllib.request.Request(target, headers=auth)
                    with urllib.request.urlopen(req, timeout=30) as r:
                        data = r.read()
                    open(dst, "wb").write(data)
                else:  # local -> pod
                    req = urllib.request.Request(
                        target, data=open(src, "rb").read(), method="PUT",
                        headers=auth)
                    urllib.request.urlopen(req, timeout=30).read()
            else:
                sub = (f"/api/v1/namespaces/{ns}/pods/{pod}/cp"
                       f"?path={_up.quote(path)}")
                if container:
                    sub += f"&container={container}"
                if src_r is not None:
                    open(dst, "wb").write(self.cs.store.raw("GET", sub))
                else:
                    # raw() sends dict bodies; file bytes need a manual PUT
                    req = urllib.request.Request(
                        f"{base}{sub}", data=open(src, "rb").read(), method="PUT")
                    token = getattr(self.cs.store, "token", None)
                    if token:
                        req.add_header("Authorization", f"Bearer {token}")
                    urllib.request.urlopen(
                        req, timeout=30,
                        context=getattr(self.cs.store, "_ssl_ctx", None)).read()
            self.out.write("copied\n")
            return 0
        except FileNotFoundError as e:
            self.out.write(f"error: {e}\n")
            return 1
        except urllib.error.HTTPError as e:
            self.out.write(f"error: {e.read().decode()}\n")
            return 1
        except Exception as e:
            self.out.write(f"error: {e}\n")
            return 1

    def port_forward(self, name: str, ports: str,
                     namespace: Optional[str] = None):
        """``kubectl port-forward POD LOCAL:REMOTE`` — a real local
        listener forwarding each connection to the pod's IP (the
        reference forwards SPDY streams via the kubelet; the pod IP is
        the hollow fleet's reachable address).  Returns the forwarder
        (caller stops it); None after printing an error."""
        ns = namespace or "default"
        try:
            pod = self.cs.pods.get(name, ns)
        except NotFoundError:
            self.out.write(f'Error: pod "{name}" not found\n')
            return None
        if not pod.status.pod_ip:
            self.out.write("error: pod has no IP\n")
            return None
        local_s, _, remote_s = ports.partition(":")
        try:
            remote = int(remote_s or local_s)
            local = int(local_s) if local_s else 0
        except ValueError:
            self.out.write(f"error: invalid port spec {ports!r} "
                           "(want LOCAL:REMOTE or PORT)\n")
            return None
        from ..proxy.userspace import UserspaceProxier

        fwd = UserspaceProxier()
        try:
            port = fwd.set_service(f"port-forward/{ns}/{name}",
                                   [(pod.status.pod_ip, remote)],
                                   local_port=local)
        except OSError as e:
            self.out.write(f"error: cannot bind local port {local_s}: {e}\n")
            return None
        self.out.write(f"Forwarding from 127.0.0.1:{port} -> {remote}\n")
        fwd.local_port = port
        return fwd

    def proxy(self, port: int = 0):
        """``kubectl proxy``: local HTTP front door that forwards every
        request to the apiserver with this client's credential attached
        (reference cmd/proxy.go).  Returns the running server."""
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        store = self.cs.store
        outer_out = self.out

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _forward(self, method):
                import urllib.error

                try:
                    # bodies forward as RAW bytes: the proxy must not
                    # assume JSON (cp PUTs file payloads through here)
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length) if length else None
                    data = store.raw(method, self.path, body=body)
                    code = 200
                except urllib.error.HTTPError as e:
                    data, code = e.read(), e.code
                except Exception as e:  # noqa: BLE001
                    data, code = str(e).encode(), 502
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                self._forward("POST")

            def do_PUT(self):
                self._forward("PUT")

            def do_DELETE(self):
                self._forward("DELETE")

        if getattr(store, "base_url", None) is None:
            outer_out.write("error: proxy requires --server\n")
            return None
        httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        outer_out.write(f"Starting to serve on 127.0.0.1:{httpd.server_port}\n")
        httpd.local_port = httpd.server_port
        return httpd

    # -- explain / edit (cmd/explain.go, cmd/edit.go) ----------------------
    # -- create generators (cmd/create_*.go) -------------------------------
    def create_resource(self, what: str, name: str, namespace: Optional[str],
                        from_literal: list[str], from_file: list[str],
                        hard: str, tcp: list[str], secret_type: str,
                        svc_type: str = "ClusterIP", verbs: str = "",
                        resources: str = "", role: str = "",
                        clusterrole: str = "", users: list[str] = (),
                        groups: list[str] = (), serviceaccounts: list[str] = (),
                        selector: str = "", min_available: int = 0,
                        image: str = "", replicas: int = 1) -> int:
        """Imperative object generators: ``kubectl create
        namespace|configmap|secret|serviceaccount|quota|service|role|
        rolebinding|clusterrole|clusterrolebinding|pdb|deployment NAME
        ...`` (reference ``cmd/create_*.go``)."""
        import base64

        from ..admission.framework import AdmissionDenied
        from ..api import (
            ConfigMap,
            Namespace,
            ResourceQuota,
            Secret,
            ServiceAccount,
        )
        from ..api.cluster import PodDisruptionBudget
        from ..api.rbac import (
            ClusterRole,
            ClusterRoleBinding,
            PolicyRule,
            Role,
            RoleBinding,
        )
        from ..client.remote import ForbiddenError

        def _kv_data(binary_ok: bool) -> Optional[dict]:
            """key→value from --from-literal/--from-file.  Files read as
            bytes; non-UTF-8 content is allowed only where the target
            kind can hold it (secrets — the canonical home of certs and
            keystores), mirroring the reference's data/binaryData split."""
            data = {}
            for spec in from_literal:
                if "=" not in spec:
                    self.out.write(f"error: --from-literal needs key=value, "
                                   f"got {spec!r}\n")
                    return None
                k, _, v = spec.partition("=")
                data[k] = v
            for path in from_file:
                key, _, p = path.partition("=")
                if not p:
                    key, p = None, path
                try:
                    with open(p, "rb") as fh:
                        raw = fh.read()
                except OSError as e:
                    self.out.write(f"error: {e}\n")
                    return None
                import os as _os

                try:
                    content = raw.decode()
                except UnicodeDecodeError:
                    if not binary_ok:
                        self.out.write(
                            f"error: {p} is not UTF-8; binary content is "
                            f"only supported in secrets\n")
                        return None
                    content = raw
                data[key or _os.path.basename(p)] = content
            return data

        if what == "namespace":
            obj = Namespace(meta=api.ObjectMeta(name=name, namespace=""))
        elif what == "configmap":
            data = _kv_data(binary_ok=False)
            if data is None:
                return 1
            obj = ConfigMap(meta=api.ObjectMeta(name=name), data=data)
        elif what == "secret":
            data = _kv_data(binary_ok=True)
            if data is None:
                return 1
            # the in-repo Secret convention stores plain values (the
            # serviceaccount-token controller does); binary file content
            # is base64-armored so it survives the string field
            obj = Secret(
                meta=api.ObjectMeta(name=name), type=secret_type,
                data={k: (v if isinstance(v, str)
                          else base64.b64encode(v).decode())
                      for k, v in data.items()},
            )
        elif what == "serviceaccount":
            obj = ServiceAccount(meta=api.ObjectMeta(name=name))
        elif what == "quota":
            limits = {}
            for spec in (hard or "").split(","):
                if not spec:
                    continue
                k, _, v = spec.partition("=")
                try:
                    limits[k] = api.Quantity(v)
                except ValueError:
                    self.out.write(f"error: bad quantity {v!r} for {k}\n")
                    return 1
            obj = ResourceQuota(meta=api.ObjectMeta(name=name), hard=limits)
        elif what == "service":
            ports = []
            for spec in tcp or []:
                port_s, _, target_s = spec.partition(":")
                try:
                    port = int(port_s)
                    target = int(target_s) if target_s else port
                except ValueError:
                    self.out.write(f"error: bad --tcp {spec!r}\n")
                    return 1
                ports.append(api.ServicePort(name=f"tcp-{port}", port=port,
                                             target_port=target))
            obj = api.Service(meta=api.ObjectMeta(name=name),
                              selector={"app": name}, ports=ports,
                              type=svc_type)
        elif what in ("role", "clusterrole"):
            if not verbs or not resources:
                self.out.write("error: --verb and --resource are required\n")
                return 1
            rule = PolicyRule(verbs=verbs.split(","),
                              resources=resources.split(","))
            cls = Role if what == "role" else ClusterRole
            obj = cls(meta=api.ObjectMeta(name=name), rules=[rule])
        elif what in ("rolebinding", "clusterrolebinding"):
            if bool(role) == bool(clusterrole):
                self.out.write("error: exactly one of --role/--clusterrole "
                               "is required\n")
                return 1
            subjects, err = _build_subjects(users, groups, serviceaccounts)
            if err is not None:
                self.out.write(err)
                return 1
            cls = RoleBinding if what == "rolebinding" else ClusterRoleBinding
            obj = cls(meta=api.ObjectMeta(name=name), subjects=subjects,
                      role_kind="ClusterRole" if clusterrole else "Role",
                      role_name=clusterrole or role)
        elif what == "poddisruptionbudget":
            want = _parse_selector(selector) if selector else None
            if want is None:
                self.out.write("error: --selector is required (and must "
                               "parse)\n")
                return 1
            obj = PodDisruptionBudget(
                meta=api.ObjectMeta(name=name),
                min_available=min_available,
                selector=want,  # _parse_selector returns a LabelSelector
            )
        elif what == "deployment":
            # cmd/create_deployment.go: app=NAME labels/selector, one
            # container named after the image's basename
            if not image:
                self.out.write("error: --image is required\n")
                return 1
            from ..api.selectors import LabelSelector

            # basename, digest/tag stripped ("nginx@sha256:..." -> nginx)
            cname = image.split("/")[-1].split("@")[0].split(":")[0] or name
            obj = api.Deployment(
                meta=api.ObjectMeta(name=name, labels={"app": name}),
                replicas=replicas,
                selector=LabelSelector.from_match_labels({"app": name}),
                template=api.PodTemplateSpec(
                    labels={"app": name},
                    spec=api.PodSpec(containers=[
                        api.Container(name=cname, image=image)]),
                ),
            )
        else:
            self.out.write(f"error: unknown generator {what!r}\n")
            return 1
        if namespace and hasattr(obj.meta, "namespace") and obj.meta.namespace != "":
            obj.meta.namespace = namespace
        kind = type(obj).KIND
        try:
            self.cs.client_for(kind).create(obj)
        except AlreadyExistsError:
            self.out.write(f"Error: {kind} {name!r} already exists\n")
            return 1
        except (AdmissionDenied, ForbiddenError) as e:
            self.out.write(f"Error from server (Forbidden): {e}\n")
            return 1
        self.out.write(f"{KIND_TO_RESOURCE[kind]}/{name} created\n")
        return 0

    # -- certificate approve/deny (cmd/certificates.go) --------------------
    def certificate(self, action: str, name: str) -> int:
        """Flip a CSR's approval condition; the certificates controller
        then issues (reference ``cmd/certificates.go`` +
        ``pkg/controller/certificates``)."""
        cond_type = "Approved" if action == "approve" else "Denied"
        past = "approved" if action == "approve" else "denied"

        def _mutate(csr):
            have = {c.get("type") for c in csr.conditions}
            if cond_type in have:
                return csr  # idempotent: the no-op write is skipped
            if ("Denied" if cond_type == "Approved" else "Approved") in have:
                raise _AbortMutation
            csr.conditions.append({
                "type": cond_type, "reason": "KubectlCertificate",
                "message": f"{past} via kubectl certificate {action}",
            })
            return csr

        try:
            _update_if_changed(self.cs.certificatesigningrequests, name,
                               _mutate, None)
        except _AbortMutation:
            self.out.write(f"error: CSR {name!r} is already "
                           f"{'denied' if cond_type == 'Approved' else 'approved'}\n")
            return 1
        except (NotFoundError, KeyError):
            self.out.write(f'Error: certificatesigningrequest "{name}" not found\n')
            return 1
        self.out.write(f"certificatesigningrequest/{name} {past}\n")
        return 0

    # -- replace (cmd/replace.go) ------------------------------------------
    def replace(self, filename: str, force: bool = False) -> int:
        """Full-object update from a manifest; the object must exist
        (create is ``kubectl create``'s job).  ``--force`` deletes and
        recreates — a new uid, like the reference's delete+create path."""
        from ..admission.framework import AdmissionDenied
        from ..client.remote import ForbiddenError

        rc = 0
        for doc in self._load_manifests(filename):
            kind = doc.get("kind", "")
            if kind not in KIND_TO_RESOURCE:
                self.out.write(f"error: unknown kind {kind!r} in manifest\n")
                rc = 1
                continue
            client = self.cs.client_for(kind)
            desired = api.from_dict(doc)
            name = desired.meta.name
            plural = KIND_TO_RESOURCE[kind]
            if force:
                try:
                    client.delete(name, desired.meta.namespace or None)
                except (NotFoundError, KeyError):
                    pass
                # identity is cluster-owned: recreate mints a fresh uid even
                # if the manifest was exported from a live object
                desired.meta.uid = ""
                desired.meta.resource_version = 0
                desired.meta.creation_revision = 0
                try:
                    client.create(desired)
                except (AdmissionDenied, ForbiddenError, AlreadyExistsError) as e:
                    self.out.write(f"Error from server (Forbidden): {e}\n")
                    rc = 1
                    continue
                self.out.write(f"{plural}/{name} replaced\n")
                continue

            def _swap(live):
                desired.meta.uid = live.meta.uid
                desired.meta.resource_version = live.meta.resource_version
                desired.meta.creation_revision = live.meta.creation_revision
                return desired

            try:
                client.guaranteed_update(name, _swap, desired.meta.namespace or None)
            except (NotFoundError, KeyError):
                self.out.write(f'Error: {plural} "{name}" not found '
                               f'(use create or --force)\n')
                rc = 1
                continue
            except (AdmissionDenied, ForbiddenError) as e:
                self.out.write(f"Error from server (Forbidden): {e}\n")
                rc = 1
                continue
            self.out.write(f"{plural}/{name} replaced\n")
        return rc

    # -- convert (cmd/convert.go) ------------------------------------------
    def convert(self, filename: str, output_version: str) -> int:
        """Re-encode manifests between API versions through the scheme's
        hub-and-spoke converters (``api/scheme.py`` — decode to internal,
        encode to the requested group/version)."""
        from ..api.scheme import convert_from_internal

        docs = []
        for doc in self._load_manifests(filename):  # already internal form
            kind = doc.get("kind", "")
            if kind not in KIND_TO_RESOURCE:
                self.out.write(f"error: unknown kind {kind!r} in manifest\n")
                return 1
            docs.append(convert_from_internal(doc, output_version))
        for i, doc in enumerate(docs):
            if i:
                self.out.write("---\n")
            self.out.write(yaml.safe_dump(doc, sort_keys=False))
        return 0

    # -- completion (cmd/completion.go) ------------------------------------
    def completion(self, shell: str) -> int:
        """Emit a shell completion script over the live verb + resource
        tables (the reference generates from cobra; here from argparse's
        registered subcommands)."""
        verbs = sorted(ALL_VERBS)
        resources = sorted(set(KIND_TO_RESOURCE.values()))
        if shell == "bash":
            self.out.write(
                "# bash completion for kubectl\n"
                "_kubectl_completions() {\n"
                "  local cur=${COMP_WORDS[COMP_CWORD]}\n"
                f"  local verbs=\"{' '.join(verbs)}\"\n"
                f"  local resources=\"{' '.join(resources)}\"\n"
                "  if [ $COMP_CWORD -eq 1 ]; then\n"
                "    COMPREPLY=($(compgen -W \"$verbs\" -- \"$cur\"))\n"
                "  else\n"
                "    COMPREPLY=($(compgen -W \"$resources\" -- \"$cur\"))\n"
                "  fi\n"
                "}\n"
                "complete -F _kubectl_completions kubectl\n")
            return 0
        if shell == "zsh":
            self.out.write(
                "#compdef kubectl\n"
                f"local -a verbs=({' '.join(verbs)})\n"
                f"local -a resources=({' '.join(resources)})\n"
                "if (( CURRENT == 2 )); then\n"
                "  _describe 'verb' verbs\n"
                "else\n"
                "  _describe 'resource' resources\n"
                "fi\n")
            return 0
        self.out.write(f"error: unsupported shell {shell!r}\n")
        return 1

    # -- config (cmd/config/) ----------------------------------------------
    def config(self, args: list[str], kubeconfig: Optional[str] = None) -> int:
        """kubeconfig file manipulation: view / get-contexts /
        current-context / use-context / set-context / set-cluster /
        delete-context over the reference's clusters+contexts+users shape
        (``staging/src/k8s.io/client-go/tools/clientcmd/api/types.go``)."""
        import os

        path = kubeconfig or os.environ.get("KUBECONFIG") or os.path.expanduser(
            "~/.kube/config")

        def load() -> dict:
            try:
                with open(path) as f:
                    return yaml.safe_load(f) or {}
            except FileNotFoundError:
                return {}

        def save(cfg: dict) -> None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f, sort_keys=False)

        if not args:
            self.out.write("error: config needs a subcommand "
                           "(view|get-contexts|current-context|use-context|"
                           "set-context|set-cluster|delete-context)\n")
            return 1
        sub, rest = args[0], args[1:]
        cfg = load()
        if sub == "view":
            self.out.write(yaml.safe_dump(cfg or {"apiVersion": "v1",
                                                  "kind": "Config"},
                                          sort_keys=False))
            return 0
        if sub == "current-context":
            cur = cfg.get("current-context", "")
            if not cur:
                self.out.write("error: current-context is not set\n")
                return 1
            self.out.write(cur + "\n")
            return 0
        if sub == "get-contexts":
            cur = cfg.get("current-context", "")
            self.out.write("CURRENT   NAME   CLUSTER   USER\n")
            for c in cfg.get("contexts", []):
                mark = "*" if c.get("name") == cur else " "
                ctx = c.get("context", {})
                self.out.write(f"{mark}         {c.get('name')}   "
                               f"{ctx.get('cluster', '')}   "
                               f"{ctx.get('user', '')}\n")
            return 0
        if sub == "use-context":
            if not rest:
                self.out.write("error: use-context needs a name\n")
                return 1
            if not any(c.get("name") == rest[0] for c in cfg.get("contexts", [])):
                self.out.write(f"error: no context exists with the name "
                               f"{rest[0]!r}\n")
                return 1
            cfg["current-context"] = rest[0]
            save(cfg)
            self.out.write(f'Switched to context "{rest[0]}".\n')
            return 0
        if sub == "set-context":
            if not rest:
                self.out.write("error: set-context needs a name\n")
                return 1
            name, kv = rest[0], dict(p.split("=", 1) for p in rest[1:] if "=" in p)
            ctxs = cfg.setdefault("contexts", [])
            for c in ctxs:
                if c.get("name") == name:
                    c.setdefault("context", {}).update(kv)
                    break
            else:
                ctxs.append({"name": name, "context": kv})
            save(cfg)
            self.out.write(f'Context "{name}" modified.\n')
            return 0
        if sub == "set-cluster":
            if not rest:
                self.out.write("error: set-cluster needs a name\n")
                return 1
            name, kv = rest[0], dict(p.split("=", 1) for p in rest[1:] if "=" in p)
            clusters = cfg.setdefault("clusters", [])
            for c in clusters:
                if c.get("name") == name:
                    c.setdefault("cluster", {}).update(kv)
                    break
            else:
                clusters.append({"name": name, "cluster": kv})
            save(cfg)
            self.out.write(f'Cluster "{name}" set.\n')
            return 0
        if sub == "delete-context":
            if not rest:
                self.out.write("error: delete-context needs a name\n")
                return 1
            before = len(cfg.get("contexts", []))
            cfg["contexts"] = [c for c in cfg.get("contexts", [])
                               if c.get("name") != rest[0]]
            if len(cfg["contexts"]) == before:
                self.out.write(f"error: cannot delete context {rest[0]!r}, "
                               f"not in {path}\n")
                return 1
            if cfg.get("current-context") == rest[0]:
                cfg.pop("current-context", None)
            save(cfg)
            self.out.write(f'deleted context {rest[0]} from {path}\n')
            return 0
        self.out.write(f"error: unknown config subcommand {sub!r}\n")
        return 1

    # -- cluster-info dump (cmd/clusterinfo_dump.go) -----------------------
    def cluster_info_dump(self, output_directory: str = "") -> int:
        """Dump cluster state (nodes + per-namespace pods/services/
        events/RCs/RSs/deployments) as JSON — to stdout, or one file per
        kind under --output-directory like the reference."""
        import os

        dumps: list[tuple[str, list]] = [
            ("nodes", self.cs.nodes.list()[0]),
        ]
        for plural in ("pods", "services", "events", "replicationcontrollers",
                       "replicasets", "deployments", "daemonsets"):
            try:
                client = getattr(self.cs, plural)
            except AttributeError:
                continue
            dumps.append((plural, client.list()[0]))  # all namespaces
        if output_directory:
            for plural, objs in dumps:
                p = os.path.join(output_directory, f"{plural}.json")
                os.makedirs(output_directory, exist_ok=True)
                with open(p, "w") as f:
                    json.dump({"kind": "List",
                               "items": [o.to_dict() for o in objs]}, f,
                              indent=2, default=str)
            self.out.write(f"Cluster info dumped to {output_directory}\n")
            return 0
        for plural, objs in dumps:
            self.out.write(json.dumps(
                {"kind": "List", "resource": plural,
                 "items": [o.to_dict() for o in objs]}, indent=2,
                default=str) + "\n")
        return 0

    def explain(self, resource: str) -> int:
        """``kubectl explain RESOURCE[.field...]``: the wire schema of a
        kind, derived from the live type registry (the discovery-driven
        analogue of the reference's OpenAPI-backed explain)."""
        parts = resource.split(".")
        plural, kind = _resolve(parts[0])
        if kind is None:
            self.out.write(f"error: unknown resource {parts[0]!r}\n")
            return 1
        cls = api.KINDS[kind]
        doc = cls().to_dict()
        for seg in parts[1:]:
            if not isinstance(doc, dict) or seg not in doc:
                self.out.write(f"error: field {seg!r} does not exist\n")
                return 1
            doc = doc[seg]
            if isinstance(doc, list):
                doc = doc[0] if doc else {}
        self.out.write(f"KIND:     {kind}\n")
        if cls.__doc__:
            self.out.write(f"DESCRIPTION:\n  {cls.__doc__.strip().splitlines()[0]}\n")
        self.out.write("FIELDS:\n")

        def emit(d, indent):
            if not isinstance(d, dict):
                self.out.write(f"{' ' * indent}<{type(d).__name__}>\n")
                return
            for k, v in sorted(d.items()):
                tname = ("Object" if isinstance(v, dict)
                         else "[]Object" if isinstance(v, list)
                         else type(v).__name__)
                self.out.write(f"{' ' * indent}{k}\t<{tname}>\n")

        emit(doc, 2)
        return 0

    def edit(self, resource: str, name: str, namespace: Optional[str] = None) -> int:
        """``kubectl edit``: object -> $EDITOR -> update (the reference's
        edit loop without the conflict-retry interactive path)."""
        import os
        import subprocess
        import tempfile

        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        client = self.cs.client_for(kind)
        try:
            obj = client.get(name, namespace)
        except (NotFoundError, KeyError):
            self.out.write(f'Error: {resource} "{name}" not found\n')
            return 1
        editor = os.environ.get("EDITOR", "vi")
        with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
            yaml.safe_dump(obj.to_dict(), f, sort_keys=False)
            tmp = f.name
        try:
            rc = subprocess.run([*editor.split(), tmp]).returncode
        except OSError as e:
            os.unlink(tmp)
            self.out.write(f"error: cannot run editor {editor!r}: {e}\n")
            return 1
        if rc != 0:
            os.unlink(tmp)
            self.out.write("Edit cancelled\n")
            return 1
        try:
            edited = yaml.safe_load(open(tmp).read())
        except yaml.YAMLError as e:
            # the user's edits must SURVIVE a typo — keep the file and
            # point at it (the reference re-opens the editor; one shot
            # here, but never data loss)
            self.out.write(f"error: edited file is not valid YAML: {e}\n"
                           f"your changes are preserved in {tmp}\n")
            return 1
        os.unlink(tmp)
        if edited == obj.to_dict():
            self.out.write("Edit cancelled, no changes made\n")
            return 0

        def _replace(cur):
            new = type(cur).from_dict(edited)
            new.meta.uid = cur.meta.uid
            new.meta.resource_version = cur.meta.resource_version
            return new

        client.guaranteed_update(name, _replace, namespace)
        self.out.write(f"{resource}/{name} edited\n")
        return 0

    # -- rolling-update (cmd/rollingupdate.go, rolling_updater.go) ---------
    def rolling_update(self, old_name: str, image: str,
                       namespace: Optional[str] = None,
                       new_name: str = "", drive=None) -> int:
        """Client-side rolling update of a ReplicaSet (the reference's
        kubectl rolling-update on RCs): create the new RS at 0, then step
        new up / old down one replica at a time, finally delete the old.
        ``drive`` (callable) runs controllers between steps so replica
        counts actually converge (tests pass a manager pump; against a
        live cluster the controller manager does it)."""
        ns = namespace or "default"
        try:
            old = self.cs.replicasets.get(old_name, ns)
        except NotFoundError:
            self.out.write(f'Error: replicaset "{old_name}" not found\n')
            return 1
        new_name = new_name or f"{old_name}-next"
        desired = old.replicas
        new_rs = type(old).from_dict(old.to_dict())
        new_rs.meta = api.ObjectMeta(name=new_name, namespace=ns,
                                     labels=dict(old.meta.labels))
        new_rs.replicas = 0
        # distinct selector + template labels so the two RSes never adopt
        # each other's pods (the reference requires a differentiating label)
        bump = {"rolling-update": new_name}
        new_rs.selector = api.LabelSelector.from_match_labels(
            {**old.selector.match_labels, **bump})
        new_rs.template.labels.update(bump)
        if new_rs.template.spec.containers:
            new_rs.template.spec.containers[0].image = image
        try:
            self.cs.replicasets.create(new_rs)
        except AlreadyExistsError:
            self.out.write(f'Error: replicaset "{new_name}" already exists\n')
            return 1
        self.out.write(f"Created {new_name}\n")
        for step in range(1, desired + 1):
            def _scale_new(rs, n=step):
                rs.replicas = n
                return rs

            def _scale_old(rs, n=desired - step):
                rs.replicas = n
                return rs

            self.cs.replicasets.guaranteed_update(new_name, _scale_new, ns)
            self.cs.replicasets.guaranteed_update(old_name, _scale_old, ns)
            self.out.write(f"Scaling {new_name} up to {step}, "
                           f"{old_name} down to {desired - step}\n")
            if drive is not None:
                drive()
        self.cs.replicasets.delete(old_name, ns)
        self.out.write(f"Update succeeded. Deleting {old_name}\n")
        return 0

    # -- wait (cmd/wait.go) ------------------------------------------------
    def wait_for(self, resource: str, name: str, condition: str,
                 namespace: Optional[str] = None, timeout: float = 30.0) -> int:
        """``kubectl wait RES/NAME --for=condition=X|delete`` — polls the
        API (the reference watches; same observable behavior)."""
        import time as _time

        resource, kind = _resolve(resource)
        if kind is None:
            self.out.write(f"error: unknown resource {resource!r}\n")
            return 1
        client = self.cs.client_for(kind)
        want_delete = condition == "delete"
        want_cond = condition.split("=", 1)[1] if condition.startswith("condition=") else ""
        if not want_delete and not want_cond:
            self.out.write(f"error: unsupported --for {condition!r}\n")
            return 1
        deadline = _time.monotonic() + timeout
        while True:
            try:
                obj = client.get(name, namespace)
            except (NotFoundError, KeyError):
                if want_delete:
                    self.out.write(f"{resource}/{name} condition met\n")
                    return 0
                obj = None
            if obj is not None and want_cond:
                conds = getattr(getattr(obj, "status", None), "conditions", [])
                for c in conds:
                    if isinstance(c, dict):
                        ctype, cstat = c.get("type", ""), c.get("status", "")
                    else:
                        ctype = getattr(c, "type", "")
                        cstat = getattr(c, "status", "")
                    if ctype == want_cond and cstat == "True":
                        self.out.write(f"{resource}/{name} condition met\n")
                        return 0
            if _time.monotonic() >= deadline:
                self.out.write(f"error: timed out waiting for {condition} on {resource}/{name}\n")
                return 1
            _time.sleep(0.05)


def main(argv: Optional[list[str]] = None, clientset: Optional[Clientset] = None, out=None) -> int:
    """Dispatch wrapper: server-side denials and wire errors become the
    reference's "Error from server" line + exit 1, never a traceback
    (any verb can hit a 403 once the apiserver runs with authorization)."""
    from ..client.remote import ForbiddenError, RemoteError

    try:
        return _main(argv, clientset, out)
    except ForbiddenError as e:
        (out or sys.stdout).write(f"Error from server (Forbidden): {e}\n")
        return 1
    except RemoteError as e:
        (out or sys.stdout).write(f"Error from server: {e}\n")
        return 1


def _main(argv: Optional[list[str]] = None, clientset: Optional[Clientset] = None, out=None) -> int:
    # SUPPRESS so a subparser never clobbers a value parsed before the verb
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--server", default=argparse.SUPPRESS)
    common.add_argument("--token", default=argparse.SUPPRESS)
    common.add_argument("--kubeconfig", default=argparse.SUPPRESS)
    common.add_argument("--certificate-authority", dest="ca_file",
                        default=argparse.SUPPRESS)
    common.add_argument("--client-certificate", dest="client_cert",
                        default=argparse.SUPPRESS)
    common.add_argument("--client-key", dest="client_key",
                        default=argparse.SUPPRESS)
    common.add_argument("-n", "--namespace", default=argparse.SUPPRESS)
    common.add_argument("-o", "--output", default=argparse.SUPPRESS)  # ""|json|yaml|jsonpath=...

    parser = argparse.ArgumentParser(prog="kubectl-tpu", parents=[common])
    sub = parser.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("get", parents=[common])
    p.add_argument("resource")
    p.add_argument("name", nargs="?")
    p.add_argument("-l", "--selector", default="")
    p.add_argument("-w", "--watch", action="store_true")
    p.add_argument("--watch-timeout", type=float, default=30.0)
    p.add_argument("--sort-by", default="")
    p.add_argument("--show-labels", action="store_true")
    p.add_argument("--no-headers", action="store_true")
    p = sub.add_parser("describe", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p = sub.add_parser("create", parents=[common])
    p.add_argument("what", nargs="?",
                   help="generator: namespace|configmap|secret|"
                        "serviceaccount|quota|service (or use -f)")
    p.add_argument("gen_name", nargs="?")
    p.add_argument("gen_extra", nargs="?")
    p.add_argument("-f", "--filename", default=None)
    p.add_argument("--from-literal", action="append", default=[])
    p.add_argument("--from-file", action="append", default=[])
    p.add_argument("--hard", default="")
    p.add_argument("--tcp", action="append", default=[])
    p.add_argument("--type", dest="secret_type", default="Opaque")
    # dest must NOT be "verb": that is the subparser dest, and argparse
    # would clobber the chosen subcommand with the flag's value
    p.add_argument("--verb", dest="rbac_verb", default="",
                   help="role/clusterrole verbs, comma-sep")
    p.add_argument("--resource", dest="rbac_resource", default="",
                   help="role/clusterrole resources, comma-sep")
    p.add_argument("--role", default="")
    p.add_argument("--clusterrole", default="")
    p.add_argument("--user", action="append", default=[])
    p.add_argument("--group", action="append", default=[])
    p.add_argument("--serviceaccount", action="append", default=[],
                   help="ns:name")
    p.add_argument("--min-available", type=int, default=0)
    p.add_argument("-l", "--selector", default=argparse.SUPPRESS)
    p.add_argument("--image", default="",
                   help="container image (create deployment)")
    p.add_argument("--replicas", type=int, default=1)
    p = sub.add_parser("certificate", parents=[common])
    p.add_argument("action", choices=["approve", "deny"])
    p.add_argument("name")
    p = sub.add_parser("apply", parents=[common])
    p.add_argument("subverb", nargs="?", default=None,
                   help="view-last-applied|set-last-applied|"
                        "edit-last-applied (default: declarative apply -f)")
    p.add_argument("target", nargs="?", help="RESOURCE[/NAME]")
    p.add_argument("target_name", nargs="?", help="NAME (two-token form)")
    p.add_argument("-f", "--filename", default=None)
    p.add_argument("--prune", action="store_true")
    p.add_argument("-l", "--selector", default="")
    # -o/--output is inherited from the common parent parser
    p.add_argument("--create-annotation", action="store_true",
                   help="set-last-applied: create the annotation when "
                        "absent instead of erroring")
    p = sub.add_parser("delete", parents=[common])
    p.add_argument("resource")
    p.add_argument("name", nargs="?")
    p.add_argument("-l", "--selector", default="")
    p.add_argument("--cascade", default="background",
                   choices=["background", "orphan"])
    p = sub.add_parser("scale", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("--replicas", type=int, required=True)
    p = sub.add_parser("cordon", parents=[common])
    p.add_argument("name")
    p = sub.add_parser("uncordon", parents=[common])
    p.add_argument("name")
    p = sub.add_parser("drain", parents=[common])
    p.add_argument("name")
    p.add_argument("--ignore-daemonsets", action="store_true")
    p.add_argument("--force", action="store_true")
    p = sub.add_parser("top", parents=[common])
    p.add_argument("what", choices=["nodes", "pods"])
    p = sub.add_parser("logs", parents=[common])
    p.add_argument("name")
    p.add_argument("-c", "--container", default="")
    p.add_argument("--tail", type=int, default=0)
    p.add_argument("-f", "--follow", action="store_true")
    p.add_argument("--follow-timeout", type=float, default=10.0)
    p = sub.add_parser("exec", parents=[common])
    p.add_argument("name")
    p.add_argument("-c", "--container", default="")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- cmd args...")
    p = sub.add_parser("rollout", parents=[common])
    p.add_argument("action", choices=["status", "history", "undo",
                                      "pause", "resume"])
    p.add_argument("resource")  # "deployment" or "deployment/NAME"
    p.add_argument("name", nargs="?")
    p.add_argument("--to-revision", type=int, default=0)
    for verb in ("label", "annotate"):
        p = sub.add_parser(verb, parents=[common])
        p.add_argument("resource")  # "pods" or "pods/NAME"
        p.add_argument("name", nargs="?")
        p.add_argument("pairs", nargs="*", help="KEY=VALUE or KEY- to remove")
        p.add_argument("--overwrite", action="store_true")
        p.add_argument("--resource-version", dest="resource_version", default="")
        p.add_argument("-l", "--selector", default="")
        p.add_argument("--all", dest="all_resources", action="store_true")
    p = sub.add_parser("patch", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("-p", "--patch", required=True)
    p.add_argument("--type", dest="patch_type", choices=["merge", "strategic", "json"],
                   default="merge")
    p = sub.add_parser("taint", parents=[common])
    p.add_argument("resource", help="must be nodes")
    p.add_argument("name")
    p.add_argument("specs", nargs="+", help="key=value:Effect or key:Effect-")
    p = sub.add_parser("expose", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--target-port", type=int, default=0)
    p.add_argument("--type", dest="svc_type", default="ClusterIP")
    p.add_argument("--name", dest="svc_name", default="")
    p = sub.add_parser("run", parents=[common])
    p.add_argument("name")
    p.add_argument("--image", required=True)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--restart", choices=["Always", "OnFailure", "Never"], default="Always")
    p.add_argument("--labels", default="")
    p = sub.add_parser("autoscale", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("--min", dest="min_replicas", type=int, default=1)
    p.add_argument("--max", dest="max_replicas", type=int, required=True)
    p.add_argument("--cpu-percent", type=int, default=80)
    p = sub.add_parser("set", parents=[common])
    p.add_argument("what", choices=["image", "resources", "env",
                                    "selector", "serviceaccount", "sa",
                                    "subject"])
    p.add_argument("resource")  # "deployment" or "deployment/NAME"
    p.add_argument("name", nargs="?")
    p.add_argument("pairs", nargs="*", help="container=image pairs (set image)")
    p.add_argument("--requests", default="")
    p.add_argument("--limits", default="")
    p.add_argument("--user", action="append", default=[])
    p.add_argument("--group", action="append", default=[])
    p.add_argument("--serviceaccount", action="append", default=[],
                   help="ns:name (set subject)")
    p = sub.add_parser("auth", parents=[common])
    p.add_argument("action", choices=["can-i"])
    p.add_argument("auth_verb")
    p.add_argument("auth_resource")
    p.add_argument("auth_name", nargs="?", default="")
    sub.add_parser("api-versions", parents=[common])
    sub.add_parser("api-resources", parents=[common])
    sub.add_parser("version", parents=[common])
    p = sub.add_parser("cluster-info", parents=[common])
    p.add_argument("action", nargs="?", default="", choices=["", "dump"])
    p.add_argument("--output-directory", default="")
    p = sub.add_parser("replace", parents=[common])
    p.add_argument("-f", "--filename", required=True)
    p.add_argument("--force", action="store_true")
    p = sub.add_parser("convert", parents=[common])
    p.add_argument("-f", "--filename", required=True)
    p.add_argument("--output-version", required=True,
                   help="e.g. apps/v1beta1, extensions/v1beta1")
    p = sub.add_parser("completion", parents=[common])
    p.add_argument("shell", choices=["bash", "zsh"])
    p = sub.add_parser("config", parents=[common])
    p.add_argument("config_args", nargs="*")
    p = sub.add_parser("wait", parents=[common])
    p.add_argument("resource")  # "pod/NAME" or "pod NAME"
    p.add_argument("name", nargs="?")
    p.add_argument("--for", dest="condition", required=True,
                   help="condition=TYPE or delete")
    p.add_argument("--timeout", type=float, default=30.0)
    p = sub.add_parser("attach", parents=[common])
    p.add_argument("name")
    p.add_argument("-c", "--container", default="")
    p = sub.add_parser("cp", parents=[common])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("-c", "--container", default="")
    p = sub.add_parser("port-forward", parents=[common])
    p.add_argument("name")
    p.add_argument("ports", help="LOCAL:REMOTE or PORT")
    p = sub.add_parser("proxy", parents=[common])
    p.add_argument("--port", type=int, default=0)
    p = sub.add_parser("explain", parents=[common])
    p.add_argument("resource", help="RESOURCE[.field...]")
    p = sub.add_parser("edit", parents=[common])
    p.add_argument("resource")
    p.add_argument("name")
    p = sub.add_parser("rolling-update", parents=[common])
    p.add_argument("old")
    p.add_argument("--image", required=True)
    p.add_argument("--new-name", default="")

    # plugin dispatch BEFORE argparse rejects the verb: the FIRST token
    # (plugin convention — never a flag's value, never a later positional)
    # names either a built-in or a kubectl-<verb> plugin
    ALL_VERBS[:] = list(sub.choices)

    raw_args = list(argv) if argv is not None else sys.argv[1:]
    if raw_args and not raw_args[0].startswith("-") and raw_args[0] not in sub.choices:
        rc = _run_plugin(raw_args[0], raw_args[1:], out or sys.stdout)
        if rc is not None:
            return rc

    args = parser.parse_args(argv)
    server = getattr(args, "server", "http://127.0.0.1:8080")
    token = getattr(args, "token", None)
    namespace = getattr(args, "namespace", None)
    output = getattr(args, "output", "")
    if clientset is not None:
        cs = clientset
    elif getattr(args, "kubeconfig", None) and args.verb != "config":
        # ("config" manages a kubectl-format kubeconfig FILE; its
        # --kubeconfig names the file to edit, not a connection.)
        # The kubeadm kubeconfig-phase artifact: server + CA pin +
        # client cert; EVERY explicit flag overrides its field.  The
        # merge itself lives in daemon.remote_clientset — one copy.
        from ..daemon import remote_clientset

        try:
            cs = remote_clientset(
                getattr(args, "server", None),
                token=token,
                kubeconfig=args.kubeconfig,
                ca_file=getattr(args, "ca_file", None),
                client_cert=getattr(args, "client_cert", None),
                client_key=getattr(args, "client_key", None))
        except (ValueError, OSError) as e:
            (out or sys.stdout).write(f"error: --kubeconfig: {e}\n")
            return 1
    else:
        cs = Clientset(RemoteStore(
            server, token=token,
            ca_file=getattr(args, "ca_file", None),
            client_cert=getattr(args, "client_cert", None),
            client_key=getattr(args, "client_key", None)))
    k = Kubectl(cs, out=out)
    if args.verb == "get":
        if getattr(args, "watch", False):
            if args.name:
                k.out.write("error: -w does not take a name\n")
                return 1
            return k.get_watch(args.resource, namespace, args.selector,
                               args.watch_timeout)
        return k.get(args.resource, args.name, namespace, output, args.selector,
                     args.sort_by, args.show_labels, args.no_headers)
    if args.verb == "describe":
        return k.describe(args.resource, args.name, namespace)
    if args.verb == "create":
        if args.filename:
            return k.create(args.filename)
        what, name, extra = args.what, args.gen_name, args.gen_extra
        if not what or not name:
            k.out.write("error: create needs -f FILE or a generator "
                        "(namespace|configmap|secret|serviceaccount|quota|"
                        "service|deployment|role|rolebinding|clusterrole|"
                        "clusterrolebinding|pdb) and a name\n")
            return 1
        svc_type = "ClusterIP"
        if what == "secret":
            # "secret generic NAME" — the subtype token precedes the name
            if not extra:
                k.out.write("error: usage: create secret generic NAME\n")
                return 1
            if name != "generic":
                k.out.write(f"error: unsupported secret type {name!r} "
                            f"(only generic)\n")
                return 1
            name = extra
        elif what == "service":
            if not extra:
                k.out.write("error: usage: create service "
                            "clusterip|nodeport|loadbalancer NAME\n")
                return 1
            svc_type = {"clusterip": "ClusterIP", "nodeport": "NodePort",
                        "loadbalancer": "LoadBalancer"}.get(name.lower(), "")
            if not svc_type:
                k.out.write(f"error: unknown service type {name!r}\n")
                return 1
            name = extra
        if what == "pdb":
            what = "poddisruptionbudget"
        return k.create_resource(what, name, namespace, args.from_literal,
                                 args.from_file, args.hard, args.tcp,
                                 args.secret_type, svc_type,
                                 verbs=args.rbac_verb,
                                 resources=args.rbac_resource,
                                 role=args.role, clusterrole=args.clusterrole,
                                 users=args.user, groups=args.group,
                                 serviceaccounts=args.serviceaccount,
                                 selector=getattr(args, "selector", ""),
                                 min_available=args.min_available,
                                 image=args.image, replicas=args.replicas)
    if args.verb == "certificate":
        return k.certificate(args.action, args.name)
    if args.verb == "apply":
        sv = getattr(args, "subverb", None)
        if sv in ("view-last-applied", "set-last-applied", "edit-last-applied"):
            if sv == "set-last-applied":
                if not args.filename:
                    k.out.write("error: set-last-applied requires -f FILE\n")
                    return 1
                return k.apply_set_last_applied(args.filename,
                                                args.create_annotation)
            target = args.target or ""
            tname = args.target_name
            if "/" in target:
                target, tname = target.split("/", 1)
            if not target or not tname:
                k.out.write(f"error: {sv} requires RESOURCE/NAME\n")
                return 1
            if sv == "view-last-applied":
                return k.apply_view_last_applied(
                    target, tname, namespace,
                    getattr(args, "output", None) or "yaml")
            return k.apply_edit_last_applied(target, tname, namespace)
        if sv is not None:
            # a typo'd subverb must NEVER fall through to a live apply,
            # -f or not — that would mutate objects the user only meant
            # to annotate
            k.out.write(f"error: unknown apply subcommand {sv!r}\n")
            return 1
        if args.filename is None:
            k.out.write("error: apply requires -f FILE\n")
            return 1
        return k.apply(args.filename, getattr(args, "prune", False),
                       getattr(args, "selector", ""))
    if args.verb == "delete":
        if not args.name and not args.selector:
            k.out.write("error: a name or -l selector is required\n")
            return 1
        return k.delete(args.resource, args.name, namespace, args.selector,
                        getattr(args, "cascade", "background"))
    if args.verb == "scale":
        return k.scale(args.resource, args.name, args.replicas, namespace)
    if args.verb == "cordon":
        return k.cordon(args.name, True)
    if args.verb == "uncordon":
        return k.cordon(args.name, False)
    if args.verb == "drain":
        return k.drain(args.name, getattr(args, "ignore_daemonsets", False),
                       getattr(args, "force", False))
    if args.verb == "top":
        if args.what == "pods":
            return k.top_pods(namespace)
        return k.top_nodes()
    if args.verb == "logs":
        if args.follow:
            return k.logs_follow(args.name, namespace, args.container,
                                 args.follow_timeout, tail=args.tail)
        return k.logs(args.name, namespace, args.container, args.tail)
    if args.verb == "exec":
        cmd = list(args.command)
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]  # only the FIRST separator belongs to kubectl
        if not cmd:
            k.out.write("error: command required after --\n")
            return 1
        return k.exec(args.name, cmd, namespace, args.container)
    if args.verb == "rollout":
        res = args.resource
        name = args.name
        if name is None and "/" in res:
            res, name = res.split("/", 1)
        if _resolve(res)[1] != "Deployment" or not name:
            k.out.write("error: rollout supports deployment/NAME\n")
            return 1
        if args.action == "status":
            return k.rollout_status(name, namespace)
        if args.action == "history":
            return k.rollout_history(name, namespace)
        if args.action in ("pause", "resume"):
            return k.rollout_pause(name, args.action == "pause", namespace)
        return k.rollout_undo(name, namespace, args.to_revision)
    if args.verb in ("label", "annotate"):
        fn = k.label if args.verb == "label" else k.annotate
        res, name, pairs = args.resource, args.name, list(args.pairs)
        if "/" in res:  # TYPE/NAME form: the name slot holds a pair
            res, _, name2 = res.partition("/")
            if name is not None:
                pairs.insert(0, name)
            name = name2
        elif name is not None and (args.all_resources or args.selector) \
                and ("=" in name or name.endswith("-")):
            # bulk form: every positional after TYPE is a pair
            pairs.insert(0, name)
            name = None
        return fn(res, name, pairs, namespace, args.overwrite,
                  args.resource_version, args.selector, args.all_resources)
    if args.verb == "patch":
        return k.patch(args.resource, args.name, args.patch, namespace, args.patch_type)
    if args.verb == "taint":
        if _resolve(args.resource)[1] != "Node":
            k.out.write("error: taint supports nodes only\n")
            return 1
        return k.taint(args.name, args.specs)
    if args.verb == "expose":
        return k.expose(args.resource, args.name, args.port, args.target_port,
                        args.svc_type, args.svc_name, namespace)
    if args.verb == "run":
        return k.run(args.name, args.image, args.replicas, args.restart,
                     namespace, args.labels)
    if args.verb == "autoscale":
        return k.autoscale(args.resource, args.name, args.min_replicas,
                           args.max_replicas, args.cpu_percent, namespace)
    if args.verb == "set":
        res, name = args.resource, args.name
        pairs = list(args.pairs)
        if "/" in res:
            # "set ... deployment/web [spec...]": any name-slot token is a
            # spec ("c=img", "KEY=VALUE", or an env "KEY-" removal)
            if name is not None:
                pairs.insert(0, name)
            res, name = res.split("/", 1)
        if not name:
            k.out.write("error: set requires RESOURCE/NAME\n")
            return 1
        if args.what == "image":
            return k.set_image(res, name, pairs, namespace)
        if args.what == "env":
            return k.set_env(res, name, pairs, namespace)
        if args.what == "selector":
            if not pairs:
                k.out.write("error: set selector requires key=value[,...]\n")
                return 1
            return k.set_selector(res, name, ",".join(pairs), namespace)
        if args.what in ("serviceaccount", "sa"):
            if not pairs:
                k.out.write("error: set serviceaccount requires a name\n")
                return 1
            return k.set_serviceaccount(res, name, pairs[0], namespace)
        if args.what == "subject":
            return k.set_subject(res, name, args.user, args.group,
                                 args.serviceaccount, namespace)
        return k.set_resources(res, name, args.requests, args.limits, namespace)
    if args.verb == "auth":
        return k.auth_can_i(args.auth_verb, args.auth_resource, args.auth_name, namespace)
    if args.verb == "api-versions":
        return k.api_versions()
    if args.verb == "api-resources":
        return k.api_resources()
    if args.verb == "version":
        return k.version()
    if args.verb == "cluster-info":
        if getattr(args, "action", "") == "dump":
            return k.cluster_info_dump(args.output_directory)
        return k.cluster_info()
    if args.verb == "replace":
        return k.replace(args.filename, args.force)
    if args.verb == "convert":
        return k.convert(args.filename, args.output_version)
    if args.verb == "completion":
        return k.completion(args.shell)
    if args.verb == "config":
        return k.config(args.config_args,
                        getattr(args, "kubeconfig", None))
    if args.verb == "wait":
        res, name = args.resource, args.name
        if name is None and "/" in res:
            res, name = res.split("/", 1)
        if not name:
            k.out.write("error: wait requires RESOURCE/NAME\n")
            return 1
        return k.wait_for(res, name, args.condition, namespace, args.timeout)
    if args.verb == "attach":
        return k.attach(args.name, namespace, args.container)
    if args.verb == "cp":
        return k.cp(args.src, args.dst, namespace, args.container)
    if args.verb == "port-forward":
        fwd = k.port_forward(args.name, args.ports, namespace)
        if fwd is None:
            return 1
        try:
            import time as _time

            while True:  # serve until interrupted (reference behavior)
                _time.sleep(3600)
        except KeyboardInterrupt:
            fwd.stop()
            return 0
    if args.verb == "proxy":
        httpd = k.proxy(args.port)
        if httpd is None:
            return 1
        try:
            import time as _time

            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            httpd.shutdown()
            return 0
    if args.verb == "explain":
        return k.explain(args.resource)
    if args.verb == "edit":
        return k.edit(args.resource, args.name, namespace)
    if args.verb == "rolling-update":
        return k.rolling_update(args.old, args.image, namespace, args.new_name)
    return 2


def _run_plugin(verb: str, rest: list[str], out) -> Optional[int]:
    """kubectl plugin mechanism (reference ``pkg/kubectl/plugins``): an
    unknown verb resolves to an executable ``kubectl-<verb>`` on
    KUBECTL_PLUGINS_PATH (then PATH) and runs with the remaining args."""
    import os
    import shutil
    import subprocess

    name = f"kubectl-{verb}"
    candidate = None
    for d in os.environ.get("KUBECTL_PLUGINS_PATH", "").split(os.pathsep):
        if d and os.path.isfile(os.path.join(d, name)) and os.access(
                os.path.join(d, name), os.X_OK):
            candidate = os.path.join(d, name)
            break
    candidate = candidate or shutil.which(name)
    if candidate is None:
        return None
    proc = subprocess.run([candidate, *rest], capture_output=True, text=True)
    out.write(proc.stdout)
    if proc.stderr:
        out.write(proc.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
