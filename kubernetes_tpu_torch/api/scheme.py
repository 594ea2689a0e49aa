"""Hub-and-spoke versioning: wire versions convert through internal types.

Capability of the reference's ``runtime.Scheme``
(``apimachinery/pkg/runtime/scheme.go``, 569 lines): each kind has ONE
internal (hub) schema — this framework's dataclasses — plus N versioned
wire schemas (spokes) with conversion + defaulting at the boundary, so
old manifests keep working as APIs evolve.  The registered spokes here
are the reference era's own wire shapes, which means **actual
Kubernetes v1.7 YAML decodes unchanged**:

- ``apps/v1beta1`` / ``extensions/v1beta1`` Deployment — nested
  ``spec.strategy.rollingUpdate.{maxSurge,maxUnavailable}`` (the
  internal hub flattens them), selector defaulted from template labels;
- ``batch/v1`` Job, ``batch/v2alpha1`` CronJob — ``spec.jobTemplate``
  nesting;
- ``v1`` core kinds — already the hub wire form (identity spoke).

``convert_to_internal(doc)`` is the decode path (the apiserver's create,
update and batch-create handlers); ``convert_from_internal(doc, gv)``
re-encodes for clients that ask for a specific wire version (a versioned
PATCH applies in that wire space)."""

from __future__ import annotations

import copy
from typing import Callable, Optional

# (group/version, kind) -> decoder(wire dict) -> internal dict
_DECODERS: dict[tuple[str, str], Callable[[dict], dict]] = {}
# (group/version, kind) -> encoder(internal dict) -> wire dict
_ENCODERS: dict[tuple[str, str], Callable[[dict], dict]] = {}


def register_conversion(gv: str, kind: str,
                        decoder: Callable[[dict], dict],
                        encoder: Optional[Callable[[dict], dict]] = None) -> None:
    _DECODERS[(gv, kind)] = decoder
    if encoder is not None:
        _ENCODERS[(gv, kind)] = encoder


def convert_to_internal(doc: dict) -> dict:
    """Decode a wire document: versioned spokes convert; unversioned or
    hub-form documents pass through (with apiVersion stripped so the
    store holds exactly one schema).  ``doc`` is left as it was.

    A spoke's decoder rewrites nested sections, so it runs on a deep
    copy.  A hub-form document (no decoder registered for its
    ``(apiVersion, kind)``) comes back as a shallow copy that shares its
    nested sections with ``doc``: the apiserver's create paths hand the
    store a body they parsed for the request alone, and a 20 000-pod
    ``:batch`` create would otherwise pay a deep copy per pod."""
    gv = doc.get("apiVersion", "")
    dec = _DECODERS.get((gv, doc.get("kind", "")))
    if dec is not None:
        doc = copy.deepcopy(doc)
        doc.pop("apiVersion", None)
        return dec(doc)
    out = dict(doc)
    out.pop("apiVersion", None)
    return out


def convert_from_internal(doc: dict, gv: str) -> dict:
    kind = doc.get("kind", "")
    enc = _ENCODERS.get((gv, kind))
    out = enc(copy.deepcopy(doc)) if enc is not None else copy.deepcopy(doc)
    out["apiVersion"] = gv
    return out


# -- Deployment: apps/v1beta1 & extensions/v1beta1 --------------------------
# reference wire (staging/src/k8s.io/api/apps/v1beta1/types.go):
#   spec.strategy: {type, rollingUpdate: {maxSurge, maxUnavailable}}
#   spec.selector may be omitted -> defaulted from template labels
#   (defaults in pkg/apis/apps/v1beta1/defaults.go)


def _intstr(v, total: int, round_up: bool) -> int:
    """The era's IntOrString on surge/unavailable: ints pass through;
    percentages resolve against replicas with the reference's rounding —
    maxSurge rounds UP, maxUnavailable rounds DOWN (so "5%" of 10 is 1
    surge but 0 unavailable; ``deployment/util.ResolveFenceposts``).

    Documented divergence: the reference re-resolves percentages against
    the CURRENT replica count on every rollout; the hub schema stores
    absolute ints, so percentages resolve once at decode time — a later
    rescale keeps the decoded absolutes."""
    if isinstance(v, int):
        return v
    if isinstance(v, str) and v.endswith("%"):
        pct = int(v[:-1])
        n = pct * max(total, 1)
        return -(-n // 100) if round_up else n // 100
    return int(v)


def _deployment_v1beta1_decode(doc: dict) -> dict:
    spec = doc.setdefault("spec", {})
    strategy = spec.pop("strategy", None) or {}
    stype = strategy.get("type", "RollingUpdate")
    spec["strategy"] = stype
    replicas = int(spec.get("replicas", 1))
    if stype == "RollingUpdate":
        ru = strategy.get("rollingUpdate") or {}
        # era defaults: maxSurge=1, maxUnavailable=1
        spec["maxSurge"] = _intstr(ru.get("maxSurge", 1), replicas, round_up=True)
        spec["maxUnavailable"] = _intstr(ru.get("maxUnavailable", 1), replicas, round_up=False)
    if not spec.get("selector"):
        # defaulting: selector <- template labels (defaults.go)
        labels = ((spec.get("template") or {}).get("metadata") or {}).get("labels") or {}
        spec["selector"] = {"matchLabels": dict(labels)}
    return doc


def _deployment_v1beta1_encode(doc: dict) -> dict:
    spec = doc.setdefault("spec", {})
    stype = spec.pop("strategy", "RollingUpdate")
    surge = spec.pop("maxSurge", 1)
    unavail = spec.pop("maxUnavailable", 0)
    strategy = {"type": stype}
    if stype == "RollingUpdate":
        strategy["rollingUpdate"] = {"maxSurge": surge, "maxUnavailable": unavail}
    spec["strategy"] = strategy
    return doc


for _gv in ("apps/v1beta1", "extensions/v1beta1"):
    register_conversion(_gv, "Deployment",
                        _deployment_v1beta1_decode, _deployment_v1beta1_encode)


# -- CronJob: batch/v2alpha1 (the era's group) -------------------------------
# wire: spec.jobTemplate.spec is the Job spec; internal flattens to the
# CronJob's own job fields


def _cronjob_v2alpha1_decode(doc: dict) -> dict:
    spec = doc.setdefault("spec", {})
    jt = spec.get("jobTemplate")
    if jt is not None and "spec" in jt:
        # internal hub keeps spec.jobTemplate = the Job SPEC itself
        spec["jobTemplate"] = jt.get("spec") or {}
    return doc


register_conversion("batch/v2alpha1", "CronJob", _cronjob_v2alpha1_decode)


# v1 core kinds, extensions/v1beta1 ReplicaSet/DaemonSet, and batch/v1 Job
# need no registration: the hub IS their wire form, and unregistered
# (group/version, kind) pairs pass through convert_* unchanged.
