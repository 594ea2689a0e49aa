"""Label selectors and node-selector terms.

Capability parity with the reference's
``apimachinery/pkg/labels`` + ``apimachinery/pkg/selection`` (matchLabels /
matchExpressions with In, NotIn, Exists, DoesNotExist, Gt, Lt) and the
node-affinity ``NodeSelector`` structure used by
``PodMatchNodeSelector`` (``plugin/pkg/scheduler/algorithm/predicates/
predicates.go:686``).

A selector is host-side logic over string maps; the tensorization layer
(``models/snapshot.py``) evaluates each selector
against each node/pod *once on host* to produce dense boolean matrices, so
the device kernels never see strings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


@dataclass
class Requirement:
    key: str
    operator: str
    values: list[str] = field(default_factory=list)

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.operator == IN:
            return has and labels[self.key] in self.values
        if self.operator == NOT_IN:
            # reference semantics (labels.Requirement.Matches): a missing key
            # satisfies NotIn.
            return not has or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        if self.operator in (GT, LT):
            if not has or len(self.values) != 1:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if self.operator == GT else lhs < rhs
        raise ValueError(f"unknown operator {self.operator!r}")

    def to_dict(self) -> dict:
        return {"key": self.key, "operator": self.operator, "values": list(self.values)}

    @classmethod
    def from_dict(cls, d: dict) -> "Requirement":
        return cls(d["key"], d["operator"], list(d.get("values") or []))


@dataclass
class LabelSelector:
    """matchLabels AND matchExpressions (both must hold), like
    ``metav1.LabelSelector``.  An empty selector matches everything; a None
    selector (where the API allows it) matches nothing — callers handle None.
    """

    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[Requirement] = field(default_factory=list)

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)

    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def to_dict(self) -> dict:
        d: dict = {}
        if self.match_labels:
            d["matchLabels"] = dict(self.match_labels)
        if self.match_expressions:
            d["matchExpressions"] = [r.to_dict() for r in self.match_expressions]
        return d

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LabelSelector":
        d = d or {}
        return cls(
            match_labels=dict(d.get("matchLabels") or {}),
            match_expressions=[
                Requirement.from_dict(r) for r in d.get("matchExpressions") or []
            ],
        )

    @classmethod
    def from_match_labels(cls, labels: Mapping[str, str]) -> "LabelSelector":
        return cls(match_labels=dict(labels))


def parse_selector_string(spec: str) -> LabelSelector:
    """Parse the wire ``labelSelector=`` string grammar
    (``apimachinery labels.Parse``): ``k=v``, ``k==v``, ``k!=v``, ``k``
    (exists), ``!k`` (not exists), ``k in (a,b)``, ``k notin (a,b)``,
    comma separated.  Raises ValueError on garbage."""
    import re

    reqs: list[Requirement] = []
    # split on commas outside parentheses
    for part in re.split(r",(?![^(]*\))", spec):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\S+)\s+(in|notin)\s+\(([^)]*)\)", part)
        if m:
            values = [v.strip() for v in m.group(3).split(",") if v.strip()]
            if not values:
                raise ValueError(f"empty value set in {part!r}")
            reqs.append(Requirement(m.group(1), IN if m.group(2) == "in" else NOT_IN, values))
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            if not k.strip():
                raise ValueError(f"empty key in {part!r}")
            reqs.append(Requirement(k.strip(), NOT_IN, [v.strip()]))
            continue
        if "=" in part:
            k, v = part.split("==", 1) if "==" in part else part.split("=", 1)
            if not k.strip():
                raise ValueError(f"empty key in {part!r}")
            reqs.append(Requirement(k.strip(), IN, [v.strip()]))
            continue
        if part.startswith("!"):
            reqs.append(Requirement(part[1:].strip(), DOES_NOT_EXIST))
            continue
        if re.fullmatch(r"[A-Za-z0-9._/-]+", part):
            reqs.append(Requirement(part, EXISTS))
            continue
        raise ValueError(f"cannot parse selector clause {part!r}")
    if not reqs:
        raise ValueError("empty selector")
    return LabelSelector(match_expressions=reqs)


@dataclass
class NodeSelectorTerm:
    """One term of a NodeSelector: ANDed matchExpressions over node labels."""

    match_expressions: list[Requirement] = field(default_factory=list)

    def matches(self, labels: Mapping[str, str]) -> bool:
        # reference: a term with no expressions matches nothing
        # (v1/helper nodeSelectorRequirementsAsSelector returns nil selector).
        if not self.match_expressions:
            return False
        return all(r.matches(labels) for r in self.match_expressions)

    def to_dict(self) -> dict:
        return {"matchExpressions": [r.to_dict() for r in self.match_expressions]}

    @classmethod
    def from_dict(cls, d: dict) -> "NodeSelectorTerm":
        return cls([Requirement.from_dict(r) for r in d.get("matchExpressions") or []])


@dataclass
class NodeSelector:
    """ORed list of terms (``v1.NodeSelector``): node matches if ANY term
    matches — reference ``pkg/api/v1/helper.MatchNodeSelectorTerms``."""

    terms: list[NodeSelectorTerm] = field(default_factory=list)

    def matches(self, labels: Mapping[str, str]) -> bool:
        return any(t.matches(labels) for t in self.terms)

    def to_dict(self) -> dict:
        return {"nodeSelectorTerms": [t.to_dict() for t in self.terms]}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "Optional[NodeSelector]":
        if d is None:
            return None
        return cls([NodeSelectorTerm.from_dict(t) for t in d.get("nodeSelectorTerms") or []])


def matches_simple_selector(selector: Mapping[str, str], labels: Mapping[str, str]) -> bool:
    """Plain map-equality selector (pod.spec.nodeSelector, service.spec.selector)."""
    return all(labels.get(k) == v for k, v in selector.items())

