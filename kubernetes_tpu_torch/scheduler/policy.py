"""Scheduler policy configuration + algorithm providers.

Capability of the reference's ``schedulerapi.Policy``
(``plugin/pkg/scheduler/api/types.go:38``, validation in ``api/validation``,
``--policy-config-file``) and named algorithm providers
(``algorithmprovider/defaults/defaults.go:63,118,188``,
``--algorithm-provider``): select predicates and priorities by name and
weight from JSON/dict config, with extender declarations.

The batch backend (``ops/backend.py``) reads the same config: a selection
the fused scan expresses runs on it, and any other schedules the whole
batch on the oracle, as in the JAX package, so a policy file is honored
alike on both paths.  Documents are JSON.
"""

from __future__ import annotations

import json
from typing import Optional

from .generic_scheduler import GenericScheduler
from .predicates import DEFAULT_PREDICATES
from .priorities import (
    BalancedResourceAllocation,
    EqualPriority,
    ImageLocalityPriority,
    InterPodAffinityPriority,
    LeastRequestedPriority,
    MostRequestedPriority,
    NodeAffinityPriority,
    NodePreferAvoidPodsPriority,
    SelectorSpreadPriority,
    ServiceSpreadingPriority,
    TaintTolerationPriority,
    cluster_autoscaler_priorities,
    default_priorities,
)

# name -> predicate fn (the RegisterFitPredicate registry, factory/plugins.go)
PREDICATE_REGISTRY = dict(DEFAULT_PREDICATES)

# name -> priority class (RegisterPriorityFunction2)
PRIORITY_REGISTRY = {
    "LeastRequestedPriority": LeastRequestedPriority,
    "MostRequestedPriority": MostRequestedPriority,
    "BalancedResourceAllocation": BalancedResourceAllocation,
    "SelectorSpreadPriority": SelectorSpreadPriority,
    "NodeAffinityPriority": NodeAffinityPriority,
    "TaintTolerationPriority": TaintTolerationPriority,
    "NodePreferAvoidPodsPriority": NodePreferAvoidPodsPriority,
    "InterPodAffinityPriority": InterPodAffinityPriority,
    "ImageLocalityPriority": ImageLocalityPriority,
    "ServiceSpreadingPriority": ServiceSpreadingPriority,
    "EqualPriority": EqualPriority,
}


class PolicyError(ValueError):
    pass


def algorithm_from_provider(name: str = "DefaultProvider") -> GenericScheduler:
    """Named provider sets (defaults.go:63): DefaultProvider and
    ClusterAutoscalerProvider (LeastRequested swapped for MostRequested)."""
    if name == "DefaultProvider":
        return GenericScheduler(priorities=default_priorities())
    if name == "ClusterAutoscalerProvider":
        return GenericScheduler(priorities=cluster_autoscaler_priorities())
    raise PolicyError(f"unknown algorithm provider {name!r}")


def algorithm_from_policy(policy: "dict | str", extenders: Optional[list] = None) -> GenericScheduler:
    """Build a scheduler algorithm from a Policy dict / JSON string:

    {"predicates": [{"name": "GeneralPredicates"}, ...],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 1}, ...],
     "extenders": [{"urlPrefix": ..., "filterVerb": ..., ...}]}

    Empty lists mean "none" (reference semantics: an explicit empty policy
    disables that phase); omit the key to get the defaults.
    """
    if isinstance(policy, str):
        policy = json.loads(policy)

    if "predicates" in policy:
        predicates = {}
        for spec in policy["predicates"]:
            name = spec["name"]
            arg = spec.get("argument") or {}
            if "labelsPresence" in arg:
                # CheckNodeLabelPresence-style factory (api/types.go:
                # PredicateArgument.LabelsPresence)
                from .predicates import make_check_node_label_presence

                lp = arg["labelsPresence"]
                predicates[name] = make_check_node_label_presence(
                    list(lp.get("labels") or []), bool(lp.get("presence", True)))
                continue
            if "serviceAffinity" in arg:
                from .predicates import make_check_service_affinity

                predicates[name] = make_check_service_affinity(
                    list(arg["serviceAffinity"].get("labels") or []))
                continue
            fn = PREDICATE_REGISTRY.get(name)
            if fn is None:
                raise PolicyError(f"unknown predicate {name!r}")
            predicates[name] = fn
    else:
        predicates = dict(DEFAULT_PREDICATES)

    if "priorities" in policy:
        priorities = []
        for spec in policy["priorities"]:
            name = spec["name"]
            cls = PRIORITY_REGISTRY.get(name)
            if cls is None:
                raise PolicyError(f"unknown priority {name!r}")
            weight = int(spec.get("weight", 1))
            if weight <= 0:
                raise PolicyError(f"priority {name!r} weight must be positive")
            priorities.append((cls(), weight))
    else:
        priorities = default_priorities()

    ext = list(extenders or [])
    for spec in policy.get("extenders", []):
        from .extender import HTTPExtender

        ext.append(HTTPExtender.from_config(spec))

    return GenericScheduler(predicates=predicates, priorities=priorities, extenders=ext)


def load_policy_file(path: str) -> GenericScheduler:
    with open(path) as f:
        return algorithm_from_policy(f.read())
