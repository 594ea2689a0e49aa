"""Feature gates and component configuration.

The reference's ``pkg/features/kube_features.go`` + ``apimachinery
feature.Gate``: named features with defaults, flipped per component with
``--feature-gates=A=true,B=false``; and the componentconfig pattern
(``pkg/apis/componentconfig``): one declarative config object per daemon,
read from a file and overridden by flags.

The gate set is the port's own.  Config files are JSON (the YAML subset
a machine without PyYAML can read)."""

from __future__ import annotations

import copy
import json
import threading
from dataclasses import dataclass, field, fields

BETA = "BETA"

# feature -> (default, maturity)
KNOWN_FEATURES: dict[str, tuple[bool, str]] = {
    # accepted so configs that set it load; nothing in the port reads pod
    # priority until preemption is ported (ROADMAP Queue 1 item 5)
    "PodPriority": (True, BETA),
    "BatchScheduling": (True, BETA),  # the batch backend itself
}


class FeatureGates:
    def __init__(self):
        self._mu = threading.Lock()
        self._enabled = {k: v for k, (v, _) in KNOWN_FEATURES.items()}

    def enabled(self, feature: str) -> bool:
        with self._mu:
            if feature not in self._enabled:
                raise KeyError(f"unknown feature gate {feature!r}")
            return self._enabled[feature]

    def set_from_map(self, overrides: dict[str, bool]) -> None:
        with self._mu:
            unknown = sorted(set(overrides) - set(self._enabled))
            if unknown:
                raise KeyError(f"unknown feature gate(s) {unknown}")
            for k, v in overrides.items():
                self._enabled[k] = bool(v)

    def set_from_string(self, spec: str) -> None:
        """``--feature-gates=A=true,B=false`` (the flag's wire format)."""
        overrides = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad feature gate {part!r} (want name=bool)")
            k, v = part.split("=", 1)
            if v.lower() not in ("true", "false"):
                raise ValueError(f"bad feature gate value {part!r}")
            overrides[k.strip()] = v.lower() == "true"
        self.set_from_map(overrides)


DEFAULT_FEATURE_GATES = FeatureGates()  # the process-global gate


@dataclass
class SchedulerConfiguration:
    """``KubeSchedulerConfiguration`` analogue."""

    scheduler_name: str = "default-scheduler"
    backend: str = "batch"  # batch | oracle
    batch_interval: float = 0.05
    leader_elect: bool = False
    feature_gates: dict = field(default_factory=dict)


def load_component_config(cls, path: str):
    """JSON file -> config dataclass.  Unknown keys are rejected (the
    reference's strict decoding); layering flags over it is the caller's
    job."""
    with open(path) as f:
        raw = json.load(f) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a {cls.__name__} document is a JSON object")
    unknown = set(raw) - {f.name for f in fields(cls)}
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**{k: copy.deepcopy(v) for k, v in raw.items()})
