"""Feature gates and component configuration.

The reference's ``pkg/features/kube_features.go`` + ``apimachinery
feature.Gate``: named features with defaults, flipped per component with
``--feature-gates=A=true,B=false``; and the componentconfig pattern
(``pkg/apis/componentconfig``): one declarative config object per daemon,
read from a file and overridden by flags.

The gate set is the JAX package's, with ``TPUBatchScheduling`` as a
second name of ``BatchScheduling``.  Config files are JSON (the YAML subset
a machine without PyYAML can read)."""

from __future__ import annotations

import copy
import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, fields

ALPHA = "ALPHA"
BETA = "BETA"

# feature -> (default, maturity): the JAX package's gate set, names,
# defaults and maturities alike, so its component configs load here
KNOWN_FEATURES: dict[str, tuple[bool, str]] = {
    # gates nothing in the scheduler, as in the JAX package (there only
    # admission and the PriorityClass kind read it): preemption reads
    # spec.priority whatever the gate says
    "PodPriority": (True, BETA),
    # gates nothing until the controller manager is ported (the JAX one
    # reads it to start the taint manager)
    "TaintBasedEvictions": (False, ALPHA),
    # gates nothing, as in the JAX package (no module there reads it)
    "PodPreset": (True, ALPHA),
    # the batch backend itself; "TPUBatchScheduling" (the JAX name) is the
    # same gate, stored once
    "BatchScheduling": (True, BETA),
    # the fused kernel against the JAX package's XLA-scan rung.  The port
    # has no such rung (no kernel -> plain-version ladder): off is refused
    # on the card by the scheduler daemon and changes nothing on the CPU
    "PallasKernels": (True, BETA),
    # the fused scan's super-step loop: on, every launch runs the build of
    # ops/csrc/fused_scan.cu for KTPU_SUPERSTEP_K (default 8) pods a loop
    # iteration (fused_scan.superstep_k, as the JAX package's _superstep_k);
    # the same bindings, off by default as in the JAX package
    "PallasSuperSteps": (False, ALPHA),
    # gate nothing, as in the JAX package (no module there reads them)
    "DynamicKindRegistration": (True, BETA),
    "ExperimentalCriticalPodAnnotation": (False, ALPHA),
    # the kubelet's live config: on, each kubelet reads the ConfigMap
    # kube-system/kubelet-config-<node> at heartbeat cadence and applies
    # its tunables (kubelet/hollow.py _maybe_apply_dynamic_config)
    "DynamicKubeletConfig": (False, ALPHA),
}

# another name for a gate: the JAX package's name for the batch backend
ALIASES: dict[str, str] = {"TPUBatchScheduling": "BatchScheduling"}


def canonical(feature: str) -> str:
    """The gate's stored name; ``KeyError`` for a name no gate has."""
    name = ALIASES.get(feature, feature)
    if name not in KNOWN_FEATURES:
        raise KeyError(f"unknown feature gate {feature!r}")
    return name


class FeatureGates:
    def __init__(self):
        self._mu = threading.Lock()
        self._enabled = {k: v for k, (v, _) in KNOWN_FEATURES.items()}

    def enabled(self, feature: str) -> bool:
        with self._mu:
            return self._enabled[canonical(feature)]

    def set_from_map(self, overrides: dict[str, bool]) -> None:
        unknown = sorted(k for k in overrides
                         if ALIASES.get(k, k) not in KNOWN_FEATURES)
        if unknown:
            raise KeyError(f"unknown feature gate(s) {unknown}")
        with self._mu:
            for k, v in overrides.items():
                self._enabled[canonical(k)] = bool(v)

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

    @contextmanager
    def override(self, feature: str, value: bool):
        """Set one gate for the ``with`` block, then put it back."""
        name = canonical(feature)
        with self._mu:
            old = self._enabled[name]
            self._enabled[name] = value
        try:
            yield
        finally:
            with self._mu:
                self._enabled[name] = old


DEFAULT_FEATURE_GATES = FeatureGates()  # the process-global gate


@dataclass
class SchedulerConfiguration:
    """``KubeSchedulerConfiguration`` analogue."""

    scheduler_name: str = "default-scheduler"
    backend: str = "batch"  # batch | oracle; "tpu" (the JAX package's name) = batch
    batch_interval: float = 0.05
    policy_config_file: str = ""  # a scheduler Policy as JSON (scheduler/policy.py)
    leader_elect: bool = False
    feature_gates: dict = field(default_factory=dict)
    # tracing and continuous telemetry (utils/tracing.py, timeseries.py,
    # telemetry.py); the daemon's flags of the same names override them
    trace: bool = False
    trace_dump_dir: str = ""
    timeseries: bool = False
    timeseries_interval: float = 1.0
    telemetry_sink: str = ""  # an http:// collector URL or a JSON-lines file


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
