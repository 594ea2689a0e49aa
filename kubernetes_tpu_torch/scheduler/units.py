"""Canonical fixed-point units — the scheduler's numeric spec.

One fixed-point representation is shared by the CPU oracle and the device
scan, so that "identical bindings" is a bit-exact, testable property:

- cpu               → integer millicores          (``Quantity.milli_value``)
- memory            → integer MiB, rounded up
- ephemeral-storage → integer MiB, rounded up
- nvidia.com/gpu    → integer count
- pods              → integer count

All scores are integers 0..10 per priority function (``MAX_PRIORITY``),
combined by integer weighted sum; fractional intermediates use 10-bit fixed
point (x*1024//y).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api import lazy as lazy_mod
from ..api import types as api
from ..api.quantity import Quantity

# Resource-vector slot layout: the R axis of every [N, R] / [G, R] array.
CPU_MILLI = 0
MEM_MIB = 1
STORAGE_MIB = 2
GPU_COUNT = 3
NUM_RESOURCES = 4

RESOURCE_SLOTS = {
    api.CPU: CPU_MILLI,
    api.MEMORY: MEM_MIB,
    api.EPHEMERAL_STORAGE: STORAGE_MIB,
    api.GPU: GPU_COUNT,
}

MAX_PRIORITY = 10
FIXED_POINT_ONE = 1024  # 10-bit fixed-point scale for fractions

# Priorities score against *non-zero* requests: containers with no request
# count as 100 millicores / 200 MiB.
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEM_MIB_REQUEST = 200

MIB = 2**20


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _away_from_zero_div(num: int, den: int) -> int:
    """Quantity.value()/milli_value() rounding: positives round away from
    zero; negatives take divmod's floor, which is also away from zero."""
    q, r = divmod(num, den)
    if r != 0 and num > 0:
        q += 1
    return q


def _slot_units(slot: int, f) -> int:
    if slot == CPU_MILLI:
        return _away_from_zero_div(f.numerator * 1000, f.denominator)
    if slot in (MEM_MIB, STORAGE_MIB):
        return _ceil_div(f.numerator, f.denominator * MIB)
    return _away_from_zero_div(f.numerator, f.denominator)


_slot_units_memo: dict = {}


def quantity_to_slot_units(slot: int, q: Quantity) -> int:
    """Canonicalize one Quantity into its slot's integer unit (memoized:
    resource strings come from a tiny vocabulary)."""
    f = q.fraction
    key = (slot, f.numerator, f.denominator)
    got = _slot_units_memo.get(key)
    if got is None:
        if len(_slot_units_memo) > 65536:
            _slot_units_memo.clear()
        got = _slot_units_memo[key] = _slot_units(slot, f)
    return got


@dataclass
class ResourceVec:
    """Fixed-size integer resource vector (one row of the [*, R] tensors)."""

    units: list[int]

    def __init__(self, units: "list[int] | None" = None):
        self.units = list(units) if units is not None else [0] * NUM_RESOURCES

    @classmethod
    def from_resource_list(cls, rl: dict[str, Quantity]) -> "ResourceVec":
        v = cls()
        for name, q in rl.items():
            slot = RESOURCE_SLOTS.get(name)
            if slot is not None:
                v.units[slot] += quantity_to_slot_units(slot, q)
        return v

    def add(self, other: "ResourceVec") -> None:
        for i in range(NUM_RESOURCES):
            self.units[i] += other.units[i]

    def sub(self, other: "ResourceVec") -> None:
        for i in range(NUM_RESOURCES):
            self.units[i] -= other.units[i]

    def copy(self) -> "ResourceVec":
        return ResourceVec(self.units)

    def __getitem__(self, slot: int) -> int:
        return self.units[slot]

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceVec) and self.units == other.units


# per-container request parse memo for the raw (wire-dict) path: keyed by
# the container's sorted request items, so a template-stamped fleet parses
# each distinct container shape once.  Content-keyed, never pinned a pod.
_raw_container_memo: dict = {}


def _raw_container_units(requests: dict) -> tuple[tuple, tuple]:
    """(request units, nonzero units) for one container's raw requests
    dict, in canonical slot order; nonzero applies the per-container
    cpu/mem defaults exactly like ``pod_nonzero_request_vec``."""
    key = tuple(sorted(requests.items()))
    got = _raw_container_memo.get(key)
    if got is None:
        if len(_raw_container_memo) > 65536:
            _raw_container_memo.clear()
        units = [0] * NUM_RESOURCES
        for name, q in requests.items():
            slot = RESOURCE_SLOTS.get(name)
            if slot is not None:
                units[slot] += quantity_to_slot_units(slot, Quantity(q))
        nz = list(units)
        if nz[CPU_MILLI] == 0:
            nz[CPU_MILLI] = DEFAULT_MILLI_CPU_REQUEST
        if nz[MEM_MIB] == 0:
            nz[MEM_MIB] = DEFAULT_MEM_MIB_REQUEST
        got = _raw_container_memo[key] = (tuple(units), tuple(nz))
    return got


def raw_request_units(spec: dict) -> tuple[list[int], list[int]]:
    """Summed (request, nonzero-request) unit vectors straight from a raw
    pod-spec dict: the column-batch / lazy-pod parse that must equal
    ``pod_request_vec``/``pod_nonzero_request_vec`` of the decoded pod."""
    req = [0] * NUM_RESOURCES
    nz = [0] * NUM_RESOURCES
    for c in spec.get("containers") or []:
        u, un = _raw_container_units(
            (c.get("resources") or {}).get("requests") or {})
        for i in range(NUM_RESOURCES):
            req[i] += u[i]
            nz[i] += un[i]
    return req, nz


def pod_request_vec(pod: api.Pod) -> ResourceVec:
    """Summed container requests in canonical units (predicate side).  A
    lazy pod whose spec is still undecoded parses from its wire dict."""
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        return ResourceVec(raw_request_units(spec_raw)[0])
    v = ResourceVec()
    for c in pod.spec.containers:
        v.add(ResourceVec.from_resource_list(c.resources.requests))
    return v


def pod_nonzero_request_vec(pod: api.Pod) -> ResourceVec:
    """Summed container requests with per-container cpu/mem defaults for
    empty requests (priority side)."""
    spec_raw = lazy_mod.undecoded_spec(pod)
    if spec_raw is not None:
        return ResourceVec(raw_request_units(spec_raw)[1])
    v = ResourceVec()
    for c in pod.spec.containers:
        cv = ResourceVec.from_resource_list(c.resources.requests)
        if cv.units[CPU_MILLI] == 0:
            cv.units[CPU_MILLI] = DEFAULT_MILLI_CPU_REQUEST
        if cv.units[MEM_MIB] == 0:
            cv.units[MEM_MIB] = DEFAULT_MEM_MIB_REQUEST
        v.add(cv)
    return v


def node_allocatable_vec(node: api.Node) -> ResourceVec:
    return ResourceVec.from_resource_list(node.status.allocatable)


def node_allocatable_pods(node: api.Node) -> int:
    q = node.status.allocatable.get(api.PODS)
    return q.value() if q is not None else 110
