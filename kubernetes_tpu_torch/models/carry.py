"""The state carried across to the device: one segment's static arrays and
its initial scan state as torch tensors.

``from_reference`` takes the fields of a tensorized segment as plain dicts
of numpy arrays and ints — the field names and layouts of the tensorizer's
``BatchStatic`` / ``InitialState`` (``vars(static)``, ``vars(init)``) — and
places them on ``device``.  The backend feeds it the port's own tensorizer
output; the tests feed it the JAX package's, so both packages scan the very
same input.  ``init["still_ok"]`` (the frontier seed, when present) rides
along as ``ScanState.still_ok``; ``node_arrays`` takes the four node-axis
statics from a device-resident cache (``ops/node_cache.py``) instead of
uploading them.

``static["r_sel"]`` (the tensorizer's resource-axis selection, None or
absent: every slot) slices the resource axis of ``node_alloc``,
``g_request`` and ``requested`` on the way: the device sees R =
``len(r_sel)`` while the host arrays stay full width.  Cached
``node_arrays`` are already sliced (the cache slices at upload).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

WEIGHT_KEYS = ("least", "most", "balanced", "spread", "node_affinity", "taint", "interpod")


@dataclass
class ScanStatic:
    """Static inputs of one segment scan (node axis N, signatures G, terms
    T, volume rows V, resources R, slots per pod W, pods P)."""

    n_pad: int
    num_zones: int
    weights: dict  # WEIGHT_KEYS -> int
    use_terms: bool
    use_vols: bool
    use_ports: bool
    v_state: int
    node_exists: torch.Tensor  # [N] bool
    node_alloc: torch.Tensor  # [N, R] int32
    node_alloc_pods: torch.Tensor  # [N] int32
    node_zone: torch.Tensor  # [N] int32, -1 = no zone
    static_ok: torch.Tensor  # [G, N] bool
    node_aff_raw: torch.Tensor  # [G, N] int32
    taint_intol_raw: torch.Tensor  # [G, N] int32
    static_score: torch.Tensor  # [G, N] int32
    interpod_raw: torch.Tensor  # [G, N] int32
    g_request: torch.Tensor  # [G, R] int32
    g_nonzero: torch.Tensor  # [G, 2] int32
    g_ports: torch.Tensor  # [G, Pv] bool
    g_has_spread: torch.Tensor  # [G] bool
    spread_inc: torch.Tensor  # [G, G] int32 (column h: increments when sig h lands)
    term_matches_sig: torch.Tensor  # [T, G] bool
    sym_w: torch.Tensor  # [T] int32
    own_w: torch.Tensor  # [G, T] int32
    own_ra: torch.Tensor  # [G, T] bool
    own_raa: torch.Tensor  # [G, T] bool
    own_all: torch.Tensor  # [G, T] bool
    is_raa: torch.Tensor  # [T] bool
    self_match: torch.Tensor  # [T] bool
    node_domain: torch.Tensor  # [T, N] int32
    dom_valid: torch.Tensor  # [T, N] bool
    vol_limits: torch.Tensor  # [K] int32
    group_of_pod: torch.Tensor  # [P] int32
    pod_vol_ids: torch.Tensor  # [P, W] int32 (sentinel v_state-1 for unused slots)
    pod_vol_valid: torch.Tensor  # [P, W] bool
    pod_vol_ro_ok: torch.Tensor  # [P, W] bool
    pod_vol_kind: torch.Tensor  # [P, W] int32 (K = kind without a count limit)
    pod_vol_count_only: torch.Tensor  # [P, W] bool

    @property
    def p_real(self) -> int:
        return int(self.group_of_pod.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_exists.device


@dataclass
class ScanState:
    """The mutable scan carry at the start of a segment."""

    requested: torch.Tensor  # [N, R] int32
    nonzero_requested: torch.Tensor  # [N, 2] int32
    pod_count: torch.Tensor  # [N] int32
    ports_used: torch.Tensor  # [N, Pv] bool
    spread_counts: torch.Tensor  # [G, N] int32
    round_robin: int
    dm: torch.Tensor  # [T, N] int32 pods matching term t in node n's domain
    downer: torch.Tensor  # [T, N] int32 placed owners of term t in the domain
    total_match: torch.Tensor  # [T] int32 pods matching term t anywhere
    vol_any: torch.Tensor  # [V, N] bool
    vol_ns: torch.Tensor  # [V, N] bool non-sharable instance present
    nk: torch.Tensor  # [K, N] int32 distinct limited-kind disks per node
    # frontier mode: the monotone feasibility plane per signature, True
    # where the node may still take a pod of it (None outside the frontier)
    still_ok: Optional[torch.Tensor] = None  # [G, N] bool


_STATIC_INT = ("node_alloc", "node_alloc_pods", "node_zone", "node_aff_raw",
               "taint_intol_raw", "static_score", "interpod_raw", "g_request",
               "g_nonzero", "spread_inc", "sym_w", "own_w", "node_domain",
               "vol_limits", "group_of_pod", "pod_vol_ids", "pod_vol_kind")
_STATIC_BOOL = ("node_exists", "static_ok", "g_ports", "g_has_spread",
                "term_matches_sig", "own_ra", "own_raa", "own_all", "is_raa",
                "self_match", "dom_valid", "pod_vol_valid", "pod_vol_ro_ok",
                "pod_vol_count_only")
_STATE_INT = ("requested", "nonzero_requested", "pod_count", "spread_counts",
              "dm", "downer", "total_match", "nk")
_STATE_BOOL = ("ports_used", "vol_any", "vol_ns")
# the node-axis statics a DeviceNodeCache keeps on the card
NODE_FIELDS = ("node_exists", "node_alloc", "node_alloc_pods", "node_zone")
# the fields with a resource axis (their last), sliced by r_sel on the way
R_FIELDS = ("node_alloc", "g_request", "requested")


def r_slice(arr, f: str, r_sel):
    """``arr`` (field ``f``) as the device takes it: its resource axis cut
    to ``r_sel`` for an ``R_FIELDS`` field, else as it is."""
    return arr[..., r_sel] if r_sel is not None and f in R_FIELDS else arr


def _put(arr, dtype, device) -> torch.Tensor:
    np_dtype = np.int32 if dtype is torch.int32 else np.bool_
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np_dtype)).to(device)


def from_reference(static: dict, init: dict, device,
                   node_arrays: Optional[tuple] = None) -> tuple[ScanStatic, ScanState]:
    """Place one tensorized segment on ``device``.  ``static`` and ``init``
    hold the tensorizer's field names; ``static["terms"]`` may be the term
    list or its length (only its truth matters here).  ``node_arrays``,
    when given, are the ``NODE_FIELDS`` tensors already on ``device``, or
    a tuple of one a card (``ops.node_cache`` under a mesh over several
    cards), joined on ``device`` in shard order."""
    device = torch.device(device)
    weights = {k: int(static["weights"].get(k, 0)) for k in WEIGHT_KEYS}
    count_only = static.get("pod_vol_count_only")
    if count_only is None:
        count_only = np.zeros_like(static["pod_vol_valid"])
    cached = {f: torch.cat([p.to(device) for p in a]) if isinstance(a, tuple) else a
              for f, a in zip(NODE_FIELDS, node_arrays or ())}
    r_sel = static.get("r_sel")
    s = {f: cached[f] if f in cached else _put(r_slice(static[f], f, r_sel), torch.int32, device)
         for f in _STATIC_INT}
    s.update({f: cached[f] if f in cached else
              _put(static[f] if f != "pod_vol_count_only" else count_only, torch.bool, device)
              for f in _STATIC_BOOL})
    scan_static = ScanStatic(
        n_pad=int(static["n_pad"]),
        num_zones=int(static["num_zones"]),
        weights=weights,
        use_terms=bool(static["terms"]),
        use_vols=bool(static["use_vols"]),
        use_ports=bool(static.get("use_ports", True)),
        v_state=int(static["v_state"]),
        **s,
    )
    st = {f: _put(r_slice(init[f], f, r_sel), torch.int32, device) for f in _STATE_INT}
    st.update({f: _put(init[f], torch.bool, device) for f in _STATE_BOOL})
    still_ok = init.get("still_ok")
    if still_ok is not None:
        st["still_ok"] = _put(still_ok, torch.bool, device)
    return scan_static, ScanState(round_robin=int(init["round_robin"]), **st)
