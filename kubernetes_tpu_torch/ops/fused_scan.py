"""Host side of the fused segment scan (``csrc/fused_scan.cu``).

Port of ``kubernetes_tpu/ops/pallas_kernel.py``: ``pack`` lays one
segment's ``ScanStatic``/``ScanState`` out for the CUDA kernel,
``check_shape`` stands where ``supports_pallas`` stood, and
``launch``/``finalize``/``schedule`` mirror ``dispatch_batch_pallas``/
``finalize_batch_pallas``/``schedule_batch_pallas``.

Layouts, re-derived for the card: every node-axis plane is row-major int32
``[rows, N]`` (a row is contiguous over nodes, so the threads of a warp read
neighbouring columns); per-signature tables are ``[G, *]`` so one pod's row
is one contiguous read; each signature's active affinity terms are listed
up front (``term_list``/``term_count``) so the kernel walks only the terms
that can touch the pod.  Volume occupancy packs (any, non-sharable) into
two bits of a uint8 ``[V, N]`` plane, and each pod's volume slots pack into
one int32 each, as the Pallas kernel packed them.

All of this runs on the card: ``pack`` is torch code on the segment's own
device, and every entry point raises unless the tensors are on CUDA.  The
count of kernel launches is ``launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.carry import WEIGHT_KEYS, ScanState, ScanStatic
from . import _build

BLOCK = 1024
MAX_CLUSTER = 8
MAX_CPT = 16
MAX_ZONES = 8
MAX_TERMS = 128
MAX_PORTS = 256
MAX_SLOTS = 8
MAX_KINDS = 4
MAX_R = 8

# kernel launches since the count was last reset
launches = 0

_PTR_FIELDS = (
    "alloc", "alloc_pods", "exists", "zone", "static_ok", "aff_raw",
    "taint_raw", "score_raw", "interpod_raw", "node_domain", "dom_valid",
    "g_request", "g_nonzero", "g_ports", "g_has_spread", "spread_inc_t",
    "term_list", "term_count", "tm_t", "own_w", "own_ra", "own_raa",
    "own_all", "sym_w", "is_raa", "self_match", "vol_limits",
    "gids", "pod_vol",
    "req", "nz", "cnt", "ports", "spread", "dm", "downer", "total", "volf", "nk",
    "chosen", "rr_out",
)
_INT_FIELDS = ("n", "g", "t", "pv", "v", "r", "w", "k", "p_real", "num_zones",
               "rr0", "use_terms", "use_vols", "use_ports")


class ScanParams(ctypes.Structure):
    """Mirror of ``struct ScanParams`` in ``csrc/fused_scan.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS]
                + [("wt", ctypes.c_int32 * len(WEIGHT_KEYS))])


def load():
    """The kernel's library, built from ``csrc/fused_scan.cu`` on the first
    call in a process."""
    lib = _build.load("fused_scan")
    lib.fused_scan_launch.argtypes = [ctypes.POINTER(ScanParams), ctypes.c_void_p]
    lib.fused_scan_launch.restype = ctypes.c_int
    return lib


def check_shape(static: ScanStatic) -> None:
    """Raise ValueError for a segment the kernel's fixed-size shared
    arrays and thread mapping cannot take."""
    n, r = static.node_alloc.shape
    limits = (
        ("node axis", n, BLOCK * MAX_CLUSTER * MAX_CPT),
        ("zones", static.num_zones, MAX_ZONES),
        ("affinity terms", static.term_matches_sig.shape[0], MAX_TERMS),
        ("host-port vocabulary", static.g_ports.shape[1], MAX_PORTS),
        ("volume slots per pod", static.pod_vol_ids.shape[1], MAX_SLOTS),
        ("volume kinds", static.vol_limits.shape[0], MAX_KINDS),
        ("resources", r, MAX_R),
    )
    for what, got, most in limits:
        if got > most:
            raise ValueError(f"fused scan supports at most {most} {what}, segment has {got}")


def _require_cuda(static: ScanStatic, state: ScanState) -> None:
    if static.device.type != "cuda" or state.requested.device.type != "cuda":
        raise RuntimeError("the fused scan runs on CUDA tensors only; "
                           "scan_ref.scan is the plain version for the CPU")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def pack(static: ScanStatic, state: ScanState) -> dict:
    """Kernel-layout tensors for one segment, on the segment's device.  The
    state planes are fresh copies: the kernel updates them in place."""
    tm_t = _i32(static.term_matches_sig.t())  # [G, T]
    active = (tm_t != 0) | static.own_ra | static.own_raa | static.own_all | (static.own_w != 0)
    # active terms first, in term order (stable sort of the inactive flag)
    term_list = _i32(torch.sort((~active).to(torch.int8), dim=1, stable=True).indices)
    vol_flags = (state.vol_any.to(torch.uint8) | (state.vol_ns.to(torch.uint8) << 1)).contiguous()
    pod_vol = _i32(static.pod_vol_ids * 64 + static.pod_vol_kind * 8
                   + static.pod_vol_ro_ok.to(torch.int32) * 4
                   + static.pod_vol_count_only.to(torch.int32) * 2
                   + static.pod_vol_valid.to(torch.int32))
    dev = static.device
    return {
        "alloc": _i32(static.node_alloc.t()),
        "alloc_pods": _i32(static.node_alloc_pods),
        "exists": _i32(static.node_exists),
        "zone": _i32(static.node_zone),
        "static_ok": _i32(static.static_ok),
        "aff_raw": _i32(static.node_aff_raw),
        "taint_raw": _i32(static.taint_intol_raw),
        "score_raw": _i32(static.static_score),
        "interpod_raw": _i32(static.interpod_raw),
        "node_domain": _i32(static.node_domain),
        "dom_valid": _i32(static.dom_valid),
        "g_request": _i32(static.g_request),
        "g_nonzero": _i32(static.g_nonzero),
        "g_ports": _i32(static.g_ports),
        "g_has_spread": _i32(static.g_has_spread),
        "spread_inc_t": _i32(static.spread_inc.t()),
        "term_list": term_list,
        "term_count": _i32(active.sum(dim=1)),
        "tm_t": tm_t,
        "own_w": _i32(static.own_w),
        "own_ra": _i32(static.own_ra),
        "own_raa": _i32(static.own_raa),
        "own_all": _i32(static.own_all),
        "sym_w": _i32(static.sym_w),
        "is_raa": _i32(static.is_raa),
        "self_match": _i32(static.self_match),
        "vol_limits": _i32(static.vol_limits),
        "gids": _i32(static.group_of_pod),
        "pod_vol": pod_vol,
        "req": _i32(state.requested.t()),
        "nz": _i32(state.nonzero_requested.t()),
        "cnt": _i32(state.pod_count).clone(),
        "ports": _i32(state.ports_used.t()),
        "spread": _i32(state.spread_counts).clone(),
        "dm": _i32(state.dm).clone(),
        "downer": _i32(state.downer).clone(),
        "total": _i32(state.total_match).clone(),
        "volf": vol_flags,
        "nk": _i32(state.nk).clone(),
        "chosen": torch.full((max(static.p_real, 1),), -1, dtype=torch.int32, device=dev),
        "rr_out": torch.zeros(1, dtype=torch.int32, device=dev),
    }


def launch(static: ScanStatic, state: ScanState, bufs: dict) -> None:
    """Launch the kernel on the current stream over packed ``bufs``."""
    global launches
    _require_cuda(static, state)
    check_shape(static)
    n, r = static.node_alloc.shape
    params = ScanParams(
        **{f: bufs[f].data_ptr() for f in _PTR_FIELDS},
        n=n, g=static.static_ok.shape[0], t=static.term_matches_sig.shape[0],
        pv=static.g_ports.shape[1], v=static.v_state, r=r,
        w=static.pod_vol_ids.shape[1], k=static.vol_limits.shape[0],
        p_real=static.p_real, num_zones=static.num_zones,
        rr0=state.round_robin, use_terms=int(static.use_terms),
        use_vols=int(static.use_vols), use_ports=int(static.use_ports),
        wt=(ctypes.c_int32 * len(WEIGHT_KEYS))(*(static.weights[k] for k in WEIGHT_KEYS)),
    )
    stream = torch.cuda.current_stream(static.device).cuda_stream
    err = load().fused_scan_launch(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused scan launch failed (error {err})")
    launches += 1


def finalize(static: ScanStatic, bufs: dict) -> tuple[np.ndarray, int]:
    """Wait for the kernel and bring its result to the host: (chosen node
    index per pod, -1 = unschedulable; final round-robin counter)."""
    return bufs["chosen"][: static.p_real].cpu().numpy(), int(bufs["rr_out"].cpu()[0])


def schedule(static: ScanStatic, state: ScanState) -> tuple[np.ndarray, int]:
    """Pack, launch and wait: the whole segment scan on the card."""
    bufs = pack(static, state)
    launch(static, state, bufs)
    return finalize(static, bufs)
