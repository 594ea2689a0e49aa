"""Host side of the fused segment scan (``csrc/fused_scan.cu``).

Port of ``kubernetes_tpu/ops/pallas_kernel.py``: ``pack`` lays one
segment's ``ScanStatic``/``ScanState`` out for the CUDA kernel,
``check_shape`` stands where ``supports_pallas`` stood, and
``launch``/``finalize``/``schedule`` mirror ``dispatch_batch_pallas``/
``finalize_batch_pallas``/``schedule_batch_pallas``.

``plan`` decides how the kernel runs a segment: a cluster of ``cs`` blocks,
each owning ``cols`` contiguous node columns (a multiple of 16, so every
row slice is a 16-byte-aligned bulk copy), ``threads`` threads of ``cpt``
columns each, and which planes live in each block's shared memory.  It
places them in the fixed order of ``PLANES`` (the next pod's prefetched
rows, the small hot state planes, ``spread``, then the node-constant rows)
until the block's budget is spent; the rest stay in global memory and the
kernel reads them through the same code.  One kernel, one path.  It also
places the zone statistics (``zones_at``): up to ``REG_ZONES`` zones in
registers, more in shared memory while they fit ``ZONE_SMEM`` at the
plan's cluster size, and past that in a global scratch (``zbuf``) with a
second fold.  A signature row keeps its first ``MAX_PORTS`` port flags in
shared memory (``sws``); a wider row's other flags are read from global
memory.  No zone or port count is refused.

Layouts: every node-axis plane is row-major int32 ``[rows, ns]`` with
``ns = cs * cols`` (zero past column ``n``: no padded column exists, so none
is ever feasible); per-signature inputs are one ``sig`` row per signature
(requests, nonzero requests, the spread flag, the active-term count, nine
fields per active term, host ports) so a pod's whole signature is one bulk
copy; each pod's volume slots pack into one int32 each, as the Pallas
kernel packed them, and volume occupancy packs (any, non-sharable) into two
bits of a uint8 ``[V, ns]`` plane.

All of this runs on the card: ``pack`` is torch code on the segment's own
device, and every entry point raises unless the tensors are on CUDA.  The
count of kernel launches is ``launches``.

The frontier loop (``ops/frontier.py``) launches the same kernel once a
chunk of pods: ``launch(..., start=, count=, ctl=)`` points the pod inputs
and ``chosen`` at the chunk, reads and writes the round-robin counter in
the control words ``ctl`` on the card, honours their stop flag, advances
their cursor, and writes the state planes back; ``unpack_state`` reads the
written-back state as a ``ScanState``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..models.carry import WEIGHT_KEYS, ScanState, ScanStatic
from . import _build

MAX_THREADS = 512
MAX_CLUSTER = 16
MAX_CPT = 16
REG_ZONES = 8       # zones whose sums the kernel keeps in registers (the main path)
ZONE_SMEM = 65536   # bytes the zone statistics may take in a block's shared memory
MAX_TERMS = 128
MAX_PORTS = 256     # port flags a signature row holds in shared memory
MAX_SLOTS = 8
MAX_KINDS = 4
MAX_R = 8
MAX_NODES = 131072
TERM_FIELDS = 9
POD_ROWS = 5
NBUF = 3  # pod input buffers: pod i+2 is fetched while pod i runs
# shared memory a block may use on the card (227 KB), less what the
# kernel's static arrays take; the launch checks the real figure
SMEM_LIMIT = 232448
STATIC_RESERVE = 8192
COLS_TARGET = 320   # columns a block aims at before the cluster grows
DEFAULT_CPT = 1     # columns a thread, measured on the card (PERF.md)



def _msg_a_words(zones: int) -> int:
    return -(-(10 + 2 * zones) // 4) * 4


def zone_bytes(zones: int, cs: int = MAX_CLUSTER) -> int:
    """Shared memory of the zone statistics in a cluster of ``cs``: both
    inboxes of exchange (a) (10 + 2 words a zone from every block) and,
    past ``REG_ZONES``, the per-zone accumulator and totals (int64 each)."""
    return 2 * cs * _msg_a_words(zones) * 4 + (16 * zones if zones > REG_ZONES else 0)


def zones_at(zones: int, cs: int) -> str:
    """Where a cluster of ``cs`` keeps the statistics of ``zones`` zones:
    ``registers``, ``shared`` memory while they fit ``ZONE_SMEM``, else
    ``global`` memory."""
    if zones <= REG_ZONES:
        return "registers"
    return "shared" if zone_bytes(zones, cs) <= ZONE_SMEM else "global"


def zbuf_words(zones: int, cs: int) -> int:
    """int64 words of the global zone scratch: the accumulators of both
    pod parities [2, cs, zones], then each block's totals [cs, zones]."""
    return 3 * cs * zones

# placement order; the kernel's `enum Plane` lists the same names
PLANES = ("pod_rows", "spread_inc", "req", "nz", "cnt", "ports", "dm", "downer",
          "volf", "nk", "spread", "res", "alloc", "alloc_pods", "exists", "zone",
          "node_domain", "dom_valid")

# kernel launches since the count was last reset
launches = 0

# the frontier loop's control words: one int32 tensor on the card that the
# chunk launches and the refresh kernel (frontier_refresh.cu) share; CTL_ACC
# is the refresh's count word (tiles done, the alive count), zero between
# refreshes; word 4 is unused
CTL_CURSOR, CTL_STOP, CTL_ALIVE, CTL_ACC = range(4)
CTL_RR = 5
CTL_WORDS = 8

_PTR_FIELDS = (
    "alloc", "alloc_pods", "exists", "zone", "static_ok", "aff_raw",
    "taint_raw", "score_raw", "interpod_raw", "node_domain", "dom_valid",
    "sig", "spread_inc_t", "vol_limits", "gids", "pod_vol",
    "req", "nz", "cnt", "ports", "spread", "dm", "downer", "total", "volf", "nk", "res",
    "chosen", "rr_out", "zbuf", "rr_in", "stop", "cursor",
)
_INT_FIELDS = ("n", "ns", "cols", "cs", "threads", "cpt",
               "g", "g4", "t", "pv", "v", "r", "w", "w4", "k", "sw", "sws",
               "p_real", "num_zones", "rr0",
               "use_terms", "use_vols", "use_ports", "smem_bytes",
               "gnz_off", "inbox_a_off", "inbox_b_off", "msg_a", "msg_b", "zone_off",
               "write_back")


class ScanParams(ctypes.Structure):
    """Mirror of ``struct ScanParams`` in ``csrc/fused_scan.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS]
                + [("wt", ctypes.c_int32 * len(WEIGHT_KEYS)),
                   ("off", ctypes.c_int32 * len(PLANES))])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one segment."""

    cs: int          # blocks in the cluster
    cols: int        # node columns a block owns
    ns: int          # row stride of the packed planes, cs * cols
    threads: int     # threads a block
    cpt: int         # columns a thread
    sw: int          # ints in a signature row
    sws: int         # ints of it a pod buffer in shared memory holds
    g4: int          # ints in a spread-increment row
    w4: int          # ints in a pod's volume-slot row
    msg_a: int       # words of a block's statistics message (exchange a)
    msg_b: int       # words of a block's best-and-ties message (exchange b)
    gnz_off: int     # byte offsets in shared memory of the signatures' nonzero
    inbox_a_off: int  # requests and of the two exchanges' inboxes
    inbox_b_off: int
    zone_off: int     # zones in shared memory: zone accumulator and totals (else 0)
    zones_at: str     # "registers", "shared" or "global" (see zones_at)
    fixed_bytes: int  # buffers, nonzero requests, inboxes and zone arrays, before the planes
    smem_bytes: int  # dynamic shared memory a block
    offsets: dict    # plane -> byte offset in shared memory, None = global memory
    plane_bytes: dict

    @property
    def shared(self) -> tuple:
        return tuple(k for k in PLANES if self.offsets[k] is not None)

    @property
    def global_(self) -> tuple:
        return tuple(k for k in PLANES if self.offsets[k] is None)


def _dims(static: ScanStatic) -> dict:
    n, r = static.node_alloc.shape
    return dict(n=n, r=r, g=static.static_ok.shape[0], t=static.term_matches_sig.shape[0],
                pv=static.g_ports.shape[1], v=static.v_state, w=static.pod_vol_ids.shape[1],
                k=static.vol_limits.shape[0], zones=static.num_zones)


def plan_for(n: int, r: int, g: int, t: int, pv: int, v: int, w: int, k: int, zones: int,
             use_terms: bool, use_vols: bool, use_ports: bool,
             cpt: int | None = None, cs: int | None = None) -> Plan:
    """The plan at these shapes: cluster size, block size and placement.
    ``cpt``/``cs`` override the defaults (for measuring designs)."""
    if cs is None:
        cs = min(MAX_CLUSTER, max(1, -(-n // COLS_TARGET)))
    cols = _round_up(max(1, -(-n // cs)), 16)
    want = DEFAULT_CPT if cpt is None else cpt
    # the kernel is built for 1, 2, 4, 8 and MAX_CPT columns a thread
    cpt = next(c for c in (1, 2, 4, 8, MAX_CPT) if c >= want and -(-cols // c) <= MAX_THREADS)
    threads = _round_up(-(-cols // cpt), 32)
    sw = _round_up(r + 4 + TERM_FIELDS * t + pv, 4)
    sws = min(sw, _round_up(r + 4 + TERM_FIELDS * t + MAX_PORTS, 4))
    g4 = _round_up(max(g, 1), 4)
    w4 = _round_up(max(w, 1), 4)
    terms = t if use_terms else 0
    rows = {"req": r, "nz": 2, "cnt": 1, "ports": pv if use_ports else 0, "dm": terms,
            "downer": terms, "volf": v if use_vols else 0, "nk": k if use_vols else 0,
            "spread": g, "res": g, "alloc": r, "alloc_pods": 1, "exists": 1, "zone": 1,
            "node_domain": terms, "dom_valid": terms}
    plane_bytes = {"pod_rows": NBUF * POD_ROWS * cols * 4, "spread_inc": NBUF * g4 * 4}
    esz = {"volf": 1, "res": 2}
    plane_bytes.update({p: rows[p] * cols * esz.get(p, 4) for p in rows})
    budget = SMEM_LIMIT - STATIC_RESERVE
    warps = threads // 32
    where = zones_at(zones, cs)
    zones_smem = where == "shared"
    # the global zone path sends only the statistics' 10 words
    msg_a = _msg_a_words(0 if where == "global" else zones)
    msg_b = _round_up(3 + cpt * warps, 4)
    gnz_off = NBUF * (sws + w4) * 4
    inbox_a_off = gnz_off + 2 * g4 * 4
    inbox_b_off = inbox_a_off + 2 * cs * msg_a * 4
    zone_off = inbox_b_off + 2 * cs * msg_b * 4
    fixed = zone_off + (16 * zones if zones_smem else 0)
    zone_off = zone_off if zones_smem else 0
    off = fixed
    offsets, placing = {}, True
    for p in PLANES:
        placing = placing and off + plane_bytes[p] <= budget
        offsets[p] = off if placing else None
        off += plane_bytes[p] if placing else 0
    return Plan(cs=cs, cols=cols, ns=cs * cols, threads=threads, cpt=cpt, sw=sw, sws=sws,
                g4=g4, w4=w4, msg_a=msg_a, msg_b=msg_b, gnz_off=gnz_off,
                inbox_a_off=inbox_a_off, inbox_b_off=inbox_b_off, zone_off=zone_off,
                zones_at=where, fixed_bytes=fixed, smem_bytes=off, offsets=offsets,
                plane_bytes=plane_bytes)


def plan(static: ScanStatic, cpt: int | None = None, cs: int | None = None) -> Plan:
    """The plan for one segment (after ``check_shape``)."""
    check_shape(static)
    return plan_for(**_dims(static), use_terms=bool(static.use_terms),
                    use_vols=bool(static.use_vols), use_ports=bool(static.use_ports),
                    cpt=cpt, cs=cs)


def load():
    """The kernel's library, built from ``csrc/fused_scan.cu`` on the first
    call in a process."""
    lib = _build.load("fused_scan")
    lib.fused_scan_launch.argtypes = [ctypes.POINTER(ScanParams), ctypes.c_void_p]
    lib.fused_scan_launch.restype = ctypes.c_int
    lib.fused_scan_query.argtypes = [ctypes.POINTER(ScanParams), ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.fused_scan_query.restype = ctypes.c_int
    return lib


def check_shape(static: ScanStatic) -> None:
    """Raise ValueError for a segment the kernel's fixed-size shared
    arrays and thread mapping cannot take."""
    n, r = static.node_alloc.shape
    limits = (
        ("node axis", n, MAX_NODES),
        ("affinity terms", static.term_matches_sig.shape[0], MAX_TERMS),
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


def _cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` zero-padded on its last axis to ``width``, as a fresh
    contiguous tensor (the kernel updates state planes in place)."""
    pad = width - x.shape[-1]
    return (F.pad(x, (0, pad)) if pad else x.clone()).contiguous()


def signature_rows(static: ScanStatic, width: int) -> torch.Tensor:
    """[G, width] int32: each signature's request [R], nonzero request [2],
    spread flag, active-term count, then for each active term (in term
    order) TERM_FIELDS fields — t, m_g, own_ra, own_raa, own_all, own_w,
    sym_w * m_g, m_g and is_raa, self_match — then the host ports [Pv]."""
    g, r = static.g_request.shape
    t = static.term_matches_sig.shape[0]
    tm = static.term_matches_sig.t()  # [G, T]
    active = tm | static.own_ra | static.own_raa | static.own_all | (static.own_w != 0)
    # active terms first, in term order (stable sort of the inactive flag)
    order = torch.sort((~active).to(torch.int8), dim=1, stable=True).indices  # [G, T]
    fields = (torch.arange(t, device=tm.device).expand(g, t), tm, static.own_ra,
              static.own_raa, static.own_all, static.own_w, tm * static.sym_w[None, :],
              tm & static.is_raa[None, :], static.self_match[None, :].expand(g, t))
    per_term = torch.stack([f.to(torch.int32) for f in fields], dim=2)  # [G, T, F]
    per_term = per_term.gather(1, order[:, :, None].expand(g, t, TERM_FIELDS))
    sig = torch.cat([
        static.g_request.to(torch.int32), static.g_nonzero.to(torch.int32),
        static.g_has_spread.to(torch.int32)[:, None], active.sum(dim=1, dtype=torch.int32)[:, None],
        per_term.reshape(g, t * TERM_FIELDS), static.g_ports.to(torch.int32)], dim=1)
    return _cols(sig, width)


def pack(static: ScanStatic, state: ScanState, plan_: Plan | None = None) -> dict:
    """Kernel-layout tensors for one segment, on the segment's device.  The
    state planes are fresh copies: the kernel updates them in place."""
    pl = plan_ or plan(static)
    ns = pl.ns
    vol_flags = state.vol_any.to(torch.uint8) | (state.vol_ns.to(torch.uint8) << 1)
    pod_vol = (static.pod_vol_ids * 64 + static.pod_vol_kind * 8
               + static.pod_vol_ro_ok.to(torch.int32) * 4
               + static.pod_vol_count_only.to(torch.int32) * 2
               + static.pod_vol_valid.to(torch.int32))
    dev = static.device
    return {
        "alloc": _cols(_i32(static.node_alloc.t()), ns),
        "alloc_pods": _cols(_i32(static.node_alloc_pods), ns),
        "exists": _cols(_i32(static.node_exists), ns),
        "zone": _cols(_i32(static.node_zone), ns),
        "static_ok": _cols(_i32(static.static_ok), ns),
        "aff_raw": _cols(_i32(static.node_aff_raw), ns),
        "taint_raw": _cols(_i32(static.taint_intol_raw), ns),
        "score_raw": _cols(_i32(static.static_score), ns),
        "interpod_raw": _cols(_i32(static.interpod_raw), ns),
        "node_domain": _cols(_i32(static.node_domain), ns),
        "dom_valid": _cols(_i32(static.dom_valid), ns),
        "sig": signature_rows(static, pl.sw),
        "spread_inc_t": _cols(_i32(static.spread_inc.t()), pl.g4),
        "vol_limits": _i32(static.vol_limits),
        "gids": _i32(static.group_of_pod),
        "pod_vol": _cols(_i32(pod_vol), pl.w4),
        "req": _cols(_i32(state.requested.t()), ns),
        "nz": _cols(_i32(state.nonzero_requested.t()), ns),
        "cnt": _cols(_i32(state.pod_count), ns),
        "ports": _cols(_i32(state.ports_used.t()), ns),
        "spread": _cols(_i32(state.spread_counts), ns),
        "dm": _cols(_i32(state.dm), ns),
        "downer": _cols(_i32(state.downer), ns),
        "total": _i32(state.total_match).clone(),
        "volf": _cols(vol_flags.contiguous(), ns),
        "nk": _cols(_i32(state.nk), ns),
        # scratch: the kernel fills it (resource scores per signature and node)
        "res": torch.empty((static.static_ok.shape[0], ns), dtype=torch.int16, device=dev),
        "chosen": torch.full((max(static.p_real, 1),), -1, dtype=torch.int32, device=dev),
        "rr_out": torch.zeros(1, dtype=torch.int32, device=dev),
        # scratch of the global zone path (see zones_at), zeroed; empty
        # (and passed as null) on the other paths
        "zbuf": torch.zeros(zbuf_words(static.num_zones, pl.cs) if pl.zones_at == "global" else 0,
                            dtype=torch.int64, device=dev),
    }


def params(static: ScanStatic, state: ScanState, bufs: dict, pl: Plan, start: int = 0,
           count: int | None = None, ctl: torch.Tensor | None = None) -> ScanParams:
    """The kernel's argument block for packed ``bufs`` under plan ``pl``:
    the whole segment, or with ``ctl`` (the frontier loop's control words)
    the ``count`` pods from ``start``, the counter, stop flag and cursor in
    ``ctl``, and the state planes written back."""
    d = _dims(static)
    ptrs = {f: bufs[f].data_ptr() for f in _PTR_FIELDS
            if f not in ("zbuf", "rr_in", "stop", "cursor")}
    count = static.p_real - start if count is None else count
    if ctl is not None:
        word = ctl.element_size()
        ptrs["gids"] += start * 4
        ptrs["pod_vol"] += start * pl.w4 * 4
        ptrs["chosen"] += start * 4
        ptrs["rr_out"] = ctl.data_ptr() + CTL_RR * word
        ptrs.update(rr_in=ptrs["rr_out"], stop=ctl.data_ptr() + CTL_STOP * word,
                    cursor=ctl.data_ptr() + CTL_CURSOR * word)
    elif start or count != static.p_real:
        raise ValueError("a pod range is a frontier-loop launch: pass its control words")
    return ScanParams(
        **ptrs,
        zbuf=bufs["zbuf"].data_ptr() if pl.zones_at == "global" else None,
        n=d["n"], ns=pl.ns, cols=pl.cols, cs=pl.cs, threads=pl.threads, cpt=pl.cpt,
        g=d["g"], g4=pl.g4, t=d["t"], pv=d["pv"], v=d["v"], r=d["r"], w=d["w"], w4=pl.w4,
        k=d["k"], sw=pl.sw, sws=pl.sws, p_real=count, num_zones=static.num_zones,
        rr0=state.round_robin, use_terms=int(static.use_terms),
        use_vols=int(static.use_vols), use_ports=int(static.use_ports),
        smem_bytes=pl.smem_bytes, gnz_off=pl.gnz_off, inbox_a_off=pl.inbox_a_off,
        inbox_b_off=pl.inbox_b_off, msg_a=pl.msg_a, msg_b=pl.msg_b, zone_off=pl.zone_off,
        write_back=int(ctl is not None),
        wt=(ctypes.c_int32 * len(WEIGHT_KEYS))(*(static.weights[k] for k in WEIGHT_KEYS)),
        off=(ctypes.c_int32 * len(PLANES))(
            *(-1 if pl.offsets[p] is None else pl.offsets[p] for p in PLANES)),
    )


def query(static: ScanStatic, state: ScanState, bufs: dict, pl: Plan) -> dict:
    """What the card says of plan ``pl`` without launching: how many
    clusters of its size fit at once, and the kernel's static shared
    memory.  Raises where the plan cannot run."""
    _require_cuda(static, state)
    clusters, static_smem = ctypes.c_int(0), ctypes.c_int(0)
    err = load().fused_scan_query(ctypes.byref(params(static, state, bufs, pl)),
                                  ctypes.byref(clusters), ctypes.byref(static_smem))
    if err != 0:
        raise RuntimeError(f"fused scan plan refused (error {err})")
    return {"max_active_clusters": clusters.value, "static_smem": static_smem.value}


def launch(static: ScanStatic, state: ScanState, bufs: dict, plan_: Plan | None = None,
           start: int = 0, count: int | None = None, ctl: torch.Tensor | None = None) -> None:
    """Launch the kernel on the current stream over packed ``bufs`` (packed
    under the same plan): the whole segment, or with ``ctl`` one chunk of
    the frontier loop (see ``params``)."""
    global launches
    _require_cuda(static, state)
    pl = plan_ or plan(static)
    stream = torch.cuda.current_stream(static.device).cuda_stream
    err = load().fused_scan_launch(
        ctypes.byref(params(static, state, bufs, pl, start, count, ctl)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused scan launch failed (error {err})")
    launches += 1


def unpack_state(static: ScanStatic, bufs: dict, round_robin: int,
                 still_ok: torch.Tensor | None = None) -> ScanState:
    """The carried state as a ``ScanState`` at the segment's width, read
    from the kernel's written-back planes (the inverse of ``pack``'s state
    part); ``still_ok`` [G, >= n] rides along cut to the width."""
    n = static.n_pad
    b = bufs
    return ScanState(
        requested=b["req"][:, :n].t().contiguous(), nonzero_requested=b["nz"][:, :n].t().contiguous(),
        pod_count=b["cnt"][:n].clone(), ports_used=b["ports"][:, :n].t().bool().contiguous(),
        spread_counts=b["spread"][:, :n].clone(), round_robin=int(round_robin),
        dm=b["dm"][:, :n].clone(), downer=b["downer"][:, :n].clone(), total_match=b["total"].clone(),
        vol_any=(b["volf"][:, :n] & 1).bool(), vol_ns=((b["volf"][:, :n] >> 1) & 1).bool(),
        nk=b["nk"][:, :n].clone(),
        still_ok=still_ok[:, :n].clone() if still_ok is not None else None)


def finalize(static: ScanStatic, bufs: dict) -> tuple[np.ndarray, int]:
    """Wait for the kernel and bring its result to the host: (chosen node
    index per pod, -1 = unschedulable; final round-robin counter)."""
    return bufs["chosen"][: static.p_real].cpu().numpy(), int(bufs["rr_out"].cpu()[0])


def schedule(static: ScanStatic, state: ScanState) -> tuple[np.ndarray, int]:
    """Pack, launch and wait: the whole segment scan on the card."""
    bufs = pack(static, state)
    launch(static, state, bufs)
    return finalize(static, bufs)
