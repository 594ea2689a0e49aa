"""Host side of the sharded segment scan (``csrc/mesh_scan.cu``).

Port of the JAX package's sharded wave loop (``kubernetes_tpu/ops/
batch_kernel.py::_sharded_loop_runner``: the scan step under ``shard_map``
over a node-axis mesh, ``parallel/mesh.py``).  The shards come from
``parallel.mesh.place_static`` / ``place_state``: one ``ScanStatic`` and
``ScanState`` a shard, each its slice of the node axis.

``plan`` decides how the kernel covers them: ``blocks`` blocks a shard, each
owning ``cols`` contiguous columns of its shard (a multiple of 32: one tie
word a 32 columns), ``threads`` threads a block, and the message layout of
the two exchanges a pod: (a) ``msg_a`` int64 words of statistics (7, then a
sum a zone), (b) the best score and the tie count, and ``bw`` tie words.
``exchanges`` reads that layout as the per-pod exchange plan that
``parallel.mesh.assert_collective_structure`` checks.  ``pack`` lays each
shard's planes out as the fused scan does (``fused_scan.pack_planes``, at the
packed width ``ns``, which the frontier refresh takes per shard too), the
replicated tables once, and the per-shard pointer table the kernel reads.
``launch`` runs the pods ``[start, start + count)`` with the frontier loop's
control words (``fused_scan.CTL_*``); ``schedule`` packs, launches and
waits.

Every entry point that touches the card raises unless the shards' tensors
are on one CUDA device (shards on several cards are not written); a launch
the card refuses (a grid too large to be resident at once) raises too.
There is no fallback.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..models.carry import WEIGHT_KEYS
from . import _build, fused_scan

MAX_SHARDS = 16
MAX_THREADS = 256
COLS_TARGET = 256   # columns a block aims at
NSTAT = 7           # the statistics of exchange (a) before the zone sums
SMEM_BUDGET = 200 * 1024

# the per-shard planes of the pointer table, in the kernel's `enum ShardPlane` order
SHARD_PLANES = ("alloc", "alloc_pods", "exists", "zone", "static_ok", "aff_raw", "taint_raw",
                "score_raw", "interpod_raw", "node_domain", "dom_valid", "req", "nz", "cnt",
                "ports", "spread", "dm", "downer", "volf", "nk")

# kernel launches since the count was last reset
launches = 0

_PTR_FIELDS = ("shards", "sig", "spread_inc_t", "vol_limits", "gids", "pod_vol", "total",
               "chosen", "mbox_a", "mbox_b", "ballots", "barrier", "rr", "stop", "cursor")
_INT_FIELDS = ("shards_n", "blocks", "threads", "cols", "n_local", "ns",
               "g", "g4", "t", "pv", "v", "r", "w", "w4", "k", "sw",
               "p_real", "num_zones", "use_terms", "use_vols", "use_ports",
               "msg_a", "bw", "smem_bytes")


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh_scan.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS]
                + [("wt", ctypes.c_int32 * len(WEIGHT_KEYS))])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class MeshPlan:
    """How the kernel covers one segment's shards."""

    shards: int      # S
    blocks: int      # blocks a shard
    threads: int     # threads a block
    cols: int        # columns a block owns (a multiple of 32)
    n_local: int     # a shard's width: its column j is global column k * n_local + j
    ns: int          # packed width of a shard's planes (the refresh's too)
    sw: int          # ints in a signature row
    g4: int
    w4: int
    msg_a: int       # int64 words of a block's statistics message
    bw: int          # tie words a block: cols / 32
    smem_bytes: int  # dynamic shared memory a block

    @property
    def grid(self) -> int:
        return self.shards * self.blocks


def plan_for(n_local: int, shards: int, r: int, g: int, t: int, pv: int, w: int,
             zones: int) -> MeshPlan:
    """The plan at these shapes (``n_local`` columns a shard)."""
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"the mesh kernel takes 1 to {MAX_SHARDS} shards, got {shards}")
    blocks = max(1, -(-n_local // COLS_TARGET))
    cols = _round_up(max(1, -(-n_local // blocks)), 32)
    threads = min(MAX_THREADS, cols)
    smem = _round_up(17 * cols + 16 * zones, 16)
    if smem > SMEM_BUDGET:
        raise ValueError(f"the mesh kernel's block needs {smem} bytes of shared memory "
                         f"({zones} zones), over {SMEM_BUDGET}")
    return MeshPlan(shards=shards, blocks=blocks, threads=threads, cols=cols, n_local=n_local,
                    ns=max(16, _round_up(n_local, 16)),
                    sw=_round_up(r + 4 + fused_scan.TERM_FIELDS * t + pv, 4),
                    g4=_round_up(max(g, 1), 4), w4=_round_up(max(w, 1), 4),
                    msg_a=NSTAT + zones, bw=cols // 32, smem_bytes=smem)


def plan(statics: list) -> MeshPlan:
    """The plan for a segment split into ``statics`` (one a shard)."""
    s = statics[0]
    fused_scan.check_shape(s)
    d = fused_scan._dims(s)
    return plan_for(s.n_pad, len(statics), d["r"], d["g"], d["t"], d["pv"], d["w"],
                    d["zones"])


def exchanges(pl: MeshPlan) -> list:
    """The cross-shard exchanges of one pod under plan ``pl``, each with
    the collective it stands for and the words every block together
    sends: (a) the statistics, summed, maxed and minned (the JAX seams'
    psum / pmax / pmin); (b) each block's best score and tie count, and
    its tie words, read by every block (the tie prefix's all_gather and
    ``_ax_first_true``)."""
    return [
        {"name": "statistics", "collective": "all-reduce", "words": 2 * pl.grid * pl.msg_a},
        {"name": "best_and_ties", "collective": "all-gather", "words": 4 * pl.grid},
        {"name": "tie_words", "collective": "all-gather", "words": pl.grid * pl.bw},
    ]


def load():
    """The kernel's library, built from ``csrc/mesh_scan.cu`` on the first
    call in a process."""
    lib = _build.load("mesh_scan")
    lib.mesh_scan_launch.argtypes = [ctypes.POINTER(MeshParams), ctypes.c_void_p]
    lib.mesh_scan_launch.restype = ctypes.c_int
    lib.mesh_scan_query.argtypes = [ctypes.POINTER(MeshParams), ctypes.POINTER(ctypes.c_int)]
    lib.mesh_scan_query.restype = ctypes.c_int
    return lib


def _device(statics: list, states: list) -> torch.device:
    devs = {s.device for s in statics} | {st.pod_count.device for st in states}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise RuntimeError("the mesh kernel runs on CUDA tensors of one device only (shards on "
                           "several cards are not written); scan_ref.scan_shards is the plain "
                           "version for the CPU")
    return next(iter(devs))


def pack(statics: list, states: list, pl: MeshPlan) -> dict:
    """Kernel-layout tensors for the shards, on their device: each shard's
    planes (``bufs["shards"][k]``, the fused scan's layout at width
    ``pl.ns``), the replicated tables, the mailboxes and the pointer
    table.  The state planes are fresh copies: the kernel updates them in
    place."""
    dev = _device(statics, states)
    shards = [fused_scan.pack_planes(s, st, pl.ns) for s, st in zip(statics, states)]
    tables = fused_scan.pack_tables(statics[0], states[0], pl.sw, pl.g4, pl.w4)
    for sh in shards:  # unpack_state and the refresh read a shard's dict alone
        sh["total"] = tables["total"]
    ptrs = torch.tensor([[sh[f].data_ptr() for f in SHARD_PLANES] for sh in shards],
                        dtype=torch.int64, device=dev)
    p = max(statics[0].p_real, 1)
    return {
        "shards": shards, "ptrs": ptrs, **tables,
        "chosen": torch.full((p,), -1, dtype=torch.int32, device=dev),
        "mbox_a": torch.zeros(2 * pl.grid * pl.msg_a, dtype=torch.int64, device=dev),
        "mbox_b": torch.zeros(2 * pl.grid * 2, dtype=torch.int64, device=dev),
        "ballots": torch.zeros(2 * pl.grid * pl.bw, dtype=torch.int32, device=dev),
        # the grid barrier: arrivals and generation, zero at first use and
        # left with no arrivals by every launch
        "barrier": torch.zeros(2, dtype=torch.int32, device=dev),
        "statics": statics,
    }


def params(bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor) -> MeshParams:
    """The kernel's argument block: the pods ``[start, start + count)``,
    the counter, stop flag and cursor in the control words ``ctl``."""
    s = bufs["statics"][0]
    d = fused_scan._dims(s)
    if ctl.shape != (fused_scan.CTL_WORDS,) or ctl.dtype != torch.int32:
        raise ValueError("ctl must be int32 [CTL_WORDS]")
    if start < 0 or count < 0 or start + count > s.p_real:
        raise ValueError(f"pods [{start}, {start + count}) outside the segment's {s.p_real}")
    word = ctl.element_size()
    base = ctl.data_ptr()
    return MeshParams(
        shards=bufs["ptrs"].data_ptr(), sig=bufs["sig"].data_ptr(),
        spread_inc_t=bufs["spread_inc_t"].data_ptr(), vol_limits=bufs["vol_limits"].data_ptr(),
        gids=bufs["gids"].data_ptr() + start * 4,
        pod_vol=bufs["pod_vol"].data_ptr() + start * pl.w4 * 4,
        total=bufs["total"].data_ptr(), chosen=bufs["chosen"].data_ptr() + start * 4,
        mbox_a=bufs["mbox_a"].data_ptr(), mbox_b=bufs["mbox_b"].data_ptr(),
        ballots=bufs["ballots"].data_ptr(), barrier=bufs["barrier"].data_ptr(),
        rr=base + fused_scan.CTL_RR * word, stop=base + fused_scan.CTL_STOP * word,
        cursor=base + fused_scan.CTL_CURSOR * word,
        shards_n=pl.shards, blocks=pl.blocks, threads=pl.threads, cols=pl.cols,
        n_local=pl.n_local, ns=pl.ns, g=d["g"], g4=pl.g4, t=d["t"], pv=d["pv"], v=d["v"],
        r=d["r"], w=d["w"], w4=pl.w4, k=d["k"], sw=pl.sw, p_real=count,
        num_zones=s.num_zones, use_terms=int(s.use_terms), use_vols=int(s.use_vols),
        use_ports=int(s.use_ports), msg_a=pl.msg_a, bw=pl.bw, smem_bytes=pl.smem_bytes,
        wt=(ctypes.c_int32 * len(WEIGHT_KEYS))(*(s.weights[k] for k in WEIGHT_KEYS)),
    )


def _check(bufs: dict, ctl: torch.Tensor) -> None:
    if ctl.device.type != "cuda" or bufs["chosen"].device != ctl.device:
        raise RuntimeError("the mesh kernel runs on CUDA tensors of one device only")


def query(bufs: dict, pl: MeshPlan, ctl: torch.Tensor) -> int:
    """How many blocks of the plan's shape the card holds at once."""
    _check(bufs, ctl)
    most = ctypes.c_int(0)
    err = load().mesh_scan_query(ctypes.byref(params(bufs, pl, 0, 0, ctl)), ctypes.byref(most))
    if err != 0:
        raise RuntimeError(f"mesh scan plan refused (error {err})")
    return most.value


def launch(bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor) -> None:
    """Launch the kernel on the current stream over packed ``bufs``: the
    pods ``[start, start + count)``, from and to the control words."""
    global launches
    _check(bufs, ctl)
    stream = torch.cuda.current_stream(ctl.device).cuda_stream
    err = load().mesh_scan_launch(ctypes.byref(params(bufs, pl, start, count, ctl)),
                                  ctypes.c_void_p(stream))
    if err == -4:
        raise RuntimeError(f"mesh scan: a grid of {pl.grid} blocks of {pl.threads} threads "
                           "cannot be resident on the card at once")
    if err != 0:
        raise RuntimeError(f"mesh scan launch failed (error {err})")
    launches += 1


def schedule(statics: list, states: list) -> tuple[np.ndarray, int]:
    """Pack, launch over the whole segment and wait: (chosen global column
    per pod, -1 = unschedulable; the final round-robin counter)."""
    pl = plan(statics)
    bufs = pack(statics, states, pl)
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=bufs["chosen"].device)
    ctl[fused_scan.CTL_RR] = states[0].round_robin
    launch(bufs, pl, 0, statics[0].p_real, ctl)
    out = torch.cat([bufs["chosen"][:statics[0].p_real], ctl[fused_scan.CTL_RR:fused_scan.CTL_RR + 1]])
    out = out.cpu().numpy()
    return out[:-1], int(out[-1])
