"""Host side of the sharded segment scan (``csrc/mesh_scan.cu``).

Port of the JAX package's sharded wave loop (``kubernetes_tpu/ops/
batch_kernel.py::_sharded_loop_runner``: the scan step under ``shard_map``
over a node-axis mesh, ``parallel/mesh.py``).  The shards come from
``parallel.mesh.place_static`` / ``place_state``: one ``ScanStatic`` and
``ScanState`` a shard, each its slice of the node axis.

``plan`` decides how the kernel covers them: each shard is a thread-block
cluster of ``cs`` blocks, each block owning ``cols`` contiguous columns of
its shard (a multiple of 16, so every row slice is a 16-byte bulk copy),
``threads`` threads of ``cpt`` columns each.  It takes the largest ``cs``
(of 16, 8, 4, 2, 1, and no more blocks than the shard has 32-column runs)
for which the card holds the ``S`` clusters at once: on a card it asks the
kernel (``cudaOccupancyMaxActiveClusters`` at the plan's threads and shared
memory), elsewhere it reads ``H100_CLUSTERS``, what the H100 80GB HBM3 said
(or pass ``clusters=``).  A shard too wide for its blocks grows the columns
a thread, not the blocks.  The planner alone owns the layout: the fused
scan's placement of the planes in each block's shared memory
(``fused_scan.PLANES`` order, until the budget is spent; the rest stay in
global memory behind the same view), the two exchanges' message sizes (in
the cluster ``msg_a`` / ``msg_b`` words a block, between clusters a shard's
mailbox slot of ``box_a`` / ``box_b`` words) and the zone statistics
(``zones_at``): up to ``REG_ZONES`` zones in registers and the messages,
more in a global scratch of shard rows with their totals in shared memory
while they fit ``ZONE_SMEM``, past that in a global row a block.  No
shape is refused.  ``exchanges`` reads that layout as the per-pod exchange
plan that ``parallel.mesh.assert_collective_structure`` checks.

``pack`` lays each shard's planes out as the fused scan does
(``fused_scan.pack_planes``, at the packed width ``ns = cs * cols``, which
the frontier refresh takes per shard too), the replicated tables once, the
per-shard pointer table the kernel reads, the mailboxes and the zone
scratch.  ``launch`` runs the pods ``[start, start + count)`` with the
frontier loop's control words (``fused_scan.CTL_*``) and writes the state
planes back; ``schedule`` packs, launches and waits.

Every entry point that touches the card raises unless the shards' tensors
are on one CUDA device (shards on several cards are not written); a launch
the card refuses (clusters it cannot hold at once, a cooperative cluster
launch the runtime does not take) raises too.  There is no fallback.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

from ..models.carry import WEIGHT_KEYS
from . import _build, fused_scan

MAX_SHARDS = 16
MAX_CLUSTER = 16
MAX_THREADS = 512
REG_ZONES = fused_scan.REG_ZONES  # zones whose sums the kernel keeps in registers
ZONE_SMEM = 32768   # bytes the zone totals may take in a block's shared memory
MIN_COLS = 32       # a block's columns at least: a narrow shard takes fewer blocks
CLUSTER_SIZES = (16, 8, 4, 2, 1)
HEAD_A = 4          # words of a shard's (a) mailbox slot before its message
HEAD_B = 8          # of a (b) slot before its blocks' tie counts
# the most clusters of each size that an H100 80GB HBM3 holds at once at
# one block an SM (the kernel's cudaOccupancyMaxActiveClusters answer at
# 160 and 320 threads with 120 and 200 KB of shared memory a block; more
# fit when blocks share an SM), the planner's figure where no card is at
# hand
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

# the per-shard planes of the pointer table, in the kernel's `enum ShardPlane` order
SHARD_PLANES = ("alloc", "alloc_pods", "exists", "zone", "static_ok", "aff_raw", "taint_raw",
                "score_raw", "interpod_raw", "node_domain", "dom_valid", "req", "nz", "cnt",
                "ports", "spread", "dm", "downer", "volf", "nk", "res")

# kernel launches since the count was last reset
launches = 0

_PTR_FIELDS = ("shards", "sig", "spread_inc_t", "vol_limits", "gids", "pod_vol", "total",
               "chosen", "mbox_a", "mbox_b", "epoch", "zbuf", "rr", "stop", "cursor")
_INT_FIELDS = ("shards_n", "n_local", "ns", "cols", "cs", "threads", "cpt",
               "g", "g4", "t", "pv", "v", "r", "w", "w4", "k", "sw", "sws",
               "p_real", "num_zones", "use_terms", "use_vols", "use_ports", "smem_bytes",
               "gnz_off", "inbox_a_off", "inbox_b_off", "msg_a", "msg_b", "box_a", "box_b",
               "zone_off")


class MeshParams(ctypes.Structure):
    """Mirror of ``struct MeshParams`` in ``csrc/mesh_scan.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS]
                + [("wt", ctypes.c_int32 * len(WEIGHT_KEYS)),
                   ("off", ctypes.c_int32 * len(fused_scan.PLANES))])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class MeshPlan:
    """How the kernel covers one segment's shards."""

    shards: int       # S: clusters
    cs: int           # blocks a cluster
    threads: int      # threads a block
    cpt: int          # columns a thread
    cols: int         # columns a block owns (a multiple of 16)
    n_local: int      # a shard's width: its column j is global column k * n_local + j
    ns: int           # packed width of a shard's planes, cs * cols (the refresh's too)
    num_zones: int
    sw: int           # ints in a signature row
    sws: int          # ints of it a pod buffer in shared memory holds
    g4: int
    w4: int
    msg_a: int        # words of a block's statistics message in its cluster
    msg_b: int        # words of a block's best-and-ties message in its cluster
    box_a: int        # words of a shard's (a) mailbox slot: the stamp, then msg_a
    box_b: int        # of its (b) slot: stamp, best, ties, each block's ties, the ballots
    gnz_off: int      # byte offsets in shared memory of the signatures' nonzero
    inbox_a_off: int  # requests and of rank 0's two inboxes
    inbox_b_off: int
    zone_off: int     # the zone totals in shared memory, or -1
    zones_at: str     # "registers", "shared" or "global" (see zones_at)
    fixed_bytes: int  # buffers, nonzero requests, inboxes and zone totals, before the planes
    smem_bytes: int   # dynamic shared memory a block
    offsets: dict     # plane -> byte offset in shared memory, None = global memory
    plane_bytes: dict

    @property
    def grid(self) -> int:
        return self.shards * self.cs

    @property
    def ents(self) -> int:
        """Tie ballots a block sends: one a warp and column round."""
        return self.cpt * self.threads // 32

    @property
    def shared(self) -> tuple:
        return tuple(k for k in fused_scan.PLANES if self.offsets[k] is not None)

    @property
    def global_(self) -> tuple:
        return tuple(k for k in fused_scan.PLANES if self.offsets[k] is None)


def zones_at(zones: int) -> str:
    """Where the kernel keeps the statistics of ``zones`` zones:
    ``registers`` (and the messages), else shard rows in global memory
    with the totals in ``shared`` memory while they fit ``ZONE_SMEM``, or in
    a ``global`` row a block."""
    if zones <= REG_ZONES:
        return "registers"
    return "shared" if 8 * zones <= ZONE_SMEM else "global"


def zbuf_words(zones: int, shards: int, cs: int) -> int:
    """int64 words of the zone scratch: the shards' rows of both pod
    parities [2, S, zones], then with global totals a row a block
    [S * cs, zones]; none while the zones fit in registers."""
    where = zones_at(zones)
    if where == "registers":
        return 0
    return 2 * shards * zones + (shards * cs * zones if where == "global" else 0)


def _layout(n_local: int, shards: int, cs: int, r: int, g: int, t: int, pv: int, v: int, w: int,
            k: int, zones: int, use_terms: bool, use_vols: bool, use_ports: bool) -> MeshPlan:
    """The plan with clusters of ``cs`` blocks: block size and placement."""
    cols = _round_up(max(1, -(-n_local // cs)), 16)
    cpt = next(c for c in (1, 2, 4, 8, fused_scan.MAX_CPT) if -(-cols // c) <= MAX_THREADS)
    threads = _round_up(-(-cols // cpt), 32)
    warps = threads // 32
    sw = _round_up(r + 4 + fused_scan.TERM_FIELDS * t + pv, 4)
    sws = min(sw, _round_up(r + 4 + fused_scan.TERM_FIELDS * t + fused_scan.MAX_PORTS, 4))
    g4 = _round_up(max(g, 1), 4)
    w4 = _round_up(max(w, 1), 4)
    terms = t if use_terms else 0
    rows = {"req": r, "nz": 2, "cnt": 1, "ports": pv if use_ports else 0, "dm": terms,
            "downer": terms, "volf": v if use_vols else 0, "nk": k if use_vols else 0,
            "spread": g, "res": g, "alloc": r, "alloc_pods": 1, "exists": 1, "zone": 1,
            "node_domain": terms, "dom_valid": terms}
    nbuf = fused_scan.NBUF
    plane_bytes = {"pod_rows": nbuf * fused_scan.POD_ROWS * cols * 4, "spread_inc": nbuf * g4 * 4}
    esz = {"volf": 1, "res": 2}
    plane_bytes.update({p: rows[p] * cols * esz.get(p, 4) for p in rows})
    where = zones_at(zones)
    msg_a = _round_up(10 + 2 * zones, 4) if where == "registers" else 12
    msg_b = _round_up(3 + cpt * warps, 4)
    gnz_off = nbuf * (sws + w4) * 4
    inbox_a_off = gnz_off + 2 * g4 * 4
    inbox_b_off = inbox_a_off + 2 * cs * msg_a * 4
    zone_off = inbox_b_off + 2 * cs * msg_b * 4
    fixed = _round_up(zone_off + (8 * zones if where == "shared" else 0), 16)
    budget = fused_scan.SMEM_LIMIT - fused_scan.STATIC_RESERVE
    off = fixed
    offsets, placing = {}, True
    for p in fused_scan.PLANES:
        placing = placing and off + plane_bytes[p] <= budget
        offsets[p] = off if placing else None
        off += plane_bytes[p] if placing else 0
    return MeshPlan(shards=shards, cs=cs, threads=threads, cpt=cpt, cols=cols, n_local=n_local,
                    ns=cs * cols, num_zones=zones, sw=sw, sws=sws, g4=g4, w4=w4,
                    msg_a=msg_a, msg_b=msg_b, box_a=HEAD_A + msg_a,
                    box_b=_round_up(HEAD_B + cs + cs * cpt * warps, 4),
                    gnz_off=gnz_off, inbox_a_off=inbox_a_off, inbox_b_off=inbox_b_off,
                    zone_off=zone_off if where == "shared" else -1, zones_at=where,
                    fixed_bytes=fixed, smem_bytes=off, offsets=offsets, plane_bytes=plane_bytes)


def h100_clusters(cs: int, threads: int, cpt: int, smem_bytes: int) -> int:
    """``H100_CLUSTERS``: the card's answer at one block an SM, whatever the
    block's shape."""
    return H100_CLUSTERS[cs]


def plan_for(n_local: int, shards: int, r: int, g: int, t: int, pv: int, v: int, w: int, k: int,
             zones: int, use_terms: bool, use_vols: bool, use_ports: bool,
             clusters: Optional[Callable[[int, int, int, int], int]] = None) -> MeshPlan:
    """The plan at these shapes (``n_local`` columns a shard): the largest
    cluster that the card holds ``shards`` of at once, by ``clusters(cs,
    threads, cpt, smem_bytes)`` (default ``h100_clusters``)."""
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"the mesh kernel takes 1 to {MAX_SHARDS} shards, got {shards}")
    fits = clusters or h100_clusters
    runs = max(1, -(-n_local // MIN_COLS))
    pl = None
    for cs in CLUSTER_SIZES:
        if cs > runs and cs > 1:
            continue
        pl = _layout(n_local, shards, cs, r, g, t, pv, v, w, k, zones, use_terms, use_vols,
                     use_ports)
        if fits(cs, pl.threads, pl.cpt, pl.smem_bytes) >= shards:
            return pl
    return pl  # clusters of one block: a card that cannot hold them refuses the launch


def plan(statics: list) -> MeshPlan:
    """The plan for a segment split into ``statics`` (one a shard); on a
    card, sized by what the card says it holds."""
    s = statics[0]
    fused_scan.check_shape(s)
    d = fused_scan._dims(s)
    return plan_for(s.n_pad, len(statics), d["r"], d["g"], d["t"], d["pv"], d["v"], d["w"],
                    d["k"], d["zones"], use_terms=bool(s.use_terms), use_vols=bool(s.use_vols),
                    use_ports=bool(s.use_ports),
                    clusters=card_clusters if s.device.type == "cuda" else None)


def exchanges(pl: MeshPlan) -> list:
    """The exchanges of one pod under plan ``pl``, each with the collective
    it stands for, where it runs and the words sent: between clusters (the
    cross-shard collectives) each shard's (a) message, summed, maxed and
    minned (the JAX seams' psum / pmax / pmin; past the register zones
    with its row of zone sums), and its (b) message, gathered by every
    block (the tie prefix's all_gather and ``_ax_first_true``); inside each
    cluster every block's two messages to its rank 0."""
    zone_words = 0 if pl.zones_at == "registers" else 2 * pl.num_zones
    return [
        {"name": "statistics", "collective": "all-reduce", "scope": "shards",
         "words": pl.shards * (pl.box_a + zone_words)},
        {"name": "best_and_ties", "collective": "all-gather", "scope": "shards",
         "words": pl.shards * pl.box_b},
        {"name": "cluster_statistics", "collective": "all-reduce", "scope": "cluster",
         "words": pl.grid * pl.msg_a},
        {"name": "cluster_best_and_ties", "collective": "all-gather", "scope": "cluster",
         "words": pl.grid * pl.msg_b},
    ]


def load():
    """The kernel's library, built from ``csrc/mesh_scan.cu`` on the first
    call in a process."""
    lib = _build.load("mesh_scan")
    lib.mesh_scan_launch.argtypes = [ctypes.POINTER(MeshParams), ctypes.c_void_p]
    lib.mesh_scan_launch.restype = ctypes.c_int
    lib.mesh_scan_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.mesh_scan_clusters.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def card_clusters(cs: int, threads: int, cpt: int, smem_bytes: int) -> int:
    """How many clusters of this shape the current card holds at once (the
    kernel's ``cudaOccupancyMaxActiveClusters``, no launch)."""
    out = ctypes.c_int(0)
    err = load().mesh_scan_clusters(cs, threads, cpt, smem_bytes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"mesh scan: the card refused the cluster query (error {err})")
    return out.value


def clusters(pl: MeshPlan) -> int:
    """How many clusters of the plan's shape the card holds at once."""
    return card_clusters(pl.cs, pl.threads, pl.cpt, pl.smem_bytes)


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
    ``pl.ns``, with its resource-score scratch ``res``), the replicated
    tables, the mailboxes, the zone scratch and the pointer table.  The
    state planes are fresh copies: each launch writes them back."""
    dev = _device(statics, states)
    g = statics[0].static_ok.shape[0]
    shards = [fused_scan.pack_planes(s, st, pl.ns) for s, st in zip(statics, states)]
    tables = fused_scan.pack_tables(statics[0], states[0], pl.sw, pl.g4, pl.w4)
    for sh in shards:  # unpack_state and the refresh read a shard's dict alone
        sh["total"] = tables["total"]
        sh["res"] = torch.empty((g, pl.ns), dtype=torch.int16, device=dev)
    ptrs = torch.tensor([[sh[f].data_ptr() for f in SHARD_PLANES] for sh in shards],
                        dtype=torch.int64, device=dev)
    p = max(statics[0].p_real, 1)
    return {
        "shards": shards, "ptrs": ptrs, **tables,
        "chosen": torch.full((p,), -1, dtype=torch.int32, device=dev),
        # each shard's slot by pod parity, and the epoch in the stamps' high half
        "mbox_a": torch.zeros(2 * pl.shards * pl.box_a, dtype=torch.int32, device=dev),
        "mbox_b": torch.zeros(2 * pl.shards * pl.box_b, dtype=torch.int32, device=dev),
        "epoch": torch.zeros(1, dtype=torch.int32, device=dev),
        "zbuf": torch.zeros(zbuf_words(pl.num_zones, pl.shards, pl.cs), dtype=torch.int64,
                            device=dev),
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
        epoch=bufs["epoch"].data_ptr(),
        zbuf=bufs["zbuf"].data_ptr() if bufs["zbuf"].numel() else None,
        rr=base + fused_scan.CTL_RR * word, stop=base + fused_scan.CTL_STOP * word,
        cursor=base + fused_scan.CTL_CURSOR * word,
        shards_n=pl.shards, n_local=pl.n_local, ns=pl.ns, cols=pl.cols, cs=pl.cs,
        threads=pl.threads, cpt=pl.cpt, g=d["g"], g4=pl.g4, t=d["t"], pv=d["pv"], v=d["v"],
        r=d["r"], w=d["w"], w4=pl.w4, k=d["k"], sw=pl.sw, sws=pl.sws, p_real=count,
        num_zones=s.num_zones, use_terms=int(s.use_terms), use_vols=int(s.use_vols),
        use_ports=int(s.use_ports), smem_bytes=pl.smem_bytes, gnz_off=pl.gnz_off,
        inbox_a_off=pl.inbox_a_off, inbox_b_off=pl.inbox_b_off, msg_a=pl.msg_a, msg_b=pl.msg_b,
        box_a=pl.box_a, box_b=pl.box_b, zone_off=pl.zone_off,
        wt=(ctypes.c_int32 * len(WEIGHT_KEYS))(*(s.weights[k] for k in WEIGHT_KEYS)),
        off=(ctypes.c_int32 * len(fused_scan.PLANES))(
            *(-1 if pl.offsets[p] is None else pl.offsets[p] for p in fused_scan.PLANES)),
    )


def _check(bufs: dict, ctl: torch.Tensor) -> None:
    if ctl.device.type != "cuda" or bufs["chosen"].device != ctl.device:
        raise RuntimeError("the mesh kernel runs on CUDA tensors of one device only")


def launch(bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor) -> None:
    """Launch the kernel on the current stream over packed ``bufs``: the
    pods ``[start, start + count)``, from and to the control words."""
    global launches
    _check(bufs, ctl)
    stream = torch.cuda.current_stream(ctl.device).cuda_stream
    err = load().mesh_scan_launch(ctypes.byref(params(bufs, pl, start, count, ctl)),
                                  ctypes.c_void_p(stream))
    if err == -4:
        raise RuntimeError(f"mesh scan: {pl.shards} clusters of {pl.cs} blocks of {pl.threads} "
                           "threads cannot be resident on the card at once")
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
    # device: sync — the whole segment's result and counter in one read
    out = out.cpu().numpy()
    return out[:-1], int(out[-1])
