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

A mesh whose shards are in several launches (``groups``, from
``parallel.mesh.Mesh.groups``: a launch a card, or two on one card where
the mesh says so) packs one copy a launch, on that launch's card: its
shards' pointer table (every shard's planes, by global shard id), the
replicated tables, the chosen buffer, the control words (a copy of the
caller's, which is launch 0's), the epoch word, an inbox of every shard's
slot and the zone scratch, and a table of every launch's inboxes
(``peers``).  ``launch`` enqueues every launch at once, each on a stream
of its own (``mesh_scan_stream``: never one that PyTorch hands out, so no
two share one), behind an event of the caller's stream, and the caller's
stream waits on each; ``plan`` holds each card to the clusters of every
launch on it.  Launches on two cards need peer access between them
(``enable_peers``), and a pair without it raises: nothing stages the
messages through the host.

Every entry point that touches the card raises unless each shard's tensors
are on a CUDA device (a shard on the CPU, or a mesh of CPU and CUDA
shards, raises); a launch the card refuses (clusters it cannot hold at
once, a cooperative cluster launch the runtime does not take) raises too,
and so does a grouped launch that never met its partners (its waits trap,
and ``failures`` turns the error that follows into one that names the
mesh).  There is no fallback.  ``launches`` counts the kernel's launches,
a launch a group; ``launches_grouped`` those of grouped meshes alone.
"""

from __future__ import annotations

import ctypes
import contextlib
from collections import Counter
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

# kernel launches since the count was last reset (a launch a group); those
# of meshes in several launches again on their own
launches = 0
launches_grouped = 0

_PTR_FIELDS = ("shards", "sig", "spread_inc_t", "vol_limits", "gids", "pod_vol", "total",
               "chosen", "mbox_a", "mbox_b", "epoch", "zbuf", "rr", "stop", "cursor", "peers")
_INT_FIELDS = ("shards_n", "n_local", "ns", "cols", "cs", "threads", "cpt",
               "g", "g4", "t", "pv", "v", "r", "w", "w4", "k", "sw", "sws",
               "p_real", "num_zones", "use_terms", "use_vols", "use_ports", "smem_bytes",
               "gnz_off", "inbox_a_off", "inbox_b_off", "msg_a", "msg_b", "box_a", "box_b",
               "zone_off", "shard_lo", "shards_here", "groups", "group", "resident")


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
    launches: int = 1  # launches the shards are grouped into (mailboxes across them)

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
            k: int, zones: int, use_terms: bool, use_vols: bool, use_ports: bool,
            launches: int = 1) -> MeshPlan:
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
                    fixed_bytes=fixed, smem_bytes=off, offsets=offsets, plane_bytes=plane_bytes,
                    launches=launches)


def h100_clusters(cs: int, threads: int, cpt: int, smem_bytes: int) -> int:
    """``H100_CLUSTERS``: the card's answer at one block an SM, whatever the
    block's shape."""
    return H100_CLUSTERS[cs]


def plan_for(n_local: int, shards: int, r: int, g: int, t: int, pv: int, v: int, w: int, k: int,
             zones: int, use_terms: bool, use_vols: bool, use_ports: bool,
             clusters: Optional[Callable[[int, int, int, int], int]] = None,
             resident: Optional[int] = None, launches: int = 1) -> MeshPlan:
    """The plan at these shapes (``n_local`` columns a shard): the largest
    cluster of which a card holds ``resident`` at once (the most shards one
    card holds, over every launch on it; default all ``shards``), by
    ``clusters(cs, threads, cpt, smem_bytes)`` (default ``h100_clusters``).
    ``launches``: the groups the shards are launched in."""
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"the mesh kernel takes 1 to {MAX_SHARDS} shards, got {shards}")
    if not 1 <= launches <= shards:
        raise ValueError(f"{shards} shards cannot be {launches} launches")
    resident = shards if resident is None else resident
    fits = clusters or h100_clusters
    runs = max(1, -(-n_local // MIN_COLS))
    pl = None
    for cs in CLUSTER_SIZES:
        if cs > runs and cs > 1:
            continue
        pl = _layout(n_local, shards, cs, r, g, t, pv, v, w, k, zones, use_terms, use_vols,
                     use_ports, launches)
        if fits(cs, pl.threads, pl.cpt, pl.smem_bytes) >= resident:
            return pl
    return pl  # clusters of one block: a card that cannot hold them refuses the launch


def _groups(groups, shards: int) -> tuple:
    return (tuple(range(shards)),) if groups is None else tuple(tuple(g) for g in groups)


def plan(statics: list, groups=None, devices=None, clusters=None) -> MeshPlan:
    """The plan for a segment split into ``statics`` (one a shard) and
    launched in ``groups`` (default one launch), each card holding the
    clusters of every shard on it at once (``devices``: each shard's,
    default its tensors'); on a card, sized by what the card says it holds
    (``clusters=`` overrides)."""
    s = statics[0]
    fused_scan.check_shape(s)
    d = fused_scan._dims(s)
    devices = [x.device for x in statics] if devices is None else [torch.device(x) for x in devices]
    if clusters is None and devices[0].type == "cuda":
        clusters = card_clusters
    return plan_for(s.n_pad, len(statics), d["r"], d["g"], d["t"], d["pv"], d["v"], d["w"],
                    d["k"], d["zones"], use_terms=bool(s.use_terms), use_vols=bool(s.use_vols),
                    use_ports=bool(s.use_ports), clusters=clusters,
                    resident=max(Counter(str(x) for x in devices).values()),
                    launches=len(_groups(groups, len(statics))))


def exchanges(pl: MeshPlan) -> list:
    """The exchanges of one pod under plan ``pl``, each with the collective
    it stands for, where it runs and the words sent: between clusters (the
    cross-shard collectives) each shard's (a) message, summed, maxed and
    minned (the JAX seams' psum / pmax / pmin; past the register zones
    with its row of zone sums), and its (b) message, gathered by every
    block (the tie prefix's all_gather and ``_ax_first_true``); inside each
    cluster every block's two messages to its rank 0.  Shards in several
    launches push both messages (and past the register zones their row of
    zone sums) into every other launch's inbox too: the ``launches``
    scope, the words that cross launches a pod."""
    zone_words = 0 if pl.zones_at == "registers" else 2 * pl.num_zones
    far = pl.launches - 1
    return [
        {"name": "statistics", "collective": "all-reduce", "scope": "shards",
         "words": pl.shards * (pl.box_a + zone_words)},
        {"name": "best_and_ties", "collective": "all-gather", "scope": "shards",
         "words": pl.shards * pl.box_b},
        {"name": "cluster_statistics", "collective": "all-reduce", "scope": "cluster",
         "words": pl.grid * pl.msg_a},
        {"name": "cluster_best_and_ties", "collective": "all-gather", "scope": "cluster",
         "words": pl.grid * pl.msg_b},
    ] + ([
        {"name": "launch_statistics", "collective": "all-reduce", "scope": "launches",
         "words": pl.shards * far * (pl.box_a + zone_words)},
        {"name": "launch_best_and_ties", "collective": "all-gather", "scope": "launches",
         "words": pl.shards * far * pl.box_b},
    ] if far else [])


def load():
    """The kernel's library, built from ``csrc/mesh_scan.cu`` on the first
    call in a process."""
    lib = _build.load("mesh_scan")
    lib.mesh_scan_launch.argtypes = [ctypes.POINTER(MeshParams), ctypes.c_void_p]
    lib.mesh_scan_launch.restype = ctypes.c_int
    lib.mesh_scan_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.mesh_scan_clusters.restype = ctypes.c_int
    lib.mesh_scan_attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.mesh_scan_attrs.restype = ctypes.c_int
    lib.mesh_scan_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mesh_scan_enable_peer.restype = ctypes.c_int
    lib.mesh_scan_stream.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.mesh_scan_stream.restype = ctypes.c_int
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


def attrs(pl: MeshPlan) -> dict:
    """What the card says of the kernel plan ``pl`` launches (each launch of
    a grouped mesh launches the same one, the build for several launches):
    static shared memory, registers and local memory (spills) a thread."""
    out = (ctypes.c_int * 3)()
    err = load().mesh_scan_attrs(pl.cpt, int(pl.launches > 1), pl.smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"mesh scan: the card refused the attribute query (error {err})")
    return {"static_smem": out[0], "regs": out[1], "local_bytes": out[2]}


def clusters(pl: MeshPlan) -> int:
    """How many clusters of the plan's shape the card holds at once."""
    return card_clusters(pl.cs, pl.threads, pl.cpt, pl.smem_bytes)


def _device(statics: list, states: list) -> list:
    """Each shard's device: a CUDA device, the same for its statics and its
    state (shards on several cards are fine; a shard on the CPU, and so a
    mesh of CPU and CUDA shards, raises)."""
    devs = [s.device for s in statics]
    if any(d.type != "cuda" for d in devs) or any(
            st.pod_count.device != d for st, d in zip(states, devs)):
        raise RuntimeError("the mesh kernel runs on CUDA tensors only, each shard's statics and "
                           f"state on its card (got {[str(d) for d in devs]}); "
                           "scan_ref.scan_shards is the plain version for the CPU")
    return devs


# card pairs with peer access enabled, and each card's streams for the
# launches of a grouped mesh after its first (by card and launch index)
_peers: set = set()
_streams: dict = {}


def enable_peers(devices) -> None:
    """Peer access between every two of ``devices`` (once a pair, in the
    library); a pair without it raises."""
    idx = sorted({torch.device(d).index for d in devices})
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _peers:
                continue
            err = load().mesh_scan_enable_peer(a, b)
            if err == -5:
                raise RuntimeError(f"mesh scan: card {a} has no peer access to card {b}: the "
                                   "launches of a mesh on both cannot exchange (nothing stages "
                                   "their messages through the host)")
            if err != 0:
                raise RuntimeError(f"mesh scan: peer access from card {a} to {b} failed "
                                   f"(error {err})")
            _peers.add((a, b))


def _stream(device: torch.device, gi: int) -> torch.cuda.ExternalStream:
    """Launch ``gi``'s stream on ``device`` (gi >= 1), made by the library
    once and kept: never the caller's, nor another launch's."""
    key = (device.index, gi)
    if key not in _streams:
        out = ctypes.c_void_p(0)
        err = load().mesh_scan_stream(device.index, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"mesh scan: no stream on {device} (error {err})")
        _streams[key] = torch.cuda.ExternalStream(out.value, device=device)
    return _streams[key]


def pack(statics: list, states: list, pl: MeshPlan, groups=None,
         ctl: Optional[torch.Tensor] = None) -> dict:
    """Kernel-layout tensors for the shards, each on its card: each
    shard's planes (``bufs["shards"][k]``, the fused scan's layout at width
    ``pl.ns``, with its resource-score scratch ``res``) and, a launch of
    ``groups`` (default one), on that launch's card: the replicated
    tables, the chosen buffer, the mailboxes, the epoch word, the zone
    scratch, the pointer table of every shard's planes, every launch's
    inboxes (``peers``) and, after the first, a copy of the caller's
    control words ``ctl`` (needed with several launches, and the ones
    ``launch`` then takes; ``ctl_ptrs`` points at every launch's).  The returned
    dict is launch 0's, with every launch's in ``bufs["groups"]``.  The
    state planes are fresh copies: each launch writes them back."""
    devs = _device(statics, states)
    groups = _groups(groups, len(statics))
    if [k for grp in groups for k in grp] != list(range(len(statics))) or any(
            len({devs[k] for k in grp}) != 1 for grp in groups):
        raise ValueError(f"launches {groups} must cover the shards in order, each on one card")
    if len(groups) != pl.launches:
        raise ValueError(f"the plan is for {pl.launches} launches, not {len(groups)}")
    if len(groups) > 1:
        if ctl is None or ctl.device != devs[0]:
            raise ValueError("a mesh in several launches packs with launch 0's control words")
        enable_peers(devs)
    g = statics[0].static_ok.shape[0]
    shards = [fused_scan.pack_planes(s, st, pl.ns) for s, st in zip(statics, states)]
    for sh, dev in zip(shards, devs):
        sh["res"] = torch.empty((g, pl.ns), dtype=torch.int16, device=dev)
    table = [[sh[f].data_ptr() for f in SHARD_PLANES] for sh in shards]
    per_card = Counter(devs)
    p = max(statics[0].p_real, 1)
    out = []
    for gi, grp in enumerate(groups):
        dev = devs[grp[0]]
        tables = fused_scan.pack_tables(statics[grp[0]], states[grp[0]], pl.sw, pl.g4, pl.w4)
        for k in grp:  # unpack_state and the refresh read a shard's dict alone
            shards[k]["total"] = tables["total"]
        out.append({
            **tables, "statics": statics, "device": dev, "lo": grp[0], "n": len(grp),
            "resident": per_card[dev],
            "ptrs": torch.tensor(table, dtype=torch.int64, device=dev),
            "chosen": torch.full((p,), -1, dtype=torch.int32, device=dev),
            # each shard's slot by pod parity, and the epoch in the stamps' high half
            "mbox_a": torch.zeros(2 * pl.shards * pl.box_a, dtype=torch.int32, device=dev),
            "mbox_b": torch.zeros(2 * pl.shards * pl.box_b, dtype=torch.int32, device=dev),
            "epoch": torch.zeros(1, dtype=torch.int32, device=dev),
            "zbuf": torch.zeros(zbuf_words(pl.num_zones, pl.shards, pl.cs), dtype=torch.int64,
                                device=dev),
            "ctl": None if gi == 0 else ctl.to(dev, copy=True),
            "stream": None if gi == 0 else _stream(dev, gi),
        })
    if len(groups) > 1:
        boxes = [[gb["mbox_a"].data_ptr(), gb["mbox_b"].data_ptr(),
                  gb["zbuf"].data_ptr() if gb["zbuf"].numel() else 0] for gb in out]
        words = [ctl.data_ptr()] + [gb["ctl"].data_ptr() for gb in out[1:]]
        for gb in out:
            gb["peers"] = torch.tensor(boxes, dtype=torch.int64, device=gb["device"])
            # every launch's control words, for the refresh's shared count
            gb["ctl_ptrs"] = torch.tensor(words, dtype=torch.int64, device=gb["device"])
    bufs = out[0]
    bufs.update(shards=shards, groups=out)
    if len(groups) > 1:
        bufs["ctl0"] = ctl.data_ptr()
    return bufs


def params(bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor,
           gi: int = 0) -> MeshParams:
    """The kernel's argument block for launch ``gi`` of the packed ``bufs``:
    the pods ``[start, start + count)``, the counter, stop flag and cursor
    in that launch's control words ``ctl``."""
    gb = bufs["groups"][gi]
    s = gb["statics"][0]
    d = fused_scan._dims(s)
    if ctl.shape != (fused_scan.CTL_WORDS,) or ctl.dtype != torch.int32:
        raise ValueError("ctl must be int32 [CTL_WORDS]")
    if start < 0 or count < 0 or start + count > s.p_real:
        raise ValueError(f"pods [{start}, {start + count}) outside the segment's {s.p_real}")
    word = ctl.element_size()
    base = ctl.data_ptr()
    return MeshParams(
        shards=gb["ptrs"].data_ptr(), sig=gb["sig"].data_ptr(),
        spread_inc_t=gb["spread_inc_t"].data_ptr(), vol_limits=gb["vol_limits"].data_ptr(),
        gids=gb["gids"].data_ptr() + start * 4,
        pod_vol=gb["pod_vol"].data_ptr() + start * pl.w4 * 4,
        total=gb["total"].data_ptr(), chosen=gb["chosen"].data_ptr() + start * 4,
        mbox_a=gb["mbox_a"].data_ptr(), mbox_b=gb["mbox_b"].data_ptr(),
        epoch=gb["epoch"].data_ptr(),
        zbuf=gb["zbuf"].data_ptr() if gb["zbuf"].numel() else None,
        rr=base + fused_scan.CTL_RR * word, stop=base + fused_scan.CTL_STOP * word,
        cursor=base + fused_scan.CTL_CURSOR * word,
        peers=gb["peers"].data_ptr() if "peers" in gb else None,
        shards_n=pl.shards, n_local=pl.n_local, ns=pl.ns, cols=pl.cols, cs=pl.cs,
        threads=pl.threads, cpt=pl.cpt, g=d["g"], g4=pl.g4, t=d["t"], pv=d["pv"], v=d["v"],
        r=d["r"], w=d["w"], w4=pl.w4, k=d["k"], sw=pl.sw, sws=pl.sws, p_real=count,
        num_zones=s.num_zones, use_terms=int(s.use_terms), use_vols=int(s.use_vols),
        use_ports=int(s.use_ports), smem_bytes=pl.smem_bytes, gnz_off=pl.gnz_off,
        inbox_a_off=pl.inbox_a_off, inbox_b_off=pl.inbox_b_off, msg_a=pl.msg_a, msg_b=pl.msg_b,
        box_a=pl.box_a, box_b=pl.box_b, zone_off=pl.zone_off,
        shard_lo=gb["lo"], shards_here=gb["n"], groups=len(bufs["groups"]), group=gi,
        resident=gb["resident"],
        wt=(ctypes.c_int32 * len(WEIGHT_KEYS))(*(s.weights[k] for k in WEIGHT_KEYS)),
        off=(ctypes.c_int32 * len(fused_scan.PLANES))(
            *(-1 if pl.offsets[p] is None else pl.offsets[p] for p in fused_scan.PLANES)),
    )


def _check(bufs: dict, ctl: torch.Tensor) -> None:
    """The control words are launch 0's, on its card (each later launch's
    copy is on its own)."""
    if ctl.device.type != "cuda" or bufs["chosen"].device != ctl.device:
        raise RuntimeError("the mesh kernel runs on CUDA tensors only, launch 0's control "
                           "words on launch 0's card")
    if bufs.get("ctl0", ctl.data_ptr()) != ctl.data_ptr():
        raise ValueError("a mesh in several launches runs with the control words it was "
                         "packed with")


def _launch_one(lib, bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor,
                gi: int, stream) -> None:
    err = lib.mesh_scan_launch(ctypes.byref(params(bufs, pl, start, count, ctl, gi)),
                               ctypes.c_void_p(stream.cuda_stream))
    if err == -4:
        raise RuntimeError(f"mesh scan: {bufs['groups'][gi]['resident']} clusters of {pl.cs} "
                           f"blocks of {pl.threads} threads cannot be resident on the card at "
                           "once")
    if err != 0:
        raise RuntimeError(f"mesh scan launch failed (error {err}){_named(bufs, pl)}")


def _named(bufs: dict, pl: MeshPlan) -> str:
    groups = bufs["groups"]
    if len(groups) == 1:
        return ""
    return (f" in the mesh of {pl.shards} shards in {len(groups)} launches on "
            f"{[str(gb['device']) for gb in groups]}")


def launch(bufs: dict, pl: MeshPlan, start: int, count: int, ctl: torch.Tensor,
           after: Optional[Callable[[int], None]] = None, lib=None) -> None:
    """Launch the kernel over packed ``bufs``: the pods ``[start, start +
    count)``, from and to the control words (``ctl``: launch 0's), on the
    current stream.  A mesh in several launches enqueues each launch on a
    stream of its own (launch 0 on the current stream), every one behind
    an event of the current stream, before any of them can be waited on;
    ``after(gi)`` then enqueues what follows launch ``gi`` on its stream
    (the frontier loop's refreshes of its shards), and the current stream
    waits on every stream.  ``lib``: another build of the kernel's
    library (``scripts/mesh_scan_phases.py``'s phase clock)."""
    global launches, launches_grouped
    _check(bufs, ctl)
    lib = lib or load()
    groups = bufs["groups"]
    caller = torch.cuda.current_stream(ctl.device)
    if len(groups) == 1:
        _launch_one(lib, bufs, pl, start, count, ctl, 0, caller)
        launches += 1
        if after is not None:
            after(0)
        return
    streams = [caller] + [gb["stream"] for gb in groups[1:]]
    words = [ctl] + [gb["ctl"] for gb in groups[1:]]
    fork = torch.cuda.Event()
    fork.record(caller)
    for gi, (gb, st) in enumerate(zip(groups, streams)):
        with torch.cuda.device(gb["device"]):
            if gi:
                st.wait_event(fork)
            _launch_one(lib, bufs, pl, start, count, words[gi], gi, st)
    launches += len(groups)
    launches_grouped += len(groups)
    for gi, (gb, st) in enumerate(zip(groups, streams)):
        with torch.cuda.device(gb["device"]), torch.cuda.stream(st):
            if after is not None:
                after(gi)
            if gi:
                done = torch.cuda.Event()
                done.record(st)
                caller.wait_event(done)


@contextlib.contextmanager
def failures(bufs: dict, pl: MeshPlan):
    """Around a host read of a grouped mesh's results: a launch whose
    partners never ran ends at its waits' trap, and the CUDA error that
    the read then meets is raised again naming the mesh."""
    try:
        yield
    except RuntimeError as e:
        named = _named(bufs, pl)
        if not named or "CUDA" not in str(e):
            raise
        raise RuntimeError(f"mesh scan: a launch{named} failed on the card (a launch whose "
                           f"partners never ran ends at its waits' trap): {e}") from e


def schedule(statics: list, states: list, groups=None) -> tuple[np.ndarray, int]:
    """Pack, launch over the whole segment in ``groups`` (default one
    launch) and wait: (chosen global column per pod, -1 = unschedulable;
    the final round-robin counter)."""
    pl = plan(statics, groups)
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=_device(statics, states)[0])
    ctl[fused_scan.CTL_RR] = states[0].round_robin
    bufs = pack(statics, states, pl, groups, ctl)
    launch(bufs, pl, 0, statics[0].p_real, ctl)
    out = torch.cat([bufs["chosen"][:statics[0].p_real], ctl[fused_scan.CTL_RR:fused_scan.CTL_RR + 1]])
    with failures(bufs, pl):
        # device: sync — the whole segment's result and counter in one read
        out = out.cpu().numpy()
    return out[:-1], int(out[-1])
