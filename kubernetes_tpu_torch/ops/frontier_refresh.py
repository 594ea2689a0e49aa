"""Host side of the frontier loop's chunk-end refresh
(``csrc/frontier_refresh.cu``).

After each chunk of the fused scan the kernel ANDs the monotone feasibility
plane at the carried state into ``still_ok`` [G, ns], writes the alive mask
[ns] (a node some signature may still take), and publishes the alive count
and the compaction flag ``n_alive <= thresh`` in the loop's control words
(``fused_scan.CTL_*``).  It reads the fused scan's packed, written-back
planes, so it runs on what the next chunk will read.  Port of the JAX
package's ``monotone_plane_device`` and the refresh at the tail of
``_make_loop_run`` (``kubernetes_tpu/ops/batch_kernel.py``); the plain
version is ``scan_ref.refresh``, which the CPU path runs and the tests and
``chip_smoke.py`` hold the kernel against.

``plan`` owns the kernel's layout: a grid of column tiles (``cols``
columns) by signature groups (``gs`` signatures), a thread a signature and
``CPT`` neighbouring columns, ``kcap`` (every row a signature can name
staged with the tile where they fit one stage, else the named rows in
stages of ``kcap``), and the byte offset of every region of a block's
shared memory.  It prefers one group (a block holds every signature), then
``MIN_BLOCKS`` blocks (two an SM on an H100) with no idle signature slot
and the fewest bytes staged by all blocks together.  The kernel checks
only that what it was given fits.

``signature_table`` reduces each signature row, once a packing, to what
the kernel walks (its requests and the ids of the rows it names);
``tables`` keeps it and a byte copy of ``static_ok`` in ``bufs``.  Where
signatures split into several groups the alive bits cross them through a
zeroed scratch (a word per 32 columns, then a ticket per tile) that the
kernel clears again; ``launch`` keeps it in ``bufs["refresh_scratch"]``.

``launch`` raises unless its tensors are on CUDA; ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .fused_scan import CTL_WORDS, SMEM_LIMIT, Plan, _cols, _dims

# kernel launches since the count was last reset
launches = 0

CPT = 4              # columns a thread: a 32-bit word of still_ok and of static_ok bytes
COLS = (256, 128, 64, 32, 16)  # column tiles the kernel takes (MAX_COLS in the .cu); 16
# only where one group holds every signature (the alive words are 32 columns)
MAX_THREADS = 256    # threads a block (the kernel's launch bound)
MIN_BLOCKS = 264     # two blocks on each of an H100's 132 SMs
KCAP_MAX = 64        # named rows a block stages at a time
TILE_BITS = 14       # the count word: tiles done below, the alive count above
STATIC_RESERVE = 1024  # the kernel's static shared memory (alive words, two flags)
BUDGET = SMEM_LIMIT - STATIC_RESERVE

_PTR_FIELDS = ("req", "cnt", "ports", "dm", "downer", "alloc", "alloc_pods", "exists",
               "static_ok", "table", "still_ok", "alive", "ctl", "scratch", "ctls")
_INT_FIELDS = ("ns", "g", "r", "t", "pv", "tw", "use_terms", "use_ports", "thresh",
               "cols", "gs", "tiles", "tiles_total", "groups", "threads", "kcap", "smem_bytes",
               "nctl")
REGIONS = ("state", "table", "rows", "slot", "col")


class RefreshParams(ctypes.Structure):
    """Mirror of ``struct RefreshParams`` in ``csrc/frontier_refresh.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS]
                + [(f"off_{k}", ctypes.c_int32) for k in REGIONS])


@dataclass(frozen=True)
class RefreshPlan:
    """How the refresh kernel covers one [G, ns] plane."""

    ns: int
    g: int
    cols: int          # columns a tile (blockIdx.x)
    gs: int            # signatures a group (blockIdx.y)
    tiles: int
    groups: int
    threads: int       # gs * cols / CPT: a thread a signature and CPT columns
    kcap: int          # named rows a block stages at a time (0: the segment names none)
    named: int         # named-row ids: 2 T dm/downer rows (terms on) + PV port slots (ports on)
    tw: int            # ints in a signature table row
    smem_bytes: int    # dynamic shared memory a block
    offsets: dict      # region -> byte offset (REGIONS order)
    region_bytes: dict

    @property
    def blocks(self) -> int:
        return self.tiles * self.groups

    @property
    def scratch_words(self) -> int:
        """int32 words of the scratch: alive bits a 32 columns, a ticket a tile."""
        return -(-self.ns // 32) + self.tiles


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _layout(cols: int, gs: int, kcap: int, r: int, tw: int, named: int) -> tuple[dict, dict, int]:
    sizes = {"state": (2 * r + 3) * cols * 4, "table": gs * tw * 4, "rows": kcap * cols * 4,
             "slot": 2 * named * 4, "col": cols * 4}
    offsets, off = {}, 0
    for k in REGIONS:
        offsets[k] = off
        off = _round16(off + sizes[k])
    return offsets, sizes, off


@functools.lru_cache(maxsize=256)
def plan_for(ns: int, g: int, r: int, t: int, pv: int, use_terms: bool,
             use_ports: bool) -> RefreshPlan:
    """The refresh's plan at these shapes (``ns`` the fused scan's packed
    width).  Raises ValueError where no tiling's block fits shared memory
    (tens of thousands of host-port slots)."""
    if ns < 16 or ns % 16 or ns >= 1 << (32 - TILE_BITS):
        raise ValueError(f"the packed width must be a multiple of 16 below "
                         f"{1 << (32 - TILE_BITS)}, got {ns}")
    named = (2 * t if use_terms else 0) + (pv if use_ports else 0)
    tw = -(-(r + 1 + named) // 4) * 4
    best, best_key = None, None
    for cols in COLS:
        tiles = -(-ns // cols)
        seen = set()
        for gs in range(1, MAX_THREADS * CPT // cols + 1):
            threads = gs * cols // CPT
            groups = -(-g // gs)
            # whole warps, the smallest block that gives this many groups,
            # and a tile of whole alive words where groups meet in them
            if (threads % 32 or groups in seen or tiles >= 1 << TILE_BITS
                    or (groups > 1 and cols % 32)):
                continue
            seen.add(groups)
            # every row a signature can name in one stage with the tile, where
            # that fits; else stages of the rows the signatures do name
            kcap = min(named, KCAP_MAX)
            while True:
                offsets, sizes, total = _layout(cols, gs, kcap, r, tw, named)
                if total <= BUDGET or kcap <= 1:
                    break
                kcap = max(1, kcap // 2)
            if total > BUDGET:
                continue
            blocks = tiles * groups
            idle = groups * gs - g
            # what every block stages together: the column state and named
            # rows once a group, the table rows once a tile
            staged = blocks * (sizes["state"] + sizes["table"] + kcap * cols * 4)
            # one group (no cross-block alive words); then MIN_BLOCKS with no
            # idle signature slot and the fewest staged bytes, else the most
            # blocks
            key = ((groups == 1, True, -idle, -staged, threads, cols) if blocks >= MIN_BLOCKS
                   else (groups == 1, False, blocks, -idle, -staged, cols))
            if best_key is None or key > best_key:
                best_key = key
                best = RefreshPlan(ns=ns, g=g, cols=cols, gs=gs, tiles=tiles, groups=groups,
                                   threads=threads, kcap=kcap, named=named, tw=tw,
                                   smem_bytes=total,
                                   offsets=offsets, region_bytes=sizes)
    if best is None:
        raise ValueError(f"no refresh tiling fits {BUDGET} bytes of shared memory with "
                         f"{named} named rows")
    return best


def plan(static, pl: Plan) -> RefreshPlan:
    """The refresh's plan for a segment packed under the fused scan's plan
    ``pl``."""
    d = _dims(static)
    return plan_for(pl.ns, d["g"], d["r"], d["t"], d["pv"], bool(static.use_terms),
                    bool(static.use_ports))


def load():
    """The kernel's library, built from ``csrc/frontier_refresh.cu`` on the
    first call in a process."""
    lib = _build.load("frontier_refresh")
    lib.frontier_refresh_launch.argtypes = [ctypes.POINTER(RefreshParams), ctypes.c_void_p]
    lib.frontier_refresh_launch.restype = ctypes.c_int
    return lib


def signature_table(static, width: int) -> torch.Tensor:
    """[G, width] int32: each signature row reduced to what the refresh
    walks: its requests [R], the count n of the rows it names, then their
    ids ascending (dm rows of its own required anti-affinity terms, t;
    downer rows of the required anti-affinity terms that match it, T + t;
    its host-port slots, 2 T + q), zeros past them.  Row ids count terms
    only with ``use_terms`` and ports only with ``use_ports``."""
    g = static.g_request.shape[0]
    dev = static.g_request.device
    parts = []
    if static.use_terms:
        parts += [static.own_raa, (static.term_matches_sig & static.is_raa[:, None]).t()]
    if static.use_ports:
        parts.append(static.g_ports)
    named = torch.cat(parts, dim=1) if parts else torch.zeros((g, 0), dtype=torch.bool, device=dev)
    nr = named.shape[1]
    ids = torch.arange(nr, dtype=torch.int32, device=dev).expand_as(named)
    ids = torch.where(named, ids, nr).sort(dim=1).values  # named ids first, ascending
    table = torch.cat([static.g_request.to(torch.int32),
                       named.sum(dim=1, dtype=torch.int32)[:, None],
                       torch.where(ids < nr, ids, 0).to(torch.int32)], dim=1)
    return _cols(table, width)


def tables(static, bufs: dict, rp: RefreshPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The segment's signature table and its static_ok plane as bytes, built
    on its device at the first refresh of a packing and kept in ``bufs``
    (the statics do not change)."""
    t = bufs.get("refresh_table")
    if t is None or t.shape[1] != rp.tw:
        t = bufs["refresh_table"] = signature_table(static, rp.tw)
        bufs["refresh_static_ok"] = (bufs["static_ok"] != 0).to(torch.uint8)
    return t, bufs["refresh_static_ok"]


def scratch(bufs: dict, rp: RefreshPlan, device: torch.device) -> torch.Tensor:
    """The plan's zeroed scratch, kept in ``bufs`` across launches (the
    kernel leaves it zeroed)."""
    s = bufs.get("refresh_scratch")
    if s is None or s.numel() != rp.scratch_words or s.device != device:
        s = bufs["refresh_scratch"] = torch.zeros(rp.scratch_words, dtype=torch.int32,
                                                  device=device)
    return s


def params(static, bufs: dict, pl: Plan, still_ok: torch.Tensor, alive: torch.Tensor,
           ctl: torch.Tensor, thresh: int, tiles_total: int | None = None,
           ctls: torch.Tensor | None = None) -> RefreshParams:
    """The kernel's argument block over the fused scan's packed ``bufs``;
    ``tiles_total`` (default: this launch's tiles) counts the tiles of
    every launch that adds into the control words' count (a mesh refreshes
    each shard's slice in a launch of its own); ``ctls`` (a mesh in
    several launches: int64 pointers to every launch's control words,
    launch 0's first, on this launch's card) moves the count word to
    launch 0's and publishes into each."""
    d = _dims(static)
    if still_ok.shape != (d["g"], pl.ns) or still_ok.dtype != torch.bool:
        raise ValueError(f"still_ok must be bool [{d['g']}, {pl.ns}], got "
                         f"{still_ok.dtype} {tuple(still_ok.shape)}")
    if alive.shape != (pl.ns,) or ctl.shape != (CTL_WORDS,) or ctl.dtype != torch.int32:
        raise ValueError("alive must be [ns] and ctl int32 [CTL_WORDS]")
    rp = plan_for(pl.ns, d["g"], d["r"], d["t"], d["pv"], bool(static.use_terms),
                  bool(static.use_ports))
    if ctls is not None and (ctls.dtype != torch.int64 or ctls.device != ctl.device):
        raise ValueError("ctls must be int64 pointers on the launch's card")
    table, static_ok = tables(static, bufs, rp)
    return RefreshParams(
        *(bufs[f].data_ptr() for f in _PTR_FIELDS[:8]), static_ok.data_ptr(), table.data_ptr(),
        still_ok.data_ptr(), alive.data_ptr(), ctl.data_ptr(),
        scratch(bufs, rp, still_ok.device).data_ptr(),
        None if ctls is None else ctls.data_ptr(),
        pl.ns, d["g"], d["r"], d["t"], d["pv"], rp.tw, int(static.use_terms),
        int(static.use_ports), int(thresh), rp.cols, rp.gs, rp.tiles,
        rp.tiles if tiles_total is None else int(tiles_total), rp.groups, rp.threads,
        rp.kcap, rp.smem_bytes, 0 if ctls is None else int(ctls.numel()),
        *(rp.offsets[k] for k in REGIONS))


def launch(static, bufs: dict, pl: Plan, still_ok: torch.Tensor, alive: torch.Tensor,
           ctl: torch.Tensor, thresh: int, tiles_total: int | None = None,
           ctls: torch.Tensor | None = None) -> None:
    """Launch the refresh on the current stream over the fused scan's
    packed ``bufs`` (plan ``pl``; a mesh shard's packed planes and the
    mesh plan under the mesh): ``still_ok`` [G, ns] bool in place,
    ``alive`` [ns] bool out, the count and stop flag into ``ctl`` once the
    ``tiles_total`` tiles of this and the launches before it that share
    the count are done (``ctls``: into every launch's of a mesh in several
    launches, see ``params``)."""
    global launches
    for t in (bufs["req"], still_ok, alive, ctl):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise RuntimeError("the frontier refresh runs on contiguous CUDA tensors only; "
                               "scan_ref.refresh is the plain version for the CPU")
    stream = torch.cuda.current_stream(still_ok.device).cuda_stream
    err = load().frontier_refresh_launch(
        ctypes.byref(params(static, bufs, pl, still_ok, alive, ctl, thresh, tiles_total, ctls)),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"frontier refresh launch failed (error {err})")
    launches += 1
