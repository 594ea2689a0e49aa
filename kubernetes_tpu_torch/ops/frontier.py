"""The frontier scan: one segment scanned in chunks of pods over a carried
state, with the node axis compacted to a power-of-two width whenever enough
columns have died for every signature.

Port of the JAX package's ``FrontierRun`` in its device-loop mode,
``gather_node_axis`` and ``_pow2_width`` (``kubernetes_tpu/ops/
batch_kernel.py``).  A column is dropped only when ``still_ok`` (the
monotone over-approximation of every future pod's feasibility, seeded by
``models.snapshot.frontier_seed``) is False for every signature, and every
normalization, tie set and feasible count of the scan ranges over feasible
columns only, so bindings and the round-robin counter are those of the
full-width scan.

On a card one loop run enqueues every remaining chunk at once: the fused
scan over the chunk's pods (``fused_scan.launch`` with the loop's control
words), then the refresh kernel (``frontier_refresh.launch``), which
tightens ``still_ok``, counts the alive columns and raises the stop flag on
the card when a compaction is worth taking; the launches behind a raised
flag are no-ops.  The host re-enters once a loop run (one read of the
control words): to compact (unpack the written-back planes, gather the
kept columns, re-plan and re-pack at the new width) and re-enter, or at the
end to read the whole segment's result.  Host syncs a segment: one a loop
run plus one, O(compactions + 1) whatever the chunk count.  On the CPU the
same loop runs the plain versions (``scan_ref.scan_range`` and
``scan_ref.refresh``) with the same exits, so its ``stats`` equal the JAX
package's.

``FrontierRun(..., mesh=)`` is the JAX package's sharded loop (its
``mesh=`` mode, ``parallel/mesh.py``): the segment is placed as the mesh's
shards, each chunk is one launch of the mesh kernel (``mesh_scan``; the
plain sharded step ``scan_ref.scan_shards`` on the CPU) and one refresh a
shard, whose counts add up over the whole width.  A compaction gathers
over the global column map and places the compacted segment again, so
widths stay powers of two of at least the shard count.  ``stats`` gains
``n_shards`` and ``shard_alive_frac`` (each shard's alive share of its
slice, a list a loop exit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.carry import ScanState, ScanStatic
from ..utils import tracing
from . import frontier_refresh, fused_scan, mesh_scan, scan_ref
from .fused_scan import CTL_ALIVE, CTL_CURSOR, CTL_RR, CTL_STOP, CTL_WORDS

# ScanStatic / ScanState fields carrying a node axis, with the axis position
# (the tensor twin of models.snapshot._STATIC_NODE_FIELDS / _INIT_NODE_FIELDS)
_STATIC_NODE_AXES = {
    "node_exists": 0, "node_alloc": 0, "node_alloc_pods": 0, "node_zone": 0,
    "static_ok": 1, "node_aff_raw": 1, "taint_intol_raw": 1,
    "static_score": 1, "interpod_raw": 1, "node_domain": 1, "dom_valid": 1,
}
_STATE_NODE_AXES = {
    "requested": 0, "nonzero_requested": 0, "pod_count": 0, "ports_used": 0,
    "spread_counts": 1, "dm": 1, "downer": 1, "vol_any": 1, "vol_ns": 1, "nk": 1,
}
# the JAX package's per-pod input bucket (batch_xs): a chunk is never
# longer than the segment's bucket
_POD_BUCKET = 512


def _pow2_width(n: int, min_width: int) -> int:
    w = max(min_width, 1)
    while w < n:
        w *= 2
    return w


def gather_node_axis(static: ScanStatic, state: ScanState, js: torch.Tensor,
                     width: int) -> tuple[ScanStatic, ScanState]:
    """Gather the kept columns ``js`` (ascending: node-axis order is the
    round-robin tie order) of every node-axis plane of the statics and the
    carry onto ``width`` columns.  Columns past ``len(js)`` are padding:
    their ``node_exists`` and ``still_ok`` are False, which makes every
    other plane's values there unreachable."""
    dev = static.device
    k = int(js.numel())
    idx = torch.zeros(width, dtype=torch.long, device=dev)
    idx[:k] = js
    pad = torch.arange(width, device=dev) < k
    s = {f: getattr(static, f).index_select(ax, idx) for f, ax in _STATIC_NODE_AXES.items()}
    s["node_exists"] = s["node_exists"] & pad
    st = {f: getattr(state, f).index_select(ax, idx) for f, ax in _STATE_NODE_AXES.items()}
    if state.still_ok is not None:
        st["still_ok"] = state.still_ok.index_select(1, idx) & pad[None, :]
    return (dataclasses.replace(static, n_pad=width, **s), dataclasses.replace(state, **st))


class FrontierRun:
    """One segment's frontier scan (the JAX package's device-loop mode).

    ``__init__`` starts the first loop run and returns (on a card the
    launches are in flight; ``device_busy`` polls them); ``finalize()``
    drives the rest and returns the chosen index per pod in the axis of
    the ``static`` it was given (-1 = unschedulable) and the final
    round-robin counter.  ``on_loop(run, width, start_chunk)`` is called
    before every loop run and ``on_compact(width, new_width, n_alive)``
    before every compaction: the backend's fault and trace seams.
    ``kernel_ms`` sums the loop runs' device time on a card."""

    def __init__(self, static: ScanStatic, state: ScanState, chunk_len: int = 512,
                 compact_frac: float = 0.5, min_width: int = 128, on_compact=None,
                 on_loop=None, mesh=None):
        if state.still_ok is None:
            raise ValueError("a frontier run needs state.still_ok (seed the InitialState "
                             "with models.snapshot.frontier_seed)")
        if chunk_len <= 0 or chunk_len & (chunk_len - 1):
            raise ValueError("the frontier loop needs a power-of-two chunk_len")
        self.static, self.state = static, state
        self.compact_frac = compact_frac
        self.min_width = min_width
        self.on_compact = on_compact
        self.on_loop = on_loop
        self.mesh = mesh
        self._p_real = static.p_real
        bucket = _POD_BUCKET
        while bucket < self._p_real:
            bucket *= 2
        self._chunk = min(chunk_len, bucket)
        self._n_chunks = -(-self._p_real // self._chunk)
        self._width = int(static.n_pad)
        # current column -> column of the static this run was given
        self._map = np.arange(self._width, dtype=np.int64)
        self.stats = {"chunks": 0, "compactions": 0, "alive_frac": [],
                      "widths": [self._width], "host_syncs": 0, "loop_runs": 0}
        device = static.device
        if mesh is not None:
            s = mesh.size
            if s < 2 or s & (s - 1):
                raise ValueError("mesh mode requires a power-of-two shard count >= 2")
            if self._width % s:
                raise ValueError(f"segment width {self._width} not divisible by {s} shards "
                                 "(pad via snapshot.pad_segment_to_multiple)")
            # compaction widths stay shard-divisible: every power of two at
            # least the power-of-two shard count divides by it
            self.min_width = max(self.min_width, s)
            device = mesh.devices[0]
            self.stats["n_shards"] = s
            self.stats["shard_alive_frac"] = []
        self._cuda = device.type == "cuda"
        self._chosen = torch.full((max(self._p_real, 1),), -1, dtype=torch.int32,
                                  device=device)
        self._c = 0  # chunks completed (host mirror, updated at syncs)
        self._regions: list = []  # (first pod of a loop run, its map)
        self._pending = None
        self.kernel_ms = 0.0
        # kernel launches on a card: fused-scan chunks and refreshes, those
        # behind a raised stop flag (no-ops) included
        self.launches = self.refresh_launches = 0
        if self._cuda:
            self._ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=device)
            self._ctl[CTL_RR] = state.round_robin
            self._pack()
        else:
            self._place()
        self._dispatch_loop()

    # -- the shards and the card's buffers ----------------------------------
    def _place(self) -> None:
        """The segment as its shards at the current width: one, or the
        mesh's (``parallel.mesh.place_static`` / ``place_state``)."""
        if self.mesh is None:
            self._statics, self._states = [self.static], [self.state]
            return
        from ..parallel import mesh as pmesh

        self._statics = pmesh.place_static(self.static, self.mesh)
        self._states = pmesh.place_state(self.state, self.mesh)

    def _pack(self) -> None:
        """The kernel's layout at the current width (the fused scan's, or
        the mesh kernel's per shard), the segment's chosen buffer in it,
        and each shard's refresh plane and mask."""
        self._place()
        if self.mesh is None:
            self._plan = fused_scan.plan(self.static)
            self._bufs = fused_scan.pack(self.static, self.state, self._plan)
            shard_bufs = [self._bufs]
        else:
            self._plan = mesh_scan.plan(self._statics)
            self._bufs = mesh_scan.pack(self._statics, self._states, self._plan)
            shard_bufs = self._bufs["shards"]
        self._bufs["chosen"] = self._chosen
        self._shard_bufs = shard_bufs
        g, ns, n = self.state.still_ok.shape[0], self._plan.ns, self._statics[0].n_pad
        self._still, self._alive = [], []
        for st in self._states:
            still = torch.zeros((g, ns), dtype=torch.bool, device=st.pod_count.device)
            still[:, :n] = st.still_ok
            self._still.append(still)
            self._alive.append(torch.zeros(ns, dtype=torch.bool, device=st.pod_count.device))

    # -- one loop run ------------------------------------------------------
    def _loop_thresh(self) -> int:
        """Fire iff ``n_alive <= thresh``: exactly the host rule, since
        ``_pow2_width`` can shrink a width iff n_alive <= width // 2 (and
        the floor allows it), and the fraction gate is ``n_alive <=
        floor(compact_frac * width)`` for an integer n_alive."""
        if self.min_width >= self._width:
            return -1  # the width floor: no smaller power of two exists
        return min(self._width // 2, int(self.compact_frac * self._width))

    def _dispatch_loop(self) -> None:
        if self.on_loop is not None:
            self.on_loop(self.stats["loop_runs"], self._width, self._c)
        tr = tracing.current()
        with (tr.span("frontier.loop", cat="frontier", index=self.stats["loop_runs"],
                      width=self._width, start_chunk=self._c, n_chunks=self._n_chunks)
              if tr is not None else tracing.NULL_SPAN):
            thresh = self._loop_thresh()
            if self._cuda:
                self._pending = self._enqueue(thresh)
            else:
                self._pending = self._run_plain(thresh)
            self._regions.append((self._c * self._chunk, self._map))
            self.stats["loop_runs"] += 1

    def _enqueue(self, thresh: int) -> tuple:
        """Every remaining chunk and its refresh, in stream order, with no
        host sync; returns the run's CUDA events."""
        # a first call builds: keep that out of the events
        (fused_scan if self.mesh is None else mesh_scan).load()
        frontier_refresh.load()
        # under a mesh the refreshes of every shard add into one count word:
        # the last tile of them all publishes the alive count and the stop flag
        shared = {} if self.mesh is None else {"tiles_total": len(self._statics) * (
            frontier_refresh.plan(self._statics[0], self._plan).tiles)}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in range(self._c, self._n_chunks):
            first = c * self._chunk
            count = min(self._chunk, self._p_real - first)
            if self.mesh is None:
                fused_scan.launch(self.static, self.state, self._bufs, self._plan, start=first,
                                  count=count, ctl=self._ctl)
            else:
                mesh_scan.launch(self._bufs, self._plan, start=first, count=count, ctl=self._ctl)
            for s, bufs, still, alive in zip(self._statics, self._shard_bufs, self._still,
                                             self._alive):
                frontier_refresh.launch(s, bufs, self._plan, still, alive, self._ctl, thresh,
                                        **shared)
                self.refresh_launches += 1
            self.launches += 1
        end.record()
        return start, end

    def _run_plain(self, thresh: int) -> tuple:
        """The loop run on the plain versions: chunks until the end or
        until a refresh wants a compaction."""
        states, c, want = self._states, self._c, False
        alive = [scan_ref.alive_of(st.still_ok, s.node_exists)[0]
                 for s, st in zip(self._statics, states)]
        n_alive = sum(int(a.sum()) for a in alive)
        while c < self._n_chunks and not want:
            first = c * self._chunk
            last = min(first + self._chunk, self._p_real)
            chosen, states = scan_ref.scan_shards(self._statics, states, first, last)
            self._chosen[first:last] = chosen
            states, alive, n_alive, want = scan_ref.refresh_shards(self._statics, states, thresh)
            c += 1
        self._states = states
        self.state = states[0] if self.mesh is None else self._unplace(states)
        return c, want, alive, n_alive

    @staticmethod
    def _unplace(states: list) -> ScanState:
        from ..parallel import mesh as pmesh

        return pmesh.unplace_state(states)

    @property
    def device_busy(self):
        """Polls whether the last loop run is still running (None on the
        CPU, where it has already run)."""
        if not self._cuda or self._pending is None:
            return None
        end = self._pending[1]
        return lambda: not end.query()

    def _sync_loop(self) -> tuple:
        """One blocking read a loop run: the exit cursor, the compaction
        flag, the alive count and the counter arrive together."""
        if self._cuda:
            start, end = self._pending
            ctl = self._ctl.cpu()  # waits for the loop run
            self.kernel_ms += start.elapsed_time(end)
            c_exit, want = int(ctl[CTL_CURSOR]), bool(ctl[CTL_STOP])
            n_alive = int(ctl[CTL_ALIVE])
            self._rr = int(ctl[CTL_RR])
            n = self._statics[0].n_pad
            alive = [a[:n] for a in self._alive]
        else:
            c_exit, want, alive, n_alive = self._pending
        self._pending = None
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += c_exit - self._c
        self._c = c_exit
        frac = round(n_alive / max(self._width, 1), 4)
        self.stats["alive_frac"].append(frac)
        attrs = dict(frac=frac, width=self._width, chunk=self._c)
        if self.mesh is not None:
            # the per-shard split: each shard's alive share of its slice
            # (a copy of masks the device has finished, no further stall)
            n_loc = self._width // self.mesh.size
            counts = torch.stack([a.sum() for a in alive]).cpu().tolist()
            attrs["shards"] = [round(int(k) / max(n_loc, 1), 4) for k in counts]
            self.stats["shard_alive_frac"].append(attrs["shards"])
        tr = tracing.current()
        if tr is not None:
            # one instant a loop exit (not a chunk): the pruning trajectory
            # at every host re-entry, the per-shard split as an attribute
            tr.instant("frontier.alive", **attrs)
        return want, torch.cat(alive), n_alive

    def _compact(self, alive: torch.Tensor, width_new: int) -> None:
        """Gather the kept columns over the whole axis (the global column
        map), then split the compacted segment into its shards again."""
        js = torch.nonzero(alive).flatten()
        if self._cuda:
            states = [fused_scan.unpack_state(s, bufs, self._rr, still) for s, bufs, still
                      in zip(self._statics, self._shard_bufs, self._still)]
            self.state = states[0] if self.mesh is None else self._unplace(states)
        js = js.to(self.static.device)
        self.static, self.state = gather_node_axis(self.static, self.state, js, width_new)
        self._map = self._map[js.cpu().numpy()]
        self._width = width_new
        self.stats["compactions"] += 1
        self.stats["widths"].append(width_new)
        if self._cuda:
            self._ctl[CTL_STOP] = 0
            self._pack()
        else:
            self._place()

    def finalize(self) -> tuple[np.ndarray, int]:
        while True:
            want, alive, n_alive = self._sync_loop()
            if self._c >= self._n_chunks:
                break
            if want:
                width_new = _pow2_width(n_alive, self.min_width)
                if width_new < self._width and n_alive <= self.compact_frac * self._width:
                    if self.on_compact is not None:
                        self.on_compact(self._width, width_new, n_alive)
                    self._compact(alive, width_new)
            self._dispatch_loop()
        # the whole segment's result in one read
        if self._cuda:
            out = torch.cat([self._chosen, self._ctl[CTL_RR:CTL_RR + 1]]).cpu().numpy()
            buf, rr = out[:-1], int(out[-1])
        else:
            buf, rr = self._chosen.cpu().numpy(), self.state.round_robin
        self.stats["host_syncs"] += 1
        chosen_full = np.empty(self._p_real, dtype=np.int64)
        bounds = [start for start, _ in self._regions] + [self._p_real]
        for (start, map_snap), end in zip(self._regions, bounds[1:]):
            end = min(end, self._p_real)
            if end <= start:
                continue
            if len(map_snap) == 0:
                # every column died before this loop run (a pool that filled
                # up with pods left): nothing was feasible, nothing to map.
                # The JAX package's map-back raises IndexError here and its
                # backend reruns the segment at full width.
                chosen_full[start:end] = -1
                continue
            part = buf[start:end].astype(np.int64)
            safe = np.clip(part, 0, len(map_snap) - 1)
            chosen_full[start:end] = np.where(part >= 0, map_snap[safe], -1)
        return chosen_full, rr
