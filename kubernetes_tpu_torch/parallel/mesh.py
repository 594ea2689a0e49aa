"""The node-axis mesh of the scan: the node axis split into equal shards.

Port of the JAX package's ``kubernetes_tpu/parallel/mesh.py``.  There the
wave loop runs under ``shard_map`` over a 1-D device mesh: every node-axis
plane of the statics and the carry is partitioned, the per-pod tables are
replicated, and every whole-axis reduce of the step is a cross-shard
collective (the ``_ax_*`` seams of ``ops/batch_kernel.py``).  Here a mesh is
an ordered list of shard places, each with its device; ``place_static`` /
``place_state`` give each shard its own tensors (its slice of every
node-axis plane and its copy of the replicated ones).  The plain sharded
step is ``ops.scan_ref.scan_shards``; on a card the shards' scan is one
launch of ``ops/csrc/mesh_scan.cu``, whose blocks exchange each pod's
statistics and best-and-ties messages through device memory.

Shard k owns the global columns ``[k * width, (k + 1) * width)`` of a node
axis of ``S * width`` columns (``models.snapshot.pad_segment_to_multiple``
pads a segment to a multiple of ``S``), so a chosen column comes back as a
global index and ties rotate in global column order, as on one device.

Placement: ``make_mesh(n, devices=[d] * n)`` puts all ``n`` shards on one
device, which is what the JAX package's tests do with virtual CPU
devices; a mesh of several cards is not written yet (the kernel raises
unless every shard is on one card).
"""

from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..models.carry import ScanState, ScanStatic
from ..ops import scan_ref
from ..ops.frontier import _STATE_NODE_AXES, _STATIC_NODE_AXES
from ..utils import tracing

NODE_AXIS = "nodes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the node axis: shard k lives on ``devices[k]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {NODE_AXIS: self.size}

    @property
    def key(self) -> tuple:
        """What identifies the mesh (the node cache's token part)."""
        return (tuple(self.shape.items()), tuple(str(d) for d in self.devices))


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the node axis: the first ``n_devices`` of ``devices``
    (default: every CUDA device).  ``devices=[d] * n`` places n shards on
    one device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


# -- partition rules -------------------------------------------------------------


def match_partition_rules(rules, names) -> dict:
    """First-match-wins regex rules -> the axis each name is split on (None:
    replicated): every name is matched against the patterns in order, and
    an unmatched name replicates.  A new node-axis plane needs only its
    entry in the axis tables of ``ops/frontier.py``."""
    out = {}
    for name in names:
        spec = None
        for pat, axis in rules:
            if re.fullmatch(pat, name):
                spec = axis
                break
        out[name] = spec
    return out


def _tensor_fields(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls)
                 if f.type in ("torch.Tensor", "Optional[torch.Tensor]"))


@lru_cache(maxsize=1)
def static_specs() -> dict:
    """The node axis of each ``ScanStatic`` tensor (None: replicated): node
    planes split, the per-signature, per-term and per-pod tables
    replicated."""
    rules = tuple((re.escape(f), ax) for f, ax in _STATIC_NODE_AXES.items())
    return match_partition_rules(rules, _tensor_fields(ScanStatic))


@lru_cache(maxsize=1)
def state_specs() -> dict:
    """The node axis of each ``ScanState`` tensor: every [.., N] plane split
    (``still_ok`` on its trailing axis), ``total_match`` replicated (the
    round-robin counter is an int, replicated too)."""
    rules = tuple((re.escape(f), ax) for f, ax in _STATE_NODE_AXES.items())
    rules += ((re.escape("still_ok"), 1),)
    return match_partition_rules(rules, _tensor_fields(ScanState))


def loop_in_specs() -> tuple:
    """The split of a mesh loop run's inputs (``ops.mesh_scan.launch``):
    the statics and the carry by their rules; the chosen buffer, the
    control words and the compaction threshold replicated."""
    return (static_specs(), state_specs(), None, None, None)


def loop_out_specs() -> tuple:
    """The split of a loop run's outputs: the carry stays split, the chosen
    buffer and the control words (cursor, stop flag, alive count,
    counter: functions of folded values, equal for every shard) are
    replicated, and the shards' alive masks concatenate to the global
    mask."""
    return (state_specs(), None, None, 0)


def _split(x: torch.Tensor, axis: Optional[int], k: int, s: int, device) -> torch.Tensor:
    if axis is None:
        return x.to(device)
    width = x.shape[axis] // s
    return x.narrow(axis, k * width, width).to(device).contiguous()


def _check_width(n: int, mesh: Mesh) -> int:
    s = mesh.size
    if n % s:
        raise ValueError(f"segment width {n} not divisible by {s} shards "
                         "(pad via snapshot.pad_segment_to_multiple)")
    return n // s


def place_static(static: ScanStatic, mesh: Mesh) -> list:
    """Shard k's ``ScanStatic``: its slice of every node-axis plane and a
    copy of every replicated table, on ``mesh.devices[k]``; its ``n_pad``
    is the shard's width."""
    width = _check_width(static.n_pad, mesh)
    specs = static_specs()
    return [dataclasses.replace(
        static, n_pad=width,
        **{f: _split(getattr(static, f), ax, k, mesh.size, dev) for f, ax in specs.items()})
        for k, dev in enumerate(mesh.devices)]


def place_state(state: ScanState, mesh: Mesh) -> list:
    """Shard k's ``ScanState`` (a ``still_ok`` of None passes through)."""
    _check_width(int(state.pod_count.shape[0]), mesh)
    specs = state_specs()
    return [dataclasses.replace(
        state, **{f: None if getattr(state, f) is None
                  else _split(getattr(state, f), ax, k, mesh.size, dev)
                  for f, ax in specs.items()})
        for k, dev in enumerate(mesh.devices)]


def _join(parts: list, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return parts[0]
    return torch.cat([p.to(parts[0].device) for p in parts], dim=axis)


def unplace_state(shards: list) -> ScanState:
    """The inverse of ``place_state``: the whole node axis, on shard 0's
    device (the frontier loop's compaction gathers over it)."""
    specs = state_specs()
    return dataclasses.replace(
        shards[0], **{f: None if getattr(shards[0], f) is None
                      else _join([getattr(s, f) for s in shards], ax)
                      for f, ax in specs.items()})


def mesh_dispatch_span(mesh: Mesh, width: int):
    """The ``mesh.dispatch`` span around a sharded loop's dispatch: shard
    count, mesh shape and the node width as its attributes."""
    tr = tracing.current()
    if tr is None:
        return tracing.NULL_SPAN
    return tr.span("mesh.dispatch", cat="mesh", shards=int(mesh.size),
                   mesh_shape=str(tuple(int(s) for s in mesh.shape.values())),
                   width=int(width))


def _on_card(mesh: Mesh) -> bool:
    return any(torch.device(d).type == "cuda" for d in mesh.devices)


def schedule_batch_sharded(static: ScanStatic, state: ScanState, mesh: Mesh
                           ) -> tuple[np.ndarray, int]:
    """The whole segment scanned with its node axis split over ``mesh``:
    one launch of the mesh kernel on a card, the plain sharded step
    elsewhere.  Returns (chosen global column per pod, -1 = unschedulable;
    the final round-robin counter).  The width must divide by the shard
    count."""
    statics, states = place_static(static, mesh), place_state(state, mesh)
    if _on_card(mesh):
        from ..ops import mesh_scan

        return mesh_scan.schedule(statics, states)
    chosen, finals = scan_ref.scan_shards(statics, states)
    return chosen.cpu().numpy(), finals[0].round_robin


def sharded_hlo(static: ScanStatic, mesh: Mesh) -> list:
    """The counterpart of the JAX package's compiled-program text: the
    cross-shard exchanges of one pod as the mesh kernel's planner lays
    them out (``ops.mesh_scan.exchanges``)."""
    from ..ops import mesh_scan

    statics = place_static(static, mesh)
    return mesh_scan.exchanges(mesh_scan.plan(statics))


def schedule_batch_sharded_verified(static: ScanStatic, state: ScanState, mesh: Mesh
                                    ) -> tuple[np.ndarray, int, dict]:
    """Plan once, assert the exchange structure over that plan, then run
    the segment: (chosen, rr, the exchanges counted by collective)."""
    counts = assert_collective_structure(sharded_hlo(static, mesh), static)
    chosen, rr = schedule_batch_sharded(static, state, mesh)
    return chosen, rr, counts


def assert_collective_structure(exchanges: list, static: ScanStatic) -> dict:
    """Fail if a pod's exchange carries node-axis state.

    ``exchanges`` is the per-pod list of (collective, words) the planner
    lays out: statistics folded as all-reduces, each block's best score,
    tie count and tie bits gathered by every block.  Forbidden: one that
    carries half a [G, N] or [T, N] plane or more, the sign of a layout
    that re-materializes the split state every pod.  Returns the counts
    by collective."""
    n_pad = int(static.n_pad)
    g = int(static.static_ok.shape[0])
    t = int(static.term_matches_sig.shape[0])
    limit = max(g, t, 2) * n_pad // 2
    counts = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0, "collective-permute": 0}
    offending = []
    for ex in exchanges:
        counts[ex["collective"]] += 1
        if ex["words"] >= limit:
            offending.append(f"{ex['name']}: {ex['collective']} of {ex['words']} words")
    assert not offending, (
        f"sharded scan all-gathers node-axis state (>{limit} words): " + "; ".join(offending[:3]))
    return counts
