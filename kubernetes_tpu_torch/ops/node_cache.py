"""Device-resident node-axis statics, kept across segments and waves.

Port of the JAX package's ``DeviceNodeCache``
(``kubernetes_tpu/ops/batch_kernel.py``).
``BatchStatic.node_token`` (instance nonce, epoch, version), stamped by the
tensorizer's ``NodeStaticRows``, names the node-axis state the host arrays
were built from.  Same token: the previous device tensors are reused with
no host-to-device copy (every segment of a wave, and every wave against an
unchanged fleet).  A new token with the same nonce: each host array is
diffed against the cached host copy and only the changed columns are
written (``index_copy_``), unless more than an eighth of them changed (a
full upload).  The diff is of the arrays themselves, not the dirty-node
list, because one node's change can move other columns' values (a zone
relabel renumbers the zone ids).  A token of None (a compacted frontier
view) bypasses the cache and counts as a full upload.

The tensors it returns are shared: callers copy before they write
(``fused_scan.pack`` pads into fresh tensors, the frontier gathers into
fresh ones).

Under the node-axis mesh (``set_mesh``) an upload sends each shard's slice
to its shard's device (``_shard_put``), the mesh joins the cache token, and
the dirty and total columns are attributed to the shard that owns them
(``stats["shard_dirty_cols"]`` / ``["shard_cols_total"]``, a list a shard):
the scheduler's per-shard upload fractions.  The port's shards share one
device (the several-card placement is not written), so a shard's slice
lands in one tensor in shard order, the layout ``parallel.mesh
.place_static`` cuts again.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.carry import NODE_FIELDS


def _host(static, f: str) -> np.ndarray:
    arr = getattr(static, f)
    return np.ascontiguousarray(arr, dtype=np.bool_ if f == "node_exists" else np.int32)


class DeviceNodeCache:
    def __init__(self, device):
        self.device = torch.device(device)
        self._token = None
        self._arrays = None
        self._host = None  # host copies backing the device tensors
        self._mesh = None
        self._mesh_key = None
        self.stats = {"reuses": 0, "col_updates": 0, "uploads": 0,
                      "dirty_cols": 0, "cols_total": 0,
                      "shard_dirty_cols": [], "shard_cols_total": []}

    def set_mesh(self, mesh) -> None:
        """Bind (or clear, ``mesh=None``) the node-axis mesh uploads are
        split over.  The mesh joins the cache token, so sharded and
        single-device entries never alias; a different mesh misses and
        re-uploads.  (Re)sets the per-shard dirty and total column
        counters."""
        key, n_shards = (None, 0) if mesh is None else (mesh.key, mesh.size)
        if key != self._mesh_key:
            self._mesh, self._mesh_key = mesh, key
            self.stats["shard_dirty_cols"] = [0] * n_shards
            self.stats["shard_cols_total"] = [0] * n_shards

    def _note_shard_dirty(self, js, n: int) -> None:
        """Attribute dirty columns to the shard that receives their upload
        bytes (``js=None``: the whole axis)."""
        ns = len(self.stats["shard_dirty_cols"])
        if not ns or n % ns:
            return
        n_loc = n // ns
        counts = ([n_loc] * ns if js is None
                  else np.bincount(np.asarray(js, dtype=np.int64) // n_loc, minlength=ns))
        for k in range(ns):
            self.stats["shard_dirty_cols"][k] += int(counts[k])

    def _note_shard_total(self, n: int) -> None:
        ns = len(self.stats["shard_cols_total"])
        if not ns or n % ns:
            return
        for k in range(ns):
            self.stats["shard_cols_total"][k] += n // ns

    def _shard_put(self, host: np.ndarray) -> torch.Tensor:
        """Host to device, each shard's slice of the node axis to its
        shard's device; a width the shard count does not divide is a plain
        transfer.  Shards on several devices raise (not written)."""
        if self._mesh is None or len(host) % self._mesh.size:
            return torch.from_numpy(host).to(self.device)
        parts = np.split(host, self._mesh.size)
        return torch.cat([torch.from_numpy(np.ascontiguousarray(part)).to(dev)
                          for part, dev in zip(parts, self._mesh.devices)])

    def _upload(self, host: tuple) -> tuple:
        return tuple(self._shard_put(h) for h in host)

    def _token_for(self, static):
        tok = static.node_token
        if tok is not None and self._mesh_key is not None:
            # sharded placements never alias single-device entries
            tok = tuple(tok) + (self._mesh_key,)
        return tok

    @staticmethod
    def _changed_cols(new: np.ndarray, old: np.ndarray) -> np.ndarray:
        diff = new != old
        if diff.ndim > 1:
            diff = diff.any(axis=tuple(range(1, diff.ndim)))
        return np.nonzero(diff)[0]

    def node_arrays(self, static) -> tuple:
        """The ``NODE_FIELDS`` tensors of ``static`` on the cache's device."""
        tok = self._token_for(static)
        n = len(static.node_exists)
        self.stats["cols_total"] += n
        self._note_shard_total(n)
        if tok is None:
            # bypassed (a compacted view): a full upload, counted as
            # all-dirty so the upload fraction reads 1.0
            self.stats["uploads"] += 1
            self.stats["dirty_cols"] += n
            self._note_shard_dirty(None, n)
            return self._upload(tuple(_host(static, f) for f in NODE_FIELDS))
        if self._token == tok and self._arrays is not None:
            self.stats["reuses"] += 1
            return self._arrays
        host = tuple(_host(static, f) for f in NODE_FIELDS)
        incremental = (
            self._arrays is not None and self._token is not None and self._token[0] == tok[0]
            and all(h.shape == o.shape for h, o in zip(host, self._host)))
        if incremental:
            arrays, dirty = [], 0
            for new_h, old_h, arr in zip(host, self._host, self._arrays):
                js = self._changed_cols(new_h, old_h)
                dirty += len(js)
                self._note_shard_dirty(js, n)
                if len(js) == 0:
                    arrays.append(arr)
                elif len(js) <= max(1, n // 8):
                    # a fresh tensor: callers may still hold the old one
                    idx = torch.from_numpy(js).to(self.device)
                    arrays.append(arr.index_copy(0, idx, torch.from_numpy(new_h[js]).to(self.device)))
                else:
                    arrays.append(self._shard_put(new_h))
            arrays = tuple(arrays)
            self.stats["col_updates"] += 1
            self.stats["dirty_cols"] += dirty
        else:
            arrays = self._upload(host)
            self.stats["uploads"] += 1
            self.stats["dirty_cols"] += n
            self._note_shard_dirty(None, n)
        self._token, self._arrays, self._host = tok, arrays, host
        return arrays
