"""Device-resident node-axis statics, kept across segments and waves.

Port of the JAX package's ``DeviceNodeCache``
(``kubernetes_tpu/ops/batch_kernel.py``) without its mesh parts.
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
        self.stats = {"reuses": 0, "col_updates": 0, "uploads": 0,
                      "dirty_cols": 0, "cols_total": 0}

    def _upload(self, host: tuple) -> tuple:
        return tuple(torch.from_numpy(h).to(self.device) for h in host)

    @staticmethod
    def _changed_cols(new: np.ndarray, old: np.ndarray) -> np.ndarray:
        diff = new != old
        if diff.ndim > 1:
            diff = diff.any(axis=tuple(range(1, diff.ndim)))
        return np.nonzero(diff)[0]

    def node_arrays(self, static) -> tuple:
        """The ``NODE_FIELDS`` tensors of ``static`` on the cache's device."""
        tok = static.node_token
        n = len(static.node_exists)
        self.stats["cols_total"] += n
        if tok is None:
            # bypassed (a compacted view): a full upload, counted as
            # all-dirty so the upload fraction reads 1.0
            self.stats["uploads"] += 1
            self.stats["dirty_cols"] += n
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
                if len(js) == 0:
                    arrays.append(arr)
                elif len(js) <= max(1, n // 8):
                    # a fresh tensor: callers may still hold the old one
                    idx = torch.from_numpy(js).to(self.device)
                    arrays.append(arr.index_copy(0, idx, torch.from_numpy(new_h[js]).to(self.device)))
                else:
                    arrays.append(torch.from_numpy(new_h).to(self.device))
            arrays = tuple(arrays)
            self.stats["col_updates"] += 1
            self.stats["dirty_cols"] += dirty
        else:
            arrays = self._upload(host)
            self.stats["uploads"] += 1
            self.stats["dirty_cols"] += n
        self._token, self._arrays, self._host = tok, arrays, host
        return arrays
