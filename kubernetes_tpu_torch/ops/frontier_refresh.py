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

``launch`` raises unless its tensors are on CUDA; ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_scan import CTL_WORDS, Plan, _dims

# kernel launches since the count was last reset
launches = 0

_PTR_FIELDS = ("req", "cnt", "ports", "dm", "downer", "alloc", "alloc_pods", "exists",
               "static_ok", "sig", "still_ok", "alive", "ctl")
_INT_FIELDS = ("ns", "g", "r", "t", "pv", "sw", "use_terms", "use_ports", "thresh")


class RefreshParams(ctypes.Structure):
    """Mirror of ``struct RefreshParams`` in ``csrc/frontier_refresh.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS]
                + [(f, ctypes.c_int32) for f in _INT_FIELDS])


def load():
    """The kernel's library, built from ``csrc/frontier_refresh.cu`` on the
    first call in a process."""
    lib = _build.load("frontier_refresh")
    lib.frontier_refresh_launch.argtypes = [ctypes.POINTER(RefreshParams), ctypes.c_void_p]
    lib.frontier_refresh_launch.restype = ctypes.c_int
    return lib


def params(static, bufs: dict, pl: Plan, still_ok: torch.Tensor, alive: torch.Tensor,
           ctl: torch.Tensor, thresh: int) -> RefreshParams:
    """The kernel's argument block over the fused scan's packed ``bufs``."""
    d = _dims(static)
    if still_ok.shape != (d["g"], pl.ns) or still_ok.dtype != torch.bool:
        raise ValueError(f"still_ok must be bool [{d['g']}, {pl.ns}], got "
                         f"{still_ok.dtype} {tuple(still_ok.shape)}")
    if alive.shape != (pl.ns,) or ctl.shape != (CTL_WORDS,) or ctl.dtype != torch.int32:
        raise ValueError("alive must be [ns] and ctl int32 [CTL_WORDS]")
    ptrs = {f: bufs[f].data_ptr() for f in _PTR_FIELDS[:10]}
    return RefreshParams(
        **ptrs, still_ok=still_ok.data_ptr(), alive=alive.data_ptr(), ctl=ctl.data_ptr(),
        ns=pl.ns, g=d["g"], r=d["r"], t=d["t"], pv=d["pv"], sw=pl.sw,
        use_terms=int(static.use_terms), use_ports=int(static.use_ports), thresh=int(thresh))


def launch(static, bufs: dict, pl: Plan, still_ok: torch.Tensor, alive: torch.Tensor,
           ctl: torch.Tensor, thresh: int) -> None:
    """Launch the refresh on the current stream over the fused scan's
    packed ``bufs`` (plan ``pl``): ``still_ok`` [G, ns] bool in place,
    ``alive`` [ns] bool out, the count and stop flag into ``ctl``."""
    global launches
    for t in (bufs["req"], still_ok, alive, ctl):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise RuntimeError("the frontier refresh runs on contiguous CUDA tensors only; "
                               "scan_ref.refresh is the plain version for the CPU")
    stream = torch.cuda.current_stream(still_ok.device).cuda_stream
    err = load().frontier_refresh_launch(
        ctypes.byref(params(static, bufs, pl, still_ok, alive, ctl, thresh)),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"frontier refresh launch failed (error {err})")
    launches += 1
