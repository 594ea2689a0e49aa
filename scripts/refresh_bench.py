#!/usr/bin/env python3
"""Time the frontier refresh kernel against an earlier design of it, in turns
(old, new, new, old) in one process on one CUDA card, at chip_smoke's widths:

- ``pool_1024``: phase 10's pool (1024 nodes x 10 000 identical pods);
- ``main_5120``: the main segment (5000 nodes x 20 000 ``mixed`` pods);
- ``wide_20224``: the 20 000-node x 500-pod ``mixed`` segment;
- ``ports_600``: the widest segment of phase 3's 600-host-port batch;

then the frontier loop on the main segment with either refresh, in turns
(old, new, new, old), each arm against one launch of the whole segment.

    python3 scripts/refresh_bench.py --old-cu PATH [--launches 200] [--out PATH]

``--old-cu`` is an earlier ``frontier_refresh.cu`` whose launch takes the
13-pointer, 9-int ``RefreshParams`` of that design (the design before the
tiled one: ``git show d5d978c:kubernetes_tpu_torch/ops/csrc/frontier_refresh.cu``);
it is built with ``nvcc`` into a temporary directory and removed after.
Each arm is one ``chip_smoke.refresh_cell`` (the kernel held exactly
against ``scan_ref.refresh``; device ms over ``--launches`` launches, the
launch floor, the host's enqueue ms, the bound) or ``chip_smoke.loop_cell``
with that arm's launch function.  Prints one JSON object a width and one
for the loop, then the card line; ``--out PATH`` also writes them to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_OLD_PTRS = ("req", "cnt", "ports", "dm", "downer", "alloc", "alloc_pods", "exists",
             "static_ok", "sig", "still_ok", "alive", "ctl")
_OLD_INTS = ("ns", "g", "r", "t", "pv", "sw", "use_terms", "use_ports", "thresh")


class OldParams(ctypes.Structure):
    """``struct RefreshParams`` of the design before the tiled one."""

    _fields_ = ([(f, ctypes.c_void_p) for f in _OLD_PTRS]
                + [(f, ctypes.c_int32) for f in _OLD_INTS])


def old_launcher(src: str, workdir: str):
    """The earlier kernel built from ``src``, as a function with
    ``frontier_refresh.launch``'s signature.  It keeps its tile ticket in
    control word 4, which the current layout leaves unused."""
    import torch

    from kubernetes_tpu_torch.ops import _build, fused_scan

    so = os.path.join(workdir, "libfrontier_refresh_old.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.frontier_refresh_launch.argtypes = [ctypes.POINTER(OldParams), ctypes.c_void_p]
    lib.frontier_refresh_launch.restype = ctypes.c_int

    def launch(static, bufs, pl, still, alive, ctl, thresh):
        d = fused_scan._dims(static)
        prm = OldParams(*(bufs[f].data_ptr() for f in _OLD_PTRS[:10]), still.data_ptr(),
                        alive.data_ptr(), ctl.data_ptr(), pl.ns, d["g"], d["r"], d["t"],
                        d["pv"], pl.sw, int(static.use_terms), int(static.use_ports), int(thresh))
        err = lib.frontier_refresh_launch(
            ctypes.byref(prm), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"the old refresh launch failed (error {err})")

    return launch


def recorded_segments(m, pods, pctx) -> list:
    """The (static, init) field dicts of every kernel segment
    ``BatchBackend`` cuts the batch into, run on the CPU (the same cut as
    on the card)."""
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    seen = []

    class Recording(BatchBackend):
        def _dispatch(self, static, init):
            seen.append(tuple({k: v.copy() if hasattr(v, "copy") else v
                               for k, v in vars(x).items()} for x in (static, init)))
            return super()._dispatch(static, init)

    Recording(device="cpu").schedule_batch(pods, m, pctx)
    return seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-cu", required=True)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("refresh_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.ops import frontier_refresh

    card = chip_smoke.card_line()
    main_cluster = chip_smoke.cluster(5000, 20000, "mixed", seed=0)

    def cells():
        yield "pool_1024", chip_smoke.segment(*chip_smoke.pool_cluster(), "cuda")[1:]
        yield "main_5120", chip_smoke.segment(*main_cluster, "cuda")[1:]
        yield "wide_20224", chip_smoke.segment(*chip_smoke.cluster(20000, 500, "mixed", seed=6),
                                               "cuda")[1:]
        segs = recorded_segments(*chip_smoke.cluster(1000, 2000, "mixed", seed=1, host_ports=600))
        static, init = max(segs, key=lambda x: x[0]["g_ports"].shape[1])
        init.pop("still_ok", None)
        yield "ports_600", from_reference(static, init, "cuda")

    records = []
    with tempfile.TemporaryDirectory() as workdir:
        kernels = {"old": old_launcher(os.path.abspath(args.old_cu), workdir),
                   "new": frontier_refresh.launch}
        for name, (s, st) in cells():
            rec = {"cell": name, "old": [], "new": []}
            for k in ("old", "new", "new", "old"):  # in turns
                rec[k].append(chip_smoke.refresh_cell(f"{name} {k}", s, st, args.launches,
                                                      kernels[k]))
            rec["card"] = card
            records.append(rec)
            print(json.dumps(rec), flush=True)
        _, s, st = chip_smoke.segment(*main_cluster, "cuda", frontier=True)
        rec = {"cell": "loop_main_5120", "old": [], "new": []}
        for k in ("old", "new", "new", "old"):
            rec[k].append(chip_smoke.loop_cell(s, st, card, kernels[k]))
        rec["card"] = card
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
