#!/usr/bin/env python3
"""The mesh kernel's per-phase clock64 split on one CUDA card, at
chip_smoke's main segment (5000 nodes x 20 000 ``mixed`` pods, seed 0) in
2 and 4 shards, in one launch and in several (the grouped form: mailboxes
across launches at system scope, here launches of one card on streams of
their own).

    python3 scripts/mesh_scan_phases.py [--shards 2,4] [--launches 1,2] [--out PATH]

Builds ``ops/csrc/mesh_scan.cu`` a second time with -DMESH_SCAN_PHASES
(thread 0 of block 0, rank 0 of shard 0, sums clock64() deltas per phase
over the pods), runs the segment through it and through the normal build
in turns (normal, phases, phases, normal: the stamps' own cost is the
difference), holds both pod for pod and in rr against the fused scan, and
prints one JSON object a measurement (ms, µs a pod, and the split in µs a
pod and in shares; the clock is launch 0's, so in the grouped form the
two mailbox phases hold the rounds across launches), the kernel's
registers and spills a thread for each plan (every launch of a grouped
mesh runs the same kernel), and the card line; ``--out PATH`` also writes
them to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ["prologue", "filter", "a_send", "a_cluster_wait", "a_mailbox", "totals",
          "b_send_prefetch", "b_cluster_wait", "b_mailbox_pick", "commit"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", default="2,4")
    ap.add_argument("--launches", default="1",
                    help="launches the shards are grouped into, each count that divides them")
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_scan_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from kubernetes_tpu_torch.ops import _build, fused_scan, mesh_scan
    from kubernetes_tpu_torch.parallel import make_mesh, place_state, place_static

    records = []

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    card = chip_smoke.card_line()
    t0 = time.time()
    work = os.path.join(ROOT, "kubernetes_tpu_torch", "ops", "_build", "phases")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libmesh_phases.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DMESH_SCAN_PHASES", "-o", so,
                    os.path.join(_build.CSRC, "mesh_scan.cu")], check=True, timeout=900)
    plib = ctypes.CDLL(so)
    plib.mesh_scan_launch.argtypes = [ctypes.POINTER(mesh_scan.MeshParams), ctypes.c_void_p]
    plib.mesh_scan_launch.restype = ctypes.c_int
    plib.mesh_scan_read_phases.argtypes = [ctypes.c_void_p]
    mesh_scan.load()
    emit({"what": "builds", "s": time.time() - t0})

    m, pods, pctx = chip_smoke.cluster(5000, 20000, "mixed", seed=0)
    _, s, st = chip_smoke.segment(m, pods, pctx, "cuda")
    want, rr_want = fused_scan.schedule(s, st)
    pods_n = int(s.p_real)

    cells = [(n, k) for n in (int(x) for x in args.shards.split(","))
             for k in (int(x) for x in args.launches.split(",")) if k <= n and n % k == 0]
    for n, k in cells:
        mesh = make_mesh(n, devices=["cuda"] * n, launches=k)
        statics, states = place_static(s, mesh), place_state(st, mesh)
        pl = mesh_scan.plan(statics, mesh.groups)

        def run(phased: bool) -> float:
            ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device="cuda")
            ctl[fused_scan.CTL_RR] = st.round_robin
            bufs = mesh_scan.pack(statics, states, pl, mesh.groups, ctl)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            mesh_scan.launch(bufs, pl, 0, pods_n, ctl, lib=plib if phased else None)
            b.record()
            b.synchronize()
            got = bufs["chosen"][:pods_n].cpu().numpy()
            rr = int(ctl[fused_scan.CTL_RR].item())
            if not (np.array_equal(got, want) and rr == rr_want):
                raise AssertionError(f"{n} shards in {k} launches ({'phases' if phased else 'normal'} "
                                     f"build) != fused_scan.cu")
            return a.elapsed_time(b)

        run(False)  # warm-up
        turns = [(k, run(k == "phases")) for k in ("normal", "phases", "phases", "normal")]
        out = (ctypes.c_ulonglong * len(PHASES))()
        if plib.mesh_scan_read_phases(out) != 0:
            raise RuntimeError("reading the phase clock failed")
        cyc = list(out)
        tot = sum(cyc)
        ms = turns[2][1]  # the last phases run, whose clock is read
        emit({"what": "phases", "shards": n, "launches": k, "cs": pl.cs, "cpt": pl.cpt,
              "threads": pl.threads, "cols": pl.cols, "turns": turns, **mesh_scan.attrs(pl),
              "normal_us_per_pod": min(t for k, t in turns if k == "normal") * 1e3 / pods_n,
              "phases_us_per_pod": ms * 1e3 / pods_n, "cycles_per_pod": tot / pods_n,
              "split_us_per_pod": {k: ms * 1e3 * c / tot / pods_n for k, c in zip(PHASES, cyc)},
              "share": {k: c / tot for k, c in zip(PHASES, cyc)}})

    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    emit({"what": "card", "card": card, "clocks_sm": clocks, "segment_pods": pods_n,
          "segment_nodes": int(s.n_pad)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
