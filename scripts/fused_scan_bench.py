#!/usr/bin/env python3
"""Time the fused scan's designs on one CUDA card, at chip_smoke's main
segment (5000 nodes x 20 000 ``mixed`` pods, seed 0).

    python3 scripts/fused_scan_bench.py [--old-root DIR] [--designs "1,16 2,16"]
                                        [--k "2 4 8"] [--sass] [--phases] [--out PATH]

- ``--designs``: plans of the current kernel, as "cpt,cs" pairs, each timed
  by CUDA events and its chosen nodes and round-robin counter held against
  the first design's (every design computes the same function);
- ``--old-root DIR``: DIR holds an earlier tree's port package renamed
  ``kubernetes_tpu_torch_old`` (for the previous design, commit 4ba1c4f: ``git archive
  4ba1c4f kubernetes_tpu_torch | tar -x -C DIR`` then rename).  Its kernel
  and the current one are timed in turns (old, new, new, old) in this
  process, and their outputs must agree exactly;
- ``--k``: the super-step builds (``PallasSuperSteps``: K pods a loop
  iteration, ``-DFUSED_SCAN_K=K``), each built, timed in turns with K = 1
  (1, K, K, 1, 1, K) and held against it exactly, with the registers and
  local memory (spills) a thread of the plan's instantiation at each K;
- ``--sass``: the SASS instructions (16 bytes each, ``cuobjdump -sass``)
  of each kernel instantiation in the K = 1 library and each ``--k`` one;
- ``--phases``: the per-phase clock64 split (thread 0 of cluster rank 0,
  summed over pods) of the current kernel built with -DFUSED_SCAN_PHASES
  (and of each ``--k`` build with it too) and, with ``--old-root``, of the
  old kernel with the same stamps inserted at its phase boundaries.

Prints one JSON object a measurement and the card line; ``--out PATH``
also writes them all to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OLD_STAMPS = [  # (anchor in the previous design's source, text inserted after it)
    ("if (p.use_vols && tid < W) s_vol[tid] = p.pod_vol[i * W + tid];\n        __syncthreads();\n",
     "        STAMP(0);\n"),
    ("        }\n        reduce_all(", None),  # handled below: STAMP(1) before, STAMP(2) after
    ("        const long long max_score = s_gmax;\n", "        STAMP(3);\n"),
    ("        if (rank == 0 && tid == 0) p.chosen[i] = ch;\n", "        STAMP(4);\n"),
]
OLD_PHASES = ["prologue", "filter_raw", "stats_reduce_barrier", "totals_best_barrier",
              "tie_pick_barrier", "commit"]
NEW_PHASES = ["prologue", "filter", "a_send", "a_wait", "a_fold", "totals",
              "b_send_prefetch", "b_wait", "b_tie_pick", "commit"]


def stamp_old(src: str) -> str:
    """The previous design's kernel with clock64 stamps at its six phase boundaries."""
    head = ("__device__ unsigned long long g_prof[8];\n"
            "#define STAMP(k) do { if (prof) { long long _t = clock64(); acc[k] += _t - t_last;"
            " t_last = _t; } } while (0)\n\n")
    kern = "template <int CPT>\n__global__ void __launch_bounds__(BLOCK, 1) fused_scan_kernel(const ScanParams p) {\n"
    assert src.count(kern) == 1
    src = src.replace(kern, head + kern + (
        "    const bool prof = cg::this_cluster().block_rank() == 0 && threadIdx.x == 0;\n"
        "    long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n    long long t_last = clock64();\n"))
    for anchor, add in OLD_STAMPS:
        assert src.count(anchor) == 1, anchor
        if add is None:
            src = src.replace(anchor, "        }\n        STAMP(1);\n        reduce_all(")
            tail = "p.num_zones);\n"
            k = src.index("reduce_all(cluster, red")
            j = src.index(tail, k) + len(tail)
            src = src[:j] + "        STAMP(2);\n" + src[j:]
        else:
            src = src.replace(anchor, anchor + add)
    end = "        __syncthreads();\n    }\n    if (rank == 0 && tid == 0) p.rr_out[0] = (int32_t)rr;"
    assert src.count(end) == 1
    src = src.replace(end, "        __syncthreads();\n        STAMP(5);\n    }\n"
                      "    if (prof) for (int k = 0; k < 6; ++k) g_prof[k] = acc[k];\n"
                      "    if (rank == 0 && tid == 0) p.rr_out[0] = (int32_t)rr;")
    launch = 'extern "C" int fused_scan_launch('
    return src.replace(launch, 'extern "C" int fused_scan_read_phases(unsigned long long* out) {\n'
                       "    return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, 6 * 8));\n}\n\n"
                       + launch)


def nvcc_lib(src_path: str, out_dir: str, tag: str, extra: list[str]) -> ctypes.CDLL:
    from kubernetes_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{tag}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o", so, src_path],
                   check=True, timeout=900)
    return ctypes.CDLL(so)


def sass_sizes(so: str) -> dict:
    """SASS instructions of each fused-scan instantiation in library
    ``so`` ("cpt<CPT> sh<SH> bz<BZ>"), counted in cuobjdump's listing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(r"fused_scan_kernelILi(\d+)ELb([01])ELb([01])E", line)
            name = f"cpt{m[1]} sh{m[2]} bz{m[3]}" if m else None
            if name:
                sizes[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[name] += 1
    return sizes


def events_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-root")
    ap.add_argument("--designs", default="")
    ap.add_argument("--k", default="")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_scan_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from kubernetes_tpu_torch.ops import _build, fused_scan

    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    card = chip_smoke.card_line()
    m, pods, pctx = chip_smoke.cluster(5000, 20000, "mixed", seed=0)
    _, s, st = chip_smoke.segment(m, pods, pctx, "cuda")
    pods_n = s.p_real
    fused_scan.load()

    def run_new(pl, lib=None):
        bufs = fused_scan.pack(s, st, pl)
        if lib is None:
            ms = events_ms(lambda: fused_scan.launch(s, st, bufs, pl))
        else:
            stream = torch.cuda.current_stream().cuda_stream
            prm = fused_scan.params(s, st, bufs, pl)

            def go():
                if lib.fused_scan_launch(ctypes.byref(prm), ctypes.c_void_p(stream)) != 0:
                    raise RuntimeError("phase-clock launch failed")
            ms = events_ms(go)
        got, rr = fused_scan.finalize(s, bufs)
        return ms, got, rr

    old = None
    if args.old_root:
        sys.path.insert(0, os.path.abspath(args.old_root))
        from kubernetes_tpu_torch_old.ops import fused_scan as old  # noqa: F811

        old.load()

    def run_old(lib=None):
        bufs = old.pack(s, st)
        if lib is None:
            ms = events_ms(lambda: old.launch(s, st, bufs))
        else:
            n, r = s.node_alloc.shape
            prm = old.ScanParams(
                **{f: bufs[f].data_ptr() for f in old._PTR_FIELDS},
                n=n, g=s.static_ok.shape[0], t=s.term_matches_sig.shape[0],
                pv=s.g_ports.shape[1], v=s.v_state, r=r, w=s.pod_vol_ids.shape[1],
                k=s.vol_limits.shape[0], p_real=s.p_real, num_zones=s.num_zones,
                rr0=st.round_robin, use_terms=int(s.use_terms), use_vols=int(s.use_vols),
                use_ports=int(s.use_ports),
                wt=(ctypes.c_int32 * 7)(*(s.weights[k] for k in old.WEIGHT_KEYS)))
            stream = torch.cuda.current_stream().cuda_stream

            def go():
                if lib.fused_scan_launch(ctypes.byref(prm), ctypes.c_void_p(stream)) != 0:
                    raise RuntimeError("phase-clock launch failed")
            ms = events_ms(go)
        got, rr = old.finalize(s, bufs)
        return ms, got, rr

    base = fused_scan.plan(s)
    run_new(base)  # warm-up
    ref_ms, ref_got, ref_rr = run_new(base)
    emit({"what": "default plan", "cs": base.cs, "cols": base.cols, "threads": base.threads,
          "cpt": base.cpt, "shared": list(base.shared), "ms": ref_ms,
          "us_per_pod": ref_ms * 1e3 / pods_n})

    for spec in filter(None, args.designs.split()):
        cpt, cs = (int(x) for x in spec.split(","))
        pl = fused_scan.plan(s, cpt=cpt, cs=cs)
        run_new(pl)
        times = []
        for _ in range(2):
            ms, got, rr = run_new(pl)
            if not (np.array_equal(got, ref_got) and rr == ref_rr):
                raise AssertionError(f"design {spec} disagrees with the default plan")
            times.append(ms)
        emit({"what": "design", "cpt": pl.cpt, "cs": pl.cs, "cols": pl.cols,
              "threads": pl.threads, "shared": list(pl.shared), "ms": times,
              "us_per_pod": min(times) * 1e3 / pods_n})

    if old is not None:
        run_old()  # warm-up
        turns = []
        for which in ("old", "new", "new", "old"):
            ms, got, rr = run_old() if which == "old" else run_new(base)
            if not (np.array_equal(got, ref_got) and rr == ref_rr):
                raise AssertionError(f"{which} kernel disagrees")
            turns.append({"kernel": which, "ms": ms})
        old_ms = [t["ms"] for t in turns if t["kernel"] == "old"]
        new_ms = [t["ms"] for t in turns if t["kernel"] == "new"]
        emit({"what": "old vs new in turns", "turns": turns, "old_ms": old_ms, "new_ms": new_ms,
              "old_us_per_pod": sum(old_ms) / 2 * 1e3 / pods_n,
              "new_us_per_pod": sum(new_ms) / 2 * 1e3 / pods_n,
              "speedup": sum(old_ms) / sum(new_ms), "outputs_equal": True})

    ks = [int(k) for k in args.k.split()]
    # every build this run needs, one nvcc each, started together
    work = os.path.join(ROOT, "kubernetes_tpu_torch", "ops", "_build", "phases")
    src = os.path.join(_build.CSRC, "fused_scan.cu")

    def timed(fn, *a):
        t = time.time()
        out = fn(*a)
        return out, time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(max(1, 2 * len(ks) + 1)) as pool:
        k_builds = {k: pool.submit(timed, fused_scan.build, k) for k in ks}
        phase_libs = {}
        if args.phases:
            phase_libs = {kk: pool.submit(nvcc_lib, src, work, f"k{kk}_phases", [
                "-DFUSED_SCAN_PHASES", *([f"-DFUSED_SCAN_K={kk}"] if kk > 1 else [])])
                for kk in [1, *ks]}
        k_builds = {k: f.result()[1] for k, f in k_builds.items()}
        phase_libs = {kk: f.result() for kk, f in phase_libs.items()}
    if ks or phase_libs:
        emit({"what": "builds", "s": time.time() - t0, "k_build_s": k_builds})
    for k in ks:
        build_s = k_builds[k]
        attrs = {kk: fused_scan.query(s, st, fused_scan.pack(s, st, base), base, k=kk)
                 for kk in (1, k)}
        turns = {1: [], k: []}
        for kk in (1, k, k, 1, 1, k):
            with chip_smoke.superstep(kk):
                run_new(base)  # warm-up
                ms, got, rr = run_new(base)
            if not (np.array_equal(got, ref_got) and rr == ref_rr):
                raise AssertionError(f"K = {kk} disagrees with the default plan")
            turns[kk].append(ms)
        emit({"what": "superstep in turns", "k": k, "build_s": build_s, "ms": turns[k],
              "k1_ms": turns[1], "ratio": sum(turns[k]) / sum(turns[1]),
              "us_per_pod": sum(turns[k]) / len(turns[k]) * 1e3 / pods_n,
              "regs": attrs[k]["regs"], "local_bytes": attrs[k]["local_bytes"],
              "k1_regs": attrs[1]["regs"], "k1_local_bytes": attrs[1]["local_bytes"],
              "outputs_equal": True})

    if args.sass:
        for k in [1, *ks]:
            so = _build.library_path("fused_scan", defines=fused_scan.defines(k))
            emit({"what": "sass instructions", "k": k, "by_instantiation": sass_sizes(so)})

    if args.phases:
        t0 = time.time()
        for lb in phase_libs.values():
            lb.fused_scan_read_phases.argtypes = [ctypes.c_void_p]
        kinds = [("new" if kk == 1 else f"K={kk}", lb, NEW_PHASES, lambda lb: run_new(base, lb))
                 for kk, lb in phase_libs.items()]
        if old is not None:
            old_src = os.path.join(os.path.dirname(old.__file__), "csrc", "fused_scan.cu")
            stamped = os.path.join(work, "old_phases.cu")
            with open(old_src) as f, open(stamped, "w") as g:
                g.write(stamp_old(f.read()))
            olib = nvcc_lib(stamped, work, "old_phases", [])
            olib.fused_scan_read_phases.argtypes = [ctypes.c_void_p]
            kinds.append(("old", olib, OLD_PHASES, lambda lb: run_old(lb)))
        emit({"what": "phase builds", "s": time.time() - t0})
        for name, lb, names, run in kinds:
            run(lb)  # warm-up
            ms, got, rr = run(lb)
            if not (np.array_equal(got, ref_got) and rr == ref_rr):
                raise AssertionError(f"{name} phase-clock build disagrees")
            out = (ctypes.c_ulonglong * len(names))()
            if lb.fused_scan_read_phases(out) != 0:
                raise RuntimeError("reading the phase clock failed")
            cyc = list(out)
            tot = sum(cyc)
            emit({"what": "phases", "kernel": name, "ms": ms, "us_per_pod": ms * 1e3 / pods_n,
                  "cycles_per_pod": tot / pods_n,
                  "split_us_per_pod": {k: ms * 1e3 * c / tot / pods_n for k, c in zip(names, cyc)},
                  "share": {k: c / tot for k, c in zip(names, cyc)}})

    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    emit({"what": "card", "card": card, "clocks_sm": clocks, "segment_pods": pods_n,
          "segment_nodes": s.n_pad})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
