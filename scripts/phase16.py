#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: ``cluster init`` and ``join``, two
hollow fleets (1002 nodes), kubectl (16d), a federation (16e) and
``cluster down``, with the phase's lines and exact checks.

    python3 scripts/phase16.py                  # on a CUDA card: builds both kernels first
    python3 scripts/phase16.py --cpu [--per-fleet 500 --replicas 50]

On a card it prints the card's name and power limit and the build's
seconds, then runs ``chip_smoke.lifecycle_phase``.  ``--cpu`` rehearses the
phase without a card: the scheduler runs with ``--device cpu`` and
the checks that want the kernels launched are left out.  Every process it
starts is stopped at the end.
"""
import argparse
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CHIP_SMOKE_RUN", f"phase16-{os.getpid()}-{time.time_ns()}")
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(prog="phase16")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--per-fleet", type=int, default=500)
    ap.add_argument("--replicas", type=int, default=50)
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        if args.cpu:
            with tempfile.TemporaryDirectory() as workdir:
                r = chip_smoke.lifecycle(workdir, per_fleet=args.per_fleet,
                                         replicas=args.replicas, init_args=("--device", "cpu"))
            chip_smoke.report_lifecycle(r, 0.0, time.perf_counter() - t0, device="cpu")
            return 0
        from kubernetes_tpu_torch.ops import _build, frontier_refresh, fused_scan

        print(chip_smoke.card_line(), flush=True)
        with ThreadPoolExecutor(2) as pool:  # one nvcc a source, started together
            list(pool.map(_build.build, ("fused_scan", "frontier_refresh")))
        fused_scan.load()
        frontier_refresh.load()
        print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        print(chip_smoke.lifecycle_phase(0.0), flush=True)
    finally:
        left = chip_smoke.stop_own_processes()
        print(f"left {left}; phase 16 wall {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
