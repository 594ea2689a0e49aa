#!/usr/bin/env python3
"""The tracing layer's cost on the daemon cell, in turns, on one CUDA card:
chip_smoke's 6a cell (5000 nodes, 20 000 ``mixed`` pods in 10 waves over
HTTP, a fresh apiserver and scheduler daemon pair a run) with the
scheduler's ``--trace --timeseries --telemetry-sink`` off and on, in the
order off, on, on, off (``--pairs N`` repeats it).

    python3 scripts/trace_cost_ab.py [--pairs 1] [--out PATH]

Prints one JSON object a run (pods/s, wall, create→bind p99, the daemon's
tensorize and batch-path seconds), then the medians of each side and
their ratio, and the card line; ``--out PATH`` also writes them to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_cell(traced: bool) -> dict:
    import chip_smoke
    from kubernetes_tpu_torch.workload import run_wire_churn

    with tempfile.TemporaryDirectory() as workdir:
        d = chip_smoke.Daemons(workdir, "on" if traced else "off")
        try:
            extra = (("--trace", "--timeseries", "--telemetry-sink",
                      os.path.join(workdir, "telemetry.ndjson")) if traced else ())
            d.start_scheduler(*extra)
            r = run_wire_churn(d.url, 5000, 20000, 10, "mixed", seed=0)
            st = d.stop_scheduler()
        finally:
            d.close()
    return {"traced": traced, "pods_per_s": r["pods_per_sec"], "wall_s": r["wall_s"],
            "create_to_bind_p99_ms": r["create_to_bind_ms"]["p99"], "drains": st["waves"],
            "tensorize_s": st["tensorize_s"], "batch_s": st["batch_s"],
            "kernel_ms": st["kernel_ms"], "bound": r["bound"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("trace_cost_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    records = []
    for _ in range(args.pairs):
        for traced in (False, True, True, False):
            rec = run_cell(traced)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    off = [r["pods_per_s"] for r in records if not r["traced"]]
    on = [r["pods_per_s"] for r in records if r["traced"]]
    summary = {"off_median_pods_per_s": statistics.median(off),
               "on_median_pods_per_s": statistics.median(on),
               "ratio_on_off": statistics.median(on) / statistics.median(off),
               "off_runs": off, "on_runs": on, "card": chip_smoke.card_line()}
    records.append(summary)
    print(json.dumps(summary), flush=True)
    print(summary["card"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
