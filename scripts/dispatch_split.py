#!/usr/bin/env python3
"""Split the batch backend's ``dispatch_s`` on one CUDA card into its parts,
at chip_smoke's main segment (5000 nodes x 20 000 ``mixed`` pods, seed 0):

- ``node_copy``: the four node-axis statics (``node_exists``, ``node_alloc``,
  ``node_alloc_pods``, ``node_zone``) host to device, the part a
  device-resident node cache saves;
- ``carry``: ``models.carry.from_reference`` of the whole segment (every
  static and state field host to device, the four above included);
- ``pack``: ``fused_scan.plan`` + ``fused_scan.pack`` (the kernel's layout,
  built on the card from the carried tensors).

    python3 scripts/dispatch_split.py [--reps 5]

Each part is timed on the host clock around work that ends in
``torch.cuda.synchronize()``, ``--reps`` times after one warm-up; prints
one JSON object with the medians and every rep, then the card line.
Needs no kernel build.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import HostBatchState, Tensorizer
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dispatch_split: no CUDA device", file=sys.stderr)
        return 2
    m, pods, pctx = chip_smoke.cluster(5000, 20000, "mixed", seed=0)
    w = BatchBackend(device="cuda")._config_supported()
    tz = Tensorizer()
    host = HostBatchState(m)
    static = tz.build_static(
        pods, m, pctx, least_requested_weight=w["least"],
        most_requested_weight=w["most"], balanced_weight=w["balanced"],
        spread_weight=w["spread"], node_affinity_weight=w["node_affinity"],
        taint_weight=w["taint"], prefer_avoid_weight=w["prefer_avoid"],
        image_weight=w["image"], interpod_weight=w["interpod"],
        mounted_disks=host.mounted_disks)
    init = tz.initial_state(static, m, pctx, pods, round_robin=0, host_state=host)
    node_fields = ("node_exists", "node_alloc", "node_alloc_pods", "node_zone")

    def node_copy():
        for f in node_fields:
            arr = getattr(static, f)
            dtype = np.bool_ if arr.dtype == np.bool_ else np.int32
            torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to("cuda")

    carried = {}

    def carry():
        carried["s"], carried["st"] = from_reference(vars(static), vars(init), "cuda")

    def pack():
        pl = fused_scan.plan(carried["s"])
        fused_scan.pack(carried["s"], carried["st"], pl)

    times = {}
    for name, fn in (("node_copy", node_copy), ("carry", carry), ("pack", pack)):
        fn()  # warm-up
        torch.cuda.synchronize()
        reps = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        times[name] = reps
    node_bytes = sum(getattr(static, f).nbytes for f in node_fields)
    out = {"cell": f"{len(m)}x{len(pods)} mixed", "n_pad": int(static.n_pad),
           "groups": int(static.static_ok.shape[0]), "node_axis_bytes": int(node_bytes),
           "median_s": {k: statistics.median(v) for k, v in times.items()},
           "reps_s": times}
    print(json.dumps(out))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
