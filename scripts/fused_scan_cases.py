#!/usr/bin/env python3
"""First check of a fused-scan build on one CUDA card: build it (with the
compiler's register and spill report), hold it against the plain scan on
every test case and on 1000- and 5000-node segments, time each, and time
the main segment (5000 nodes x 20 000 ``mixed`` pods) at 1 and 2 columns
a thread.

    python3 scripts/fused_scan_cases.py

One JSON object a case: the plan, the card's view of it, us a pod, and
whether chosen nodes and the round-robin counter equal ``scan_ref``'s.
Exits non-zero on the first mismatch.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_scan_cases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.ops import _build, fused_scan, scan_ref
    from tests import torch_port_cases as cases

    t0 = time.time()
    _build.build("fused_scan", verbose=True)
    print(json.dumps({"build_s": time.time() - t0, "card": chip_smoke.card_line()}), flush=True)

    def launch_ms(s, st, pl):
        bufs = fused_scan.pack(s, st, pl)
        return _events_ms(lambda: fused_scan.launch(s, st, bufs, pl))

    def check(tag, s, st, cpt=None):
        pl = fused_scan.plan(s, cpt=cpt)
        bufs = fused_scan.pack(s, st, pl)
        q = fused_scan.query(s, st, bufs, pl)
        fused_scan.launch(s, st, bufs, pl)
        got, rr = fused_scan.finalize(s, bufs)
        ms = launch_ms(s, st, pl)
        want, rr_want = scan_ref.scan(s, st)
        bad = np.nonzero(got != want.cpu().numpy())[0]
        ok = len(bad) == 0 and rr == rr_want
        print(json.dumps({"case": tag, "cs": pl.cs, "cols": pl.cols, "threads": pl.threads,
                          "cpt": pl.cpt, "smem": pl.smem_bytes, "global": pl.global_, **q,
                          "us_per_pod": ms * 1e3 / s.p_real, "ok": ok, "rr": [rr, rr_want],
                          "first_bad": int(bad[0]) if len(bad) else None}), flush=True)
        if not ok:
            raise AssertionError(f"{tag}: fused scan != scan_ref")

    for case in sorted(cases.CASES):
        static, init = cases.tensorize(cases.PORT, case)
        s, st = from_reference(vars(static), vars(init), "cuda")
        check(case, s, st)
    for wl in ("mixed", "plain"):
        _, s, st = chip_smoke.segment(*chip_smoke.cluster(1000, 2000, wl, seed=1), "cuda")
        check(f"{wl} 1000x2000", s, st)
    _, s, st = chip_smoke.segment(*chip_smoke.cluster(5000, 2000, "mixed", seed=3), "cuda")
    for cpt in (1, 2):
        check(f"mixed 5000x2000 cpt{cpt}", s, st, cpt=cpt)
    _, s, st = chip_smoke.segment(*chip_smoke.cluster(5000, 20000, "mixed", seed=0), "cuda")
    for cpt in (1, 2, 1, 2):
        pl = fused_scan.plan(s, cpt=cpt)
        print(json.dumps({"main_ms": launch_ms(s, st, pl), "cpt": pl.cpt,
                          "threads": pl.threads}), flush=True)
    return 0


def _events_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


if __name__ == "__main__":
    sys.exit(main())
