#!/usr/bin/env python3
"""Where a scheduler daemon's start-up goes, on a CUDA card's host: a bare
interpreter, ``import torch``, torch with a CUDA context, the daemon's
own imports, kubectl's imports, the kernels' build and load, the daemon's
import profile (``-X importtime``, the 25 largest), and two starts of the
daemon (``--leader-elect``, batch backend on ``cuda``) against an
apiserver holding 5000 nodes, from spawn to serving.  Each import is
timed in a fresh process.  Prints one JSON object.

    python3 scripts/daemon_startup.py
"""
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CHIP_SMOKE_RUN", f"startup-{os.getpid()}-{time.time_ns()}")
import chip_smoke  # noqa: E402


def timed(code: str) -> float:
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    return round(time.perf_counter() - t, 3)


def main() -> int:
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.workload import make_nodes

    print(chip_smoke.card_line(), flush=True)
    out = {
        "python_bare": [timed("pass") for _ in range(2)],
        "import_torch": [timed("import torch") for _ in range(3)],
        "torch_cuda_ctx": [timed("import torch; torch.empty(1, device='cuda'); "
                                 "torch.cuda.synchronize()") for _ in range(2)],
        "import_daemon_no_torch": [timed("import kubernetes_tpu_torch.scheduler.__main__")
                                   for _ in range(2)],
        "import_kubectl": [timed("import kubernetes_tpu_torch.cli.kubectl") for _ in range(3)],
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, ("fused_scan", "frontier_refresh")))
    out["build_s"] = round(time.perf_counter() - t0, 1)
    out["load_kernels"] = [timed("from kubernetes_tpu_torch.ops import fused_scan, "
                                 "frontier_refresh; fused_scan.load(); frontier_refresh.load()")
                           for _ in range(2)]
    imp = subprocess.run([sys.executable, "-X", "importtime", "-c",
                          "import kubernetes_tpu_torch.scheduler.__main__\n"
                          "from kubernetes_tpu_torch.ops.backend import BatchBackend"],
                         cwd=ROOT, capture_output=True, text=True)
    rows = []
    for ln in imp.stderr.splitlines():
        m = re.match(r"import time:\s+(\d+) \|\s+(\d+) \| (.*)", ln)
        if m:  # (cumulative s, self s, module)
            rows.append((int(m.group(2)) / 1e6, int(m.group(1)) / 1e6, m.group(3)))
    out["importtime_top"] = sorted(rows)[-25:]
    with tempfile.TemporaryDirectory() as wd:
        d = chip_smoke.Daemons(wd, "s")
        try:
            rs = RemoteStore(d.url, timeout=120.0)
            rs.create_many("Node", [n.to_dict() for n in
                                    make_nodes(5000, random.Random(7), "mixed")])
            for trial in range(2):
                t = time.perf_counter()
                d.start_scheduler()
                out[f"daemon_start_{trial}"] = round(time.perf_counter() - t, 3)
                d.stop_scheduler()
            out["stderr"] = d.stderr_tail()[-3000:]
        finally:
            d.close()
            chip_smoke.stop_own_processes()
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
