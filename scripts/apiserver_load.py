"""The port's apiserver under node heartbeats: P client processes, each a
sequential client that does what a kubelet's heartbeat does (a GET and a
CAS PUT of a Node, ``guaranteed_update``) over ``RemoteStore`` for S
seconds.  Prints the requests a second and each update's p50, p99 and
worst seconds, and how many updates took longer than 0.9 s (a dropped SYN
costs a client a second).

    python scripts/apiserver_load.py [--procs 4] [--seconds 8] [--nodes 500]
                                     [--conn-per-request]

It starts ``python -m kubernetes_tpu_torch.apiserver`` on a free port (the
admission chain on, as at its defaults) and stops it at the end.
``--conn-per-request`` closes each client's connection after every
request, the way the client worked before it kept connections alive.
Runs on the CPU; the apiserver runs no kernel.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _client(url: str, names: list, seconds: float, per_request: bool, out) -> None:
    from kubernetes_tpu_torch.daemon import remote_clientset

    cs = remote_clientset(url, timeout=60.0)
    store = cs.store
    lat = []
    i = 0

    def mutate(node):
        node.meta.labels["beat"] = str(i)
        return node

    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t = time.perf_counter()
        cs.nodes.guaranteed_update(names[i % len(names)], mutate, "")
        lat.append(time.perf_counter() - t)
        if per_request:
            store._drop_connection()
        i += 1
    out.put(lat)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--conn-per-request", action="store_true")
    args = ap.parse_args()

    from kubernetes_tpu_torch.daemon import remote_clientset
    from kubernetes_tpu_torch.workload import make_nodes

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    server = subprocess.Popen([sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
                               "--port", str(port)], cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": ROOT},
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(url + "/healthz", timeout=2).read()
                break
            except OSError:
                if time.monotonic() > deadline or server.poll() is not None:
                    raise RuntimeError("the apiserver did not come up")
                time.sleep(0.2)
        cs = remote_clientset(url, timeout=60.0)
        nodes = make_nodes(args.nodes, random.Random(7), "mixed")
        for n in nodes:
            cs.nodes.create(n)
        names = [n.meta.name for n in nodes]
        ctx = multiprocessing.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=_client, args=(url, names[i::args.procs], args.seconds,
                                                  args.conn_per_request, out))
                 for i in range(args.procs)]
        for p in procs:
            p.start()
        lat: list = []
        for _ in procs:
            lat += out.get(timeout=args.seconds + 120)
        for p in procs:
            p.join(timeout=30)
    finally:
        server.terminate()
        server.wait(timeout=30)
    lat.sort()
    mode = "a connection a request" if args.conn_per_request else "kept alive"
    print(f"{args.procs} clients, {mode}: {2 * len(lat) / args.seconds:.1f} requests/s; "
          f"update p50 {lat[len(lat) // 2] * 1e3:.2f} ms p99 "
          f"{lat[int(len(lat) * 0.99)] * 1e3:.2f} ms max {lat[-1] * 1e3:.2f} ms; "
          f"updates over 0.9 s: {sum(1 for x in lat if x > 0.9)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
