"""The port's apiserver under node heartbeats: P client processes, each a
sequential client that does what a kubelet's heartbeat does (a GET and a
CAS PUT of a Node, ``guaranteed_update``) over ``RemoteStore`` for S
seconds.  Prints the requests a second and each update's p50, p99 and
worst seconds, and how many updates took longer than 0.9 s (a dropped SYN
costs a client a second), and the server's CPU seconds a request over
the run (user and system, from ``/proc``).

    python scripts/apiserver_load.py [--procs 4] [--seconds 8] [--nodes 500]
                                     [--conn-per-request] [--cas]
                                     [--profile FILE [--top N]]

It starts ``python -m kubernetes_tpu_torch.apiserver`` on a free port (the
admission chain on, as at its defaults) and stops it at the end.
``--conn-per-request`` closes each client's connection after every
request, the way the client worked before it kept connections alive.
``--cas`` sends the port's hollow kubelet heartbeat instead: one CAS PUT
of the Node as the client last wrote it, a GET only after a conflict.
``--profile FILE`` runs the same server under ``cProfile`` (which, from
Python 3.12, sees every thread), writes the stats to FILE and prints the
top N functions by their own time.  Runs on the CPU; the
apiserver runs no kernel.
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


def _client(url: str, names: list, seconds: float, per_request: bool, cas: bool,
            out) -> None:
    from kubernetes_tpu_torch.daemon import remote_clientset
    from kubernetes_tpu_torch.store.store import ConflictError

    cs = remote_clientset(url, timeout=60.0)
    store = cs.store
    lat = []
    requests = 0
    i = 0
    last = {}  # name -> the Node as this client last wrote it (--cas)

    def mutate(node):
        node.meta.labels["beat"] = str(i)
        return node

    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        name = names[i % len(names)]
        t = time.perf_counter()
        if cas:
            node = last.get(name)
            if node is None:
                node = cs.nodes.get(name)
                requests += 1
            try:
                last[name] = cs.nodes.update(mutate(node))
            except ConflictError:
                last.pop(name, None)
            requests += 1
        else:
            cs.nodes.guaranteed_update(name, mutate, "")
            requests += 2
        lat.append(time.perf_counter() - t)
        if per_request:
            store._drop_connection()
        i += 1
    out.put((requests, lat))


def _cpu_s(pid: int) -> float:
    """The CPU seconds (user and system) process ``pid`` has used so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _serve_profiled(port: int, path: str, top: int) -> None:
    """The apiserver as its entry point builds it at its defaults, under one
    profiler (Python 3.12's ``cProfile`` sees every thread); on SIGTERM the
    stats go to ``path`` and the top functions by own time to stdout."""
    import cProfile
    import pstats
    import signal
    import threading

    from kubernetes_tpu_torch.admission import AdmittedStore, default_chain
    from kubernetes_tpu_torch.apiserver.server import APIServer

    server = APIServer(AdmittedStore(default_chain()), port=port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    prof = cProfile.Profile()
    prof.enable()
    server.start()
    stop.wait()
    prof.disable()
    server.stop()
    prof.dump_stats(path)
    pstats.Stats(path).sort_stats("tottime").print_stats(top)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--conn-per-request", action="store_true")
    ap.add_argument("--cas", action="store_true")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--serve-profiled", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve_profiled:
        _serve_profiled(args.serve_profiled, args.profile, args.top)
        return 0

    from kubernetes_tpu_torch.daemon import remote_clientset
    from kubernetes_tpu_torch.workload import make_nodes

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    cmd = ([os.path.abspath(__file__), "--serve-profiled", str(port), "--profile",
            os.path.abspath(args.profile), "--top", str(args.top)] if args.profile
           else ["-m", "kubernetes_tpu_torch.apiserver", "--port", str(port)])
    server = subprocess.Popen([sys.executable, *cmd], cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": ROOT},
                              stdout=None if args.profile else subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
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
                                                  args.conn_per_request, args.cas, out))
                 for i in range(args.procs)]
        cpu0 = _cpu_s(server.pid)
        for p in procs:
            p.start()
        lat: list = []
        requests = 0
        for _ in procs:
            n, got = out.get(timeout=args.seconds + 120)
            requests += n
            lat += got
        for p in procs:
            p.join(timeout=30)
        cpu = _cpu_s(server.pid) - cpu0
    finally:
        server.terminate()
        server.wait(timeout=30)
    lat.sort()
    mode = "a connection a request" if args.conn_per_request else "kept alive"
    mix = "CAS PUT heartbeats" if args.cas else "GET + PUT heartbeats"
    print(f"{args.procs} clients, {mode}, {mix}: {requests / args.seconds:.1f} requests/s; "
          f"update p50 {lat[len(lat) // 2] * 1e3:.2f} ms p99 "
          f"{lat[int(len(lat) * 0.99)] * 1e3:.2f} ms max {lat[-1] * 1e3:.2f} ms; "
          f"updates over 0.9 s: {sum(1 for x in lat if x > 0.9)}; the server's CPU "
          f"{cpu * 1e6 / max(requests, 1):.1f} us a request ({cpu:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
