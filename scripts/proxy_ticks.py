"""A hollow fleet's tick with and without its kube-proxies under Endpoints
churn: one ``python -m kubernetes_tpu_torch kubelet --count N`` process
against the port's apiserver, first without ``--proxy`` and then with it,
while 10 Services' Endpoints (100 ready addresses each, on random nodes of
the fleet) are rewritten every 0.5 s for S seconds.  Prints, for each arm,
the ticks, the mean tick, the proxies' share of a tick and the longest
tick, read from the fleet's ``/metrics`` (``hollow_tick*``,
``hollow_proxy_tick_seconds_total``), and with the proxies their rule
counters (``hollow_proxy_*``).

    python scripts/proxy_ticks.py [--count 500] [--seconds 30]

Runs on the CPU; nothing here runs a kernel.
"""

from __future__ import annotations

import argparse
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metrics(port: int) -> dict:
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60).read().decode()
    return {line.split(" ")[0]: float(line.split(" ")[1]) for line in text.splitlines()
            if line.startswith("hollow_")}


def _arm(count: int, seconds: float, proxy: bool) -> None:
    from kubernetes_tpu_torch.api.cluster import (EndpointAddress, EndpointPort, Endpoints,
                                                  EndpointSubset)
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import Service, ServicePort
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore

    env = {**os.environ, "PYTHONPATH": ROOT}
    api_port, health_port = _free_port(), _free_port()
    url = f"http://127.0.0.1:{api_port}"
    procs = [subprocess.Popen([sys.executable, "-m", "kubernetes_tpu_torch.apiserver", "--port",
                               str(api_port)], env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)]
    try:
        cs = Clientset(RemoteStore(url, timeout=60.0))
        deadline = time.monotonic() + 60
        while True:
            try:
                urllib.request.urlopen(url + "/healthz", timeout=2).read()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError("the apiserver did not come up")
                time.sleep(0.2)
        for i in range(10):
            cs.services.create(Service(
                meta=ObjectMeta(name=f"s{i}", namespace="default"), selector={"a": str(i)},
                ports=[ServicePort(name="http", port=80, target_port=8080)],
                cluster_ip=f"10.0.0.{i + 10}"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch", "kubelet", "--apiserver", url, "--count",
             str(count), "--name", "f", "--healthz-port", str(health_port)]
            + (["--proxy"] if proxy else []), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
        deadline = time.monotonic() + 300
        while len(cs.nodes.list()[0]) < count:
            if time.monotonic() > deadline or procs[1].poll() is not None:
                raise RuntimeError("the fleet did not register")
            time.sleep(0.5)
        time.sleep(3)
        m0, t0, rng, rounds = _metrics(health_port), time.monotonic(), random.Random(0), 0
        while time.monotonic() - t0 < seconds:
            for i in range(10):
                addrs = [EndpointAddress(ip=f"10.8.{i}.{j}",
                                         node_name=f"f-{rng.randrange(count):05d}")
                         for j in range(100 - rounds % 5)]
                subsets = [EndpointSubset(addresses=addrs,
                                          ports=[EndpointPort(name="http", port=8080)])]
                if rounds == 0:
                    cs.endpoints.create(Endpoints(
                        meta=ObjectMeta(name=f"s{i}", namespace="default"), subsets=subsets))
                else:
                    cur = cs.endpoints.get(f"s{i}", "default")
                    cur.subsets = subsets
                    cs.endpoints.update(cur)
            rounds += 1
            time.sleep(0.5)
        m1 = _metrics(health_port)
        d = {k: v - m0.get(k, 0.0) for k, v in m1.items()}
        ticks = max(d["hollow_ticks_total"], 1)
        print(f"{count} kubelets, proxy {proxy}: {d['hollow_ticks_total']:.0f} ticks, mean tick "
              f"{d['hollow_tick_seconds_total'] / ticks:.3f} s, the proxies "
              f"{d.get('hollow_proxy_tick_seconds_total', 0.0) / ticks:.3f} s a tick, the "
              f"longest {m1['hollow_tick_seconds_max']:.3f} s; {rounds} rounds of Endpoints",
              flush=True)
        if proxy:
            print({k: v for k, v in m1.items() if k.startswith("hollow_proxy_")}, flush=True)
    finally:
        for proc in reversed(procs):
            proc.terminate()
            proc.wait(timeout=60)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=500)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    for proxy in (False, True):
        _arm(args.count, args.seconds, proxy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
