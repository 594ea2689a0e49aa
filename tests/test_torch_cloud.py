"""Twins of ``tests/test_cloud.py`` on the port's ``cloud/``: the service
load-balancer, route and cloud-node controllers over ``FakeCloud``.

Each JAX test runs through both packages (``tests/torch_twin``): both pass
its assertions and leave equal stores.  Beside them, one seeded cluster
(nodes with and without podCIDRs and cloud instances, LoadBalancer and
ClusterIP Services) goes through each package's
``CloudControllerManager`` with changes in steps: the fake cloud's call
logs, balancers and routes and the stores must be equal.  Then the
port's ``cloud-controller-manager`` entry as a process against the port's
apiserver: an ingress IP published, routes for the podCIDRs, the fake
cloud's counts on ``/metrics``, and its stats line on SIGTERM; a bad
``--feature-gates`` exits 2."""

from __future__ import annotations

import importlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.torch_twin import cases, dump, twin

NAME = "test_cloud"
ROOTS = ("kubernetes_tpu", "kubernetes_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)


def _scenario(root: str, seed: int) -> dict:
    m = {k: importlib.import_module(f"{root}.{v}") for k, v in {
        "api": "api", "clientset": "client.clientset", "store": "store.store",
        "cloud": "cloud", "testutil": "testutil"}.items()}
    api, cloud_mod = m["api"], m["cloud"]
    rng = random.Random(seed)
    store = m["store"].Store()
    cs = m["clientset"].Clientset(store)
    cloud = cloud_mod.FakeCloud()
    for i in range(8):
        name = f"node-{i}"
        if rng.random() < 0.75:
            cloud.add_instance(cloud_mod.Instance(
                name=name, internal_ip=f"10.0.0.{i + 1}",
                external_ip=f"34.1.1.{i + 1}" if rng.random() < 0.5 else "",
                zone=rng.choice(["z-a", "z-b"]), region="r1"))
        node = m["testutil"].make_node(name)
        if rng.random() < 0.8:
            node.spec.pod_cidr = f"10.24.{i}.0/24"
        cs.nodes.create(node)
    for j in range(4):
        cs.services.create(api.Service(
            meta=api.ObjectMeta(name=f"svc-{j}"), selector={"app": f"a{j}"},
            ports=[api.ServicePort(port=80 + j)],
            type=rng.choice(["LoadBalancer", "LoadBalancer", "ClusterIP"])))
    mgr = cloud_mod.CloudControllerManager(cs, cloud)
    mgr.start(manual=True)
    out = {"steps": []}

    def unready(node):
        for c in node.status.conditions:
            if c.type == "Ready":
                c.status = "False"
        return node

    for step in range(5):
        mgr.reconcile_all()
        out["steps"].append({
            "balancers": {n: (b.ingress_ip, b.ports, b.nodes) for n, b in cloud.balancers.items()},
            "routes": sorted((r.name, r.target_node, r.dest_cidr) for r in cloud.list_routes()),
            "monitor": mgr.controllers["cloud-node"].monitor()})
        i = rng.randrange(8)
        change = rng.choice(["unready", "delete", "recidr", "gone", "svc"])
        try:
            if change == "unready":
                cs.nodes.guaranteed_update(f"node-{i}", unready, "")
            elif change == "delete":
                cs.nodes.delete(f"node-{i}")
            elif change == "recidr":
                def recidr(node, i=i, step=step):
                    node.spec.pod_cidr = f"10.99.{step}.0/24"
                    return node

                cs.nodes.guaranteed_update(f"node-{i}", recidr, "")
            elif change == "gone":
                cloud.remove_instance(f"node-{i}")
            else:
                def to_lb(svc):
                    svc.type = "ClusterIP" if svc.type == "LoadBalancer" else "LoadBalancer"
                    return svc

                cs.services.guaranteed_update(f"svc-{rng.randrange(4)}", to_lb)
        except m["store"].NotFoundError:
            pass
        out["steps"][-1]["change"] = (change, i)
        mgr.informers.pump_all()
    out["calls"] = list(cloud.calls)
    out["store"] = dump(store)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cloud_calls_and_state_equal_the_jax_package(seed):
    jax_out, port_out = (_scenario(r, seed) for r in ROOTS)
    assert port_out == jax_out
    assert any(c[0] == "ensure" for c in port_out["calls"])
    assert any(c[0] == "create-route" for c in port_out["calls"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _cloud_metrics(port: int) -> dict:
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    return {line.split(" ", 1)[0]: float(line.split(" ", 1)[1])
            for line in text.splitlines() if line.startswith("cloud_")}


@pytest.mark.timeout(120)
def test_cloud_controller_manager_entry_over_the_wire(tmp_path):
    from kubernetes_tpu_torch.api import ObjectMeta, Service, ServicePort
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.testutil import make_node

    ap, hp = _free_port(), _free_port()
    url = f"http://127.0.0.1:{ap}"
    procs = []

    def spawn(name, *args):
        proc = subprocess.Popen([sys.executable, "-m", *args], env=_env(), cwd=tmp_path,
                                stdout=open(tmp_path / f"{name}.out", "w"),
                                stderr=open(tmp_path / f"{name}.err", "w"))
        procs.append(proc)
        return proc

    def wait(ready, what, deadline_s=60):
        deadline = time.time() + deadline_s
        while True:
            assert all(p.poll() is None for p in procs), f"a process exited ({what})"
            try:
                if ready():
                    return
            except OSError:
                pass
            assert time.time() < deadline, what
            time.sleep(0.2)

    try:
        spawn("apiserver", "kubernetes_tpu_torch.apiserver", "--port", str(ap))
        wait(lambda: b"ok" in urllib.request.urlopen(url + "/healthz", timeout=2).read(),
             "apiserver")
        cs = Clientset(RemoteStore(url, timeout=30.0))
        for i in range(3):
            node = make_node(f"n{i}")
            node.spec.pod_cidr = f"10.24.{i}.0/24" if i < 2 else ""
            cs.nodes.create(node)
        cs.services.create(Service(meta=ObjectMeta(name="web", namespace="default"),
                                   selector={"app": "web"}, ports=[ServicePort(port=80)],
                                   type="LoadBalancer"))
        ccm = spawn("ccm", "kubernetes_tpu_torch", "cloud-controller-manager", "--apiserver", url,
                    "--leader-elect", "--monitor-period", "0.5", "--healthz-port", str(hp))
        wait(lambda: cs.services.get("web", "default").status_load_balancer, "ingress IP")
        wait(lambda: _cloud_metrics(hp)["cloud_routes"] == 2, "routes")
        m = _cloud_metrics(hp)
        assert (m["cloud_load_balancers"], m["cloud_load_balancer_nodes"]) == (1.0, 3.0)
        ccm.send_signal(signal.SIGTERM)
        assert ccm.wait(timeout=60) == 0
        lines = [json.loads(ln)["cloud_controller_manager_stats"]
                 for ln in (tmp_path / "ccm.out").read_text().splitlines()
                 if ln.startswith('{"cloud_controller_manager_stats"')]
        assert len(lines) == 1
        cloud = lines[0]["cloud"]
        (lb,) = cloud["balancers"].values()
        assert lb["nodes"] == ["n0", "n1", "n2"] and lb["ports"] == [80]
        assert [lb["ingress_ip"]] == cs.services.get("web", "default").status_load_balancer
        assert cloud["routes"] == {"n0": "10.24.0.0/24", "n1": "10.24.1.0/24"}
        assert set(lines[0]["controllers"]) == {"cloud-node", "service-lb", "route"}
        assert lines[0]["controllers"]["route"]["syncs"] >= 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def test_cloud_controller_manager_refuses_a_bad_feature_gate():
    r = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch", "cloud-controller-manager",
                        "--apiserver", "http://127.0.0.1:1", "--feature-gates", "NoSuchGate=true"],
                       env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "--feature-gates" in r.stderr
