"""The port's kubelet entry point over the wire, on the CPU:
``python -m kubernetes_tpu_torch kubelet --count 20`` against the port's
apiserver process, served by the port's scheduler daemon on ``--device
cpu``.  1000 pods are created in one batch; every pod must reach
``Running``, and the bindings and the round-robin counter must equal the
port's sequential oracle over the cluster as read back (exact).  The
fleet process exits 0 on SIGTERM.  ``kubelet --count 3 --proxy`` runs a
hollow kube-proxy beside each node: every proxier converges on a
Service's rule (its ``/metrics``), and the process exits 0 on SIGTERM.
``kubelet --count 3 --serve-logs`` answers ``kubectl logs`` and ``exec``
through the apiserver on its renamed nodes.  A
kubelet with neither ``--apiserver`` nor ``--kubeconfig`` leaves with
exit 2, as the JAX entry point does."""

from __future__ import annotations

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

from tests.torch_kubelet_pkg import both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _wait(ready, procs, what: str, deadline_s: float) -> None:
    deadline = time.time() + deadline_s
    while True:
        for name, proc in procs:
            assert proc.poll() is None, f"{name} exited with {proc.returncode} ({what})"
        try:
            if ready():
                return
        except OSError:
            pass
        assert time.time() < deadline, f"{what}: not after {deadline_s} s"
        time.sleep(0.2)


def _terminate(proc: subprocess.Popen) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise


@pytest.mark.timeout(300)
def test_a_kubelet_fleet_runs_what_the_scheduler_daemon_binds(tmp_path):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.client.remote import RemoteStore

    n_nodes, n_pods = 20, 1000
    ap, hp = _free_port(), _free_port()
    url = f"http://127.0.0.1:{ap}"
    procs = []

    def spawn(name, *args):
        proc = subprocess.Popen([sys.executable, "-m", *args], env=_env(), cwd=tmp_path,
                                stdout=open(tmp_path / f"{name}.out", "w"),
                                stderr=open(tmp_path / f"{name}.err", "w"))
        procs.append((name, proc))
        return proc

    try:
        spawn("apiserver", "kubernetes_tpu_torch.apiserver", "--port", str(ap))
        _wait(lambda: b"ok" in urllib.request.urlopen(url + "/healthz", timeout=2).read(),
              procs, "apiserver /healthz", 60)
        fleet = spawn("kubelet", "kubernetes_tpu_torch", "kubelet", "--apiserver", url,
                      "--count", str(n_nodes), "--name", "hollow", "--cpu", "32",
                      "--memory", "128Gi")
        rs = RemoteStore(url, timeout=60.0)
        _wait(lambda: len(rs.list("Node")[0]) == n_nodes, procs, "nodes registered", 120)
        nodes = rs.list("Node")[0]
        assert sorted(n["metadata"]["name"] for n in nodes) == [
            f"hollow-{i:05d}" for i in range(n_nodes)]
        # the scheduler starts once the cluster exists (kept divergence k)
        spawn("scheduler", "kubernetes_tpu_torch.scheduler", "--apiserver", url,
              "--leader-elect", "--device", "cpu", "--healthz-port", str(hp))
        _wait(lambda: b"scheduler_e2e" in urllib.request.urlopen(
            f"http://127.0.0.1:{hp}/metrics", timeout=2).read(), procs, "scheduler serving", 120)
        pods = [p.to_dict() for p in workload.make_pods(n_pods, random.Random(5), "plain")]
        assert all(d is not None for d in rs.create_many("Pod", pods))

        def all_running():
            items = rs.list("Pod")[0]
            return (len(items) == n_pods
                    and all(i.get("status", {}).get("phase") == "Running" for i in items))

        _wait(all_running, procs, "every pod Running", 180)
        items = rs.list("Pod")[0]
        got = {f"default/{i['metadata']['name']}": i["spec"]["nodeName"] for i in items}
        ips = {(i["spec"]["nodeName"], i["status"]["podIP"]) for i in items}
        assert len(ips) == n_pods  # unique within each node
        assert all(i["status"]["hostIP"] == i["spec"]["nodeName"] for i in items)
        assert not [i for i in items if i["status"].get("reason", "").startswith("OutOf")]
        assert workload.overcommitted_nodes(items, rs.list("Node")[0]) == []
        sched = dict(procs)["scheduler"]
        assert _terminate(sched) == 0
        stats = [json.loads(line)["scheduler_stats"] for line in
                 (tmp_path / "scheduler.out").read_text().splitlines()
                 if line.startswith('{"scheduler_stats"')][0]
        # each pod: its create, its binding and its Running update
        assert stats["informer_events"]["Pod"] >= 3 * n_pods
        assert _terminate(fleet) == 0
        counts = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1]) for line in
                  urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
                  .splitlines() if line.startswith("apiserver_requests_total{")}
        # the kubelets' status writes (a PUT of the pod) and registrations
        assert counts['apiserver_requests_total{verb="update",resource="pods"}'] >= n_pods
        assert counts['apiserver_requests_total{verb="create",resource="nodes"}'] == n_nodes
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    o = workload.oracle_replay_state({"Node": nodes}, pods, 0)
    assert o["assignments"] == got
    assert o["round_robin"] == stats["round_robin"]


def _proxy_metrics(port: int) -> dict:
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    return {line.split(" ", 1)[0][len("hollow_proxy_"):]: float(line.split(" ", 1)[1])
            for line in text.splitlines() if line.startswith("hollow_proxy_")}


@pytest.mark.timeout(120)
def test_kubelet_proxy_fleet_converges_a_service(tmp_path):
    """``kubelet --count 3 --proxy``: three proxiers, one rule each for a
    Service's port with exactly its Endpoints' ready addresses (the
    not-ready one left out), equal to the rule set computed here; exit 0
    on SIGTERM."""
    from kubernetes_tpu_torch.api.cluster import (EndpointAddress, EndpointPort, Endpoints,
                                                  EndpointSubset)
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import Service, ServicePort
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.proxy.hollow import digest

    ap, hp = _free_port(), _free_port()
    url = f"http://127.0.0.1:{ap}"
    procs = []

    def spawn(name, *args):
        proc = subprocess.Popen([sys.executable, "-m", *args], env=_env(), cwd=tmp_path,
                                stdout=open(tmp_path / f"{name}.out", "w"),
                                stderr=open(tmp_path / f"{name}.err", "w"))
        procs.append((name, proc))
        return proc

    try:
        spawn("apiserver", "kubernetes_tpu_torch.apiserver", "--port", str(ap))
        _wait(lambda: b"ok" in urllib.request.urlopen(url + "/healthz", timeout=2).read(),
              procs, "apiserver /healthz", 60)
        fleet = spawn("kubelet", "kubernetes_tpu_torch", "kubelet", "--apiserver", url,
                      "--count", "3", "--name", "px", "--proxy", "--tick", "0.2",
                      "--healthz-port", str(hp))
        _wait(lambda: _proxy_metrics(hp).get("proxiers") == 3, procs, "proxy metrics", 60)
        cs = Clientset(RemoteStore(url, timeout=30.0))
        cs.services.create(Service(
            meta=ObjectMeta(name="web", namespace="default"), selector={"app": "web"},
            ports=[ServicePort(name="http", port=80, target_port=8080)],
            cluster_ip="10.0.0.80"))
        cs.endpoints.create(Endpoints(
            meta=ObjectMeta(name="web", namespace="default"),
            subsets=[EndpointSubset(
                addresses=[EndpointAddress(ip="10.8.0.2", node_name="px-00001"),
                           EndpointAddress(ip="10.8.1.2", node_name="px-00002")],
                not_ready_addresses=[EndpointAddress(ip="10.8.2.2")],
                ports=[EndpointPort(name="http", port=8080)])]))
        want = digest([["cluster", "10.0.0.80", 80, "TCP", "default/web:http",
                        [["10.8.0.2", 8080], ["10.8.1.2", 8080]]]])
        _wait(lambda: _proxy_metrics(hp)["rule_set_digest"] == want, procs,
              "the proxiers' rules", 60)
        m = _proxy_metrics(hp)
        assert (m["rules"], m["rule_endpoints"], m["rule_sets_differing"]) == (3, 6, 0)
        assert m["syncs_total"] >= 6
        assert _terminate(fleet) == 0
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.timeout(120)
def test_a_serving_fleet_answers_kubectl_logs_and_exec(tmp_path):
    """``kubelet --count 3 --serve-logs``: each renamed node of the fleet
    serves the kubelet API, so ``kubectl logs`` and ``kubectl exec`` reach
    a pod on it through the apiserver (exec presents the token of the
    node's own name); the fleet exits 0 on SIGTERM."""
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.testutil import make_pod

    ap = _free_port()
    url = f"http://127.0.0.1:{ap}"
    procs = []

    def spawn(name, *args):
        proc = subprocess.Popen([sys.executable, "-m", *args], env=_env(), cwd=tmp_path,
                                stdout=open(tmp_path / f"{name}.out", "w"),
                                stderr=open(tmp_path / f"{name}.err", "w"))
        procs.append((name, proc))
        return proc

    def kubectl(*argv):
        proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch", "kubectl",
                               "--server", url, *argv], env=_env(), cwd=tmp_path,
                              capture_output=True, text=True, timeout=60)
        return proc.returncode, proc.stdout

    try:
        spawn("apiserver", "kubernetes_tpu_torch.apiserver", "--port", str(ap))
        _wait(lambda: b"ok" in urllib.request.urlopen(url + "/healthz", timeout=2).read(),
              procs, "apiserver /healthz", 60)
        fleet = spawn("kubelet", "kubernetes_tpu_torch", "kubelet", "--apiserver", url,
                      "--count", "3", "--name", "sv", "--serve-logs", "--tick", "0.2")
        rs = RemoteStore(url, timeout=30.0)
        _wait(lambda: [bool((n.get("status") or {}).get("kubeletURL"))
                       for n in rs.list("Node")[0]] == [True] * 3,
              procs, "three serving nodes", 60)
        rs.create("Pod", make_pod("p", node_name="sv-00001").to_dict())
        _wait(lambda: (rs.get("Pod", "default", "p").get("status") or {}).get("phase")
              == "Running", procs, "the pod Running", 60)
        rc, out = kubectl("logs", "p")
        assert rc == 0 and "container c0 started" in out, out
        assert kubectl("exec", "p", "--", "echo", "hi") == (0, "echo hi\n")
        assert _terminate(fleet) == 0
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.timeout(120)
def test_kubelet_entry_imports_no_torch():
    """The kubelet runs no kernel: its entry point loads no torch."""
    code = ("import sys, kubernetes_tpu_torch.kubelet.__main__\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kubelet_without_an_apiserver_exits_2():
    def scenario(P):
        with pytest.raises(SystemExit) as e:
            P.kubelet_main.main(["--name", "n1"])
        return e.value.code

    assert both(scenario) == 2
