"""The port's ``kubectl`` and ``kubefed`` as hyperkube components, run as
processes the way a user runs them, with and without PyYAML.

An apiserver of the port serves in this process; ``python -m
kubernetes_tpu_torch.federation`` runs as a process of its own.  Each
command runs twice: as ``python -m kubernetes_tpu_torch ...`` and in a
process whose ``import yaml`` raises (``sys.modules["yaml"] = None``
before the hyperkube starts).  Both must exit 0 with the same output:
``get nodes -o json``, ``create -f`` of a JSON manifest and ``kubefed
get-clusters`` need no PyYAML (``-o yaml`` does, and fails without it).
The federation process stops on SIGTERM with exit 0."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_YAML = ("import runpy, sys; sys.modules['yaml'] = None; "
           "runpy.run_module('kubernetes_tpu_torch', run_name='__main__', alter_sys=True)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hyperkube(*argv, yaml: bool = True):
    cmd = ([sys.executable, "-m", "kubernetes_tpu_torch", *argv] if yaml
           else [sys.executable, "-c", NO_YAML, *argv])
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout, proc.stderr


def _both(*argv):
    """The command without PyYAML, then with it: (rc, stdout) of each."""
    without = _hyperkube(*argv, yaml=False)
    assert without[0] == 0, without
    with_yaml = _hyperkube(*argv)
    return without[:2], with_yaml[:2]


def _wait_healthy(url: str, deadline_s: float = 30.0) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            if time.monotonic() > deadline:
                raise
        time.sleep(0.1)


@pytest.mark.timeout(120)
def test_kubectl_and_kubefed_run_without_pyyaml(tmp_path):
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testutil import make_node

    store = Store()
    cs = Clientset(store)
    for i in range(3):
        cs.nodes.create(make_node(f"n{i}"))
    server = APIServer(store)
    server.start()
    fed_port = _free_port()
    fed_url = f"http://127.0.0.1:{fed_port}"
    log = tmp_path / "federation.log"
    with open(log, "w") as f:
        fed = subprocess.Popen([sys.executable, "-m", "kubernetes_tpu_torch.federation",
                                "--port", str(fed_port), "--sync-interval", "0.2"],
                               cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    try:
        server_args = ("kubectl", "--server", server.url)
        without, with_yaml = _both(*server_args, "get", "nodes", "-o", "json")
        assert without == with_yaml
        assert [n["metadata"]["name"] for n in json.loads(without[1])["items"]] == [
            "n0", "n1", "n2"]
        # the shim holds: the one output form that needs PyYAML fails without it
        rc, _, err = _hyperkube(*server_args, "get", "nodes", "-o", "yaml", yaml=False)
        assert rc != 0 and "yaml" in err

        manifest = tmp_path / "cm.json"
        manifest.write_text(json.dumps({
            "kind": "ConfigMap", "apiVersion": "v1",
            "metadata": {"name": "cfg", "namespace": "default"},
            "data": {"mode": "prod"}}))
        created = []
        for yaml in (False, True):
            rc, out, err = _hyperkube(*server_args, "create", "-f", str(manifest), yaml=yaml)
            assert rc == 0, (out, err)
            created.append(out)
            assert cs.configmaps.get("cfg", "default").data == {"mode": "prod"}
            rc, _, _ = _hyperkube(*server_args, "delete", "configmap", "cfg")
            assert rc == 0
        assert created == ["configmaps/cfg created\n"] * 2

        _wait_healthy(fed_url)
        rc, out, err = _hyperkube("kubefed", "--host", fed_url, "join", "member",
                                  "--cluster-server", server.url, yaml=False)
        assert (rc, out) == (0, "cluster/member joined\n"), err
        deadline = time.monotonic() + 30
        while True:
            without, with_yaml = _both("kubefed", "--host", fed_url, "get-clusters")
            if ("True" in without[1] and "True" in with_yaml[1]) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert without == with_yaml
        rows = [line.split() for line in with_yaml[1].splitlines()]
        assert rows == [["NAME", "SERVER", "READY", "ZONE"], ["member", server.url, "True"]]
    finally:
        server.stop()
        fed.send_signal(signal.SIGTERM)
        try:
            rc = fed.wait(timeout=30)
        finally:
            if fed.poll() is None:
                fed.kill()
                fed.wait()
    assert rc == 0, log.read_text()[-2000:]
