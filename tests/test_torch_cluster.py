"""Twins of ``tests/test_cluster_up.py`` and ``tests/test_selfhosted.py`` on
the port's ``cluster.py``, as real processes on the CPU.

The two JAX process tests run on the port with their source as written
but for the names the port changes (the package, its state file and
cluster directory) and ``--device cpu`` beside ``--backend oracle``: the
port's scheduler runs on a card unless told otherwise.  The PKI phase
runs through both packages (``tests/torch_twin``).  Beside them:

- ``init`` (the batch backend on ``--device cpu``), then ``join``: a wrong
  token is refused with the JAX package's words and starts no kubelet,
  two joins with the printed token start a kubelet each (its hollow
  kube-proxy on), the cluster-info document verifies alike through either
  package's ``verify_cluster_info``; then ``down`` stops every recorded
  process, closes the apiserver's port, removes the state file, and the
  scheduler's stats line is in its log;
- the signed cluster-info ConfigMap that each package's bootstrap phase
  publishes for one token is equal;
- ``init`` without ``--device cpu`` on a machine with no card exits
  non-zero and names the scheduler."""

from __future__ import annotations

import importlib
import json
import os
import re
import socket
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import pytest

from tests.torch_twin import twin

ROOT = Path(__file__).resolve().parent.parent
STATE = ".kubernetes-tpu-torch-cluster.json"


def _port_source(name: str, swaps: list) -> types.ModuleType:
    """``tests/<name>.py`` with ``kubernetes_tpu`` renamed and each of
    ``swaps`` (old, new) applied; every swap must apply."""
    src = (ROOT / "tests" / f"{name}.py").read_text()
    src = re.sub(r"\bkubernetes_tpu\b", "kubernetes_tpu_torch", src)
    for old, new in swaps:
        assert old in src, f"{name}: {old!r} not found"
        src = src.replace(old, new)
    mod = types.ModuleType(f"tests._port_{name}")
    mod.__file__ = str(ROOT / "tests" / f"{name}.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


@pytest.mark.timeout(150)
def test_cluster_up_with_dns_addon(tmp_path):
    mod = _port_source("test_cluster_up", [
        (".kubernetes-tpu-cluster.json", STATE),
        ('"--backend", "oracle"', '"--backend", "oracle", "--device", "cpu"')])
    mod.test_cluster_up_with_dns_addon(tmp_path)
    assert not (tmp_path / STATE).exists()


def test_pki_phase(tmp_path):
    twin("test_selfhosted", "test_pki_phase", tmp_path)


@pytest.mark.timeout(280)
def test_selfhosted_control_plane_e2e(tmp_path):
    mod = _port_source("test_selfhosted", [
        (".kubernetes-tpu-cluster.json", STATE),
        ('tmp_path / ".kubernetes-tpu" /', 'tmp_path / ".kubernetes-tpu-torch" /'),
        ('"--backend", "oracle"', '"--backend", "oracle", "--device", "cpu"')])
    mod.test_selfhosted_control_plane_e2e(tmp_path)
    manifest = (tmp_path / ".kubernetes-tpu-torch" / "manifests" / "kube-scheduler.yaml").read_text()
    assert "JAX_PLATFORMS" not in manifest and "--device" in manifest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _cluster(cwd: Path, *args: str, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cluster", *args],
                          cwd=str(cwd), env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def _closed(url: str, deadline_s: float = 10) -> bool:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            urllib.request.urlopen(f"{url}/healthz", timeout=1)
            time.sleep(0.2)
        except OSError:
            return True
    return False


@pytest.mark.timeout(180)
def test_init_join_down(tmp_path):
    from kubernetes_tpu import cluster as jax_cluster
    from kubernetes_tpu_torch import cluster
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    init = _cluster(tmp_path, "init", "--port", str(port), "--dns-port", "0", "--device", "cpu")
    try:
        assert init.returncode == 0, init.stdout + init.stderr
        state = json.loads((tmp_path / STATE).read_text())
        assert sorted(state["pids"]) == ["apiserver", "controller-manager", "scheduler"]
        assert all(cluster.alive(pid) for pid in state["pids"].values())
        token = state["token"]
        assert f"join token: {token}" in init.stdout
        # the document verifies alike through either package
        assert cluster.verify_cluster_info(url, token) == \
            jax_cluster.verify_cluster_info(url, token)
        bad_token = token.split(".")[0] + "." + "0" * 16
        refusals = []
        for verify in (cluster.verify_cluster_info, jax_cluster.verify_cluster_info):
            with pytest.raises(SystemExit) as e:
                verify(url, bad_token)
            refusals.append(str(e.value))
        assert refusals[0] == refusals[1]
        bad = _cluster(tmp_path, "join", "--apiserver", url, "--token", bad_token,
                       "--name", "evil")
        assert bad.returncode != 0 and refusals[0] in bad.stderr
        assert "kubelet-evil" not in json.loads((tmp_path / STATE).read_text())["pids"]
        assert not (tmp_path / ".kubernetes-tpu-torch" / "logs" / "kubelet-evil.log").exists()
        for name in ("join-0", "join-1"):
            j = _cluster(tmp_path, "join", "--apiserver", url, "--token", token, "--name", name)
            assert j.returncode == 0 and "discovery verified" in j.stdout, j.stderr
        cs = Clientset(RemoteStore(url, timeout=30.0))
        deadline = time.time() + 60
        while {n.meta.name for n in cs.nodes.list()[0]} != {"join-0", "join-1"}:
            assert time.time() < deadline, "the joined kubelets did not register"
            time.sleep(0.3)
        state = json.loads((tmp_path / STATE).read_text())
        assert {"kubelet-join-0", "kubelet-join-1"} <= set(state["pids"])
        # a kubelet registers its node before its proxies start and it logs
        # that it runs: wait for the line before down stops it
        logs = tmp_path / ".kubernetes-tpu-torch" / "logs"
        while not all("hollow node(s) running" in (logs / f"{name}.log").read_text()
                      for name in ("kubelet-join-0", "kubelet-join-1")):
            assert time.time() < deadline, "the joined kubelets did not start"
            time.sleep(0.3)
    finally:
        down = _cluster(tmp_path, "down")
    assert down.returncode == 0, down.stderr
    assert not any(cluster.alive(pid) for pid in state["pids"].values())
    assert _closed(url)
    assert not (tmp_path / STATE).exists()
    log = (tmp_path / ".kubernetes-tpu-torch" / "logs" / "scheduler.log").read_text()
    stats = [json.loads(ln)["scheduler_stats"] for ln in log.splitlines()
             if ln.startswith('{"scheduler_stats"')]
    assert len(stats) == 1 and (stats[0]["backend"], stats[0]["device"]) == ("batch", "cpu")
    for name in ("kubelet-join-0", "kubelet-join-1"):
        assert "proxy=True" in (tmp_path / ".kubernetes-tpu-torch" / "logs" / f"{name}.log").read_text()


def _published(root: str) -> dict:
    """The cluster-info ConfigMap each package's bootstrap phase publishes,
    its token fixed."""
    cl = importlib.import_module(f"{root}.cluster")
    store = importlib.import_module(f"{root}.store.store")
    cs_mod = importlib.import_module(f"{root}.client.clientset")
    cs = cs_mod.Clientset(store.Store())
    hexes = iter(["a1b2c3", "0123456789abcdef"])
    real = cl.pysecrets.token_hex
    cl.pysecrets.token_hex = lambda n: next(hexes)
    try:
        token = cl._bootstrap_phase(cs, "https://127.0.0.1:6443", 3600.0, ca_data="PEM")
    finally:
        cl.pysecrets.token_hex = real
    info = cs.client_for("ConfigMap").get("cluster-info", "kube-public")
    secret = cs.secrets.get(f"bootstrap-token-{token.split('.')[0]}", "kube-system")
    return {"token": token, "info": dict(info.data),
            "secret": {k: v for k, v in secret.data.items() if k != "expiration"}}


def test_cluster_info_signatures_equal_the_jax_package():
    jax_out, port_out = (_published(r) for r in ("kubernetes_tpu", "kubernetes_tpu_torch"))
    assert port_out == jax_out
    assert "jws-kubeconfig-a1b2c3" in port_out["info"]


@pytest.mark.timeout(120)
def test_init_without_a_card_fails_naming_the_scheduler(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: init's scheduler runs there")
    port = _free_port()
    try:
        r = _cluster(tmp_path, "init", "--port", str(port), "--dns-port", "0")
        assert r.returncode != 0
        assert "scheduler exited with code 1 during start-up" in r.stderr
        log = (tmp_path / ".kubernetes-tpu-torch" / "logs" / "scheduler.log").read_text()
        assert "no CUDA device" in log
    finally:
        down = _cluster(tmp_path, "down")
    assert down.returncode == 0 and _closed(f"http://127.0.0.1:{port}")
