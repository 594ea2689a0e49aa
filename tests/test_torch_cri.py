"""Twins of ``tests/test_cri.py`` on the port's ``kubelet.cri``: the CRI
seam (RuntimeService/ImageService) in process and over the remote
transport, real pause sandboxes, and the hyperkube multiplexer, whose
components now include ``kubelet``.

Each twin runs the JAX test's scenario through both packages (``both``)
and holds the outcomes equal: container states and images at each step,
exec output and exit codes, which calls raise.  Exact."""

from __future__ import annotations

import pytest

from tests.torch_kubelet_pkg import both


def lifecycle(cri):
    """The kubelet's SyncPod protocol against any CRI implementation;
    returns what it observed at each step."""
    seen = []
    cri.pull_image("nginx:1.13")
    seen.append(sorted(cri.list_images()))
    assert "nginx:1.13" in seen[-1]
    sb = cri.run_pod_sandbox("default/web-1")
    cid = cri.create_container(sb, "web", "nginx:1.13")
    cri.start_container(cid)
    [c] = cri.list_containers(sb)
    assert c["state"] == "running" and c["image"] == "nginx:1.13"
    seen.append((c["state"], c["image"], c["name"] if "name" in c else None))
    cri.stop_container(cid)
    seen.append(cri.list_containers(sb)[0]["state"])
    assert seen[-1] == "exited"
    cri.stop_pod_sandbox(sb)
    cri.remove_image("nginx:1.13")
    assert cri.list_images() == []
    with pytest.raises(ValueError):
        cri.create_container(sb, "x", "ghost:latest")
    with pytest.raises(ValueError):
        cri.exec_sync(cid, ["true"])
    return seen


def test_local_cri_lifecycle():
    both(lambda P: lifecycle(P.cri.LocalCRI()))


@pytest.mark.timeout(60)
def test_remote_cri_same_contract():
    def scenario(P):
        server = P.cri.CRIServer(P.cri.LocalCRI())
        server.start()
        try:
            return lifecycle(P.cri.RemoteCRI(server.url))
        finally:
            server.stop()

    # the remote client keeps the in-process contract, in both packages
    assert both(scenario) == both(lambda P: lifecycle(P.cri.LocalCRI()))


@pytest.mark.timeout(60)
def test_remote_cri_exec_roundtrip():
    def scenario(P):
        local = P.cri.LocalCRI()
        local.runtime.set_exec_handler("default/p", "c", lambda cmd: (" ".join(cmd), 0))
        server = P.cri.CRIServer(local)
        server.start()
        try:
            cri = P.cri.RemoteCRI(server.url)
            cri.pull_image("img")
            sb = cri.run_pod_sandbox("default/p")
            cid = cri.create_container(sb, "c", "img")
            cri.start_container(cid)
            got = tuple(cri.exec_sync(cid, ["echo", "hi"]))
            assert got == ("echo hi", 0)
            return got
        finally:
            server.stop()

    both(scenario)


@pytest.mark.timeout(60)
def test_local_cri_with_real_sandboxes():
    def scenario(P):
        mgr = P.runtime.ProcessSandboxManager()
        assert mgr.enabled, "the pause binary did not build"
        try:
            cri = P.cri.LocalCRI(sandboxes=mgr)
            sb = cri.run_pod_sandbox("default/real-1")
            up = mgr.exists("default/real-1")
            cri.stop_pod_sandbox(sb)
            down = mgr.exists("default/real-1")
            assert (up, down) == (True, False)
            return up, down
        finally:
            mgr.remove_all()

    both(scenario)


def test_hyperkube_multiplexer(capsys):
    def scenario(P):
        hyperkube = P.hyperkube.main
        rcs = [hyperkube([]), hyperkube(["--help"]), hyperkube(["no-such-component"])]
        assert rcs == [2, 0, 2]
        listed = "kubelet" in capsys.readouterr().err
        assert listed
        # dispatch into the kubelet's own main: no --apiserver and no
        # --kubeconfig is a usage error there (exit 2)
        with pytest.raises(SystemExit) as e:
            hyperkube(["kubelet", "--name", "n1"])
        return rcs, listed, e.value.code

    assert both(scenario)[2] == 2
