"""Twins of ``tests/test_kubelet_real.py`` on the port's kubelet with real
containers: forked child processes (``kubelet/containers.py``), on-disk
volumes (``kubelet/volumehost.py``), exec, kill -9 recovery, exec
liveness probes, checkpoint adoption and static pods.

Each twin runs the JAX test's scenario through both packages (``both``)
on the same fake clock, asserts what the JAX test asserts on each, and
holds the outcomes equal: phases, restart counts, exec output and exit
codes, file contents, whether a pid changed or lived (never the pid
itself, which the kernel picks).  Every scenario reaps the processes it
started in a ``finally``.

``test_kubectl_exec_reaches_a_real_process`` runs whole through both
packages (``tests/torch_twin``): both pass its assertions and leave equal
stores, the containers' pids masked.  Its ``kubectl exec`` calls are
held by the test's own assertions: it retries until the container has
run, so the number of calls differs by run."""

from __future__ import annotations

import http.server
import os
import signal
import threading
import time

import pytest
import yaml

from tests.torch_kubelet_pkg import FakeClock, both
from tests.torch_twin import twin


def real_pod(P, name, command=None, volumes=None, mounts=None, liveness=None):
    api = P.api
    return api.Pod(
        meta=api.ObjectMeta(name=name, namespace="default", labels={"app": name}),
        spec=api.PodSpec(
            containers=[api.Container(name="c", image="img", command=command or [],
                                      volume_mounts=mounts or [], liveness_probe=liveness)],
            volumes=volumes or [],
            node_name="n1",
            restart_policy="Always",
        ),
    )


def start(cs, k, pod):
    cs.pods.create(pod)
    k.tick()
    k.tick()
    k.tick()
    return cs.pods.get(pod.meta.name, "default")


def _pid(pod):
    cid = pod.status.container_statuses[0].container_id
    assert cid.startswith("pid://"), cid
    return int(cid[len("pid://"):])


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _wait_dead(pid, seconds=10):
    deadline = time.monotonic() + seconds
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.01)


def _exec_until_ok(k, command, seconds=5):
    deadline = time.monotonic() + seconds
    while True:
        out, rc = k.runtime.exec("default/p", "c", command)
        if rc == 0 or time.monotonic() >= deadline:
            return out, rc
        time.sleep(0.02)


def _teardown(*kubelets):
    for k in kubelets:
        if k.containers is not None:
            k.containers.remove_all()
        if k.volume_host is not None:
            k.volume_host.teardown_all()


def _world(P, **kw):
    cs = P.Clientset(P.Store())
    clock = FakeClock()
    k = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock, real_containers=True,
                        **kw)
    k.register()
    return cs, clock, k


def _manifest(name, command):
    doc = {"kind": "Pod", "metadata": {"name": name, "namespace": "default"},
           "spec": {"containers": [{"name": "c", "image": "img"}]}}
    if command:
        doc["spec"]["containers"][0]["command"] = command
    return yaml.safe_dump(doc)


@pytest.mark.timeout(60)
def test_container_is_a_real_process_and_exec_runs_in_it():
    def scenario(P):
        cs, clock, k = _world(P)
        try:
            got = start(cs, k, real_pod(P, "p", command=[
                "/bin/sh", "-c", "echo hello-from-entrypoint > started; exec sleep 1000"]))
            assert got.status.phase == "Running" and _alive(_pid(got))
            first = _exec_until_ok(k, ["/bin/cat", "started"])
            assert first == ("hello-from-entrypoint\n", 0)
            via = k.runtime.exec("default/p", "c", ["/bin/sh", "-c", "echo via-exec"])
            assert via == ("via-exec\n", 0)
            _, rc = k.runtime.exec("default/p", "c", ["/bin/sh", "-c", "exit 3"])
            assert rc == 3
            return got.status.phase, first, via, rc
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_kill9_triggers_restart_with_new_real_pid():
    def scenario(P):
        cs, clock, k = _world(P)
        try:
            pid1 = _pid(start(cs, k, real_pod(P, "p", command=["/bin/sleep", "1000"])))
            os.kill(pid1, signal.SIGKILL)
            _wait_dead(pid1, 5)
            clock.advance(2.0)
            out = k.tick()
            assert out["restarts"] == 1
            got = cs.pods.get("p", "default")
            assert got.status.container_statuses[0].restart_count == 1
            pid2 = _pid(got)
            assert pid2 != pid1 and _alive(pid2)
            clock.advance(2.0)
            events = k.pleg.relist(force=True)
            assert k.pod_manager._pods["default/p"]["c"].status.restart_count == 1
            return out, got.status.container_statuses[0].reason, [e.type for e in events]
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_configmap_update_appears_in_container_filesystem():
    def scenario(P):
        api = P.api
        cs, clock, k = _world(P)
        try:
            cs.client_for("ConfigMap").create(api.ConfigMap(
                meta=api.ObjectMeta(name="app-config", namespace="default"),
                data={"mode": "v1"}))
            start(cs, k, real_pod(
                P, "p", command=["/bin/sleep", "1000"],
                volumes=[api.Volume(name="cfg", config_map_name="app-config")],
                mounts=[api.VolumeMount(name="cfg", mount_path="/etc/config")]))
            v1 = k.runtime.exec("default/p", "c", ["/bin/cat", "etc/config/mode"])
            assert (v1[0].strip(), v1[1]) == ("v1", 0)
            vol_dir = k.volume_host.volume_path("default/p", "cfg")
            links = (os.path.islink(os.path.join(vol_dir, "..data")),
                     os.path.islink(os.path.join(vol_dir, "mode")))
            assert links == (True, True)

            def _update(cur):
                cur.data = {"mode": "v2"}
                return cur

            cs.client_for("ConfigMap").guaranteed_update("app-config", _update, "default")
            k.tick()
            v2 = k.runtime.exec("default/p", "c", ["/bin/cat", "etc/config/mode"])
            assert (v2[0].strip(), v2[1]) == ("v2", 0)
            return v1, links, v2
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_emptydir_secret_and_downward_api_volumes():
    def scenario(P):
        api = P.api
        cs, clock, k = _world(P)
        try:
            cs.client_for("Secret").create(api.Secret(
                meta=api.ObjectMeta(name="creds", namespace="default"),
                data={"token": "s3cr3t"}))
            start(cs, k, real_pod(
                P, "p", command=["/bin/sleep", "1000"],
                volumes=[api.Volume(name="scratch", empty_dir=True),
                         api.Volume(name="creds", secret_name="creds"),
                         api.Volume(name="meta", downward_api={
                             "podname": "metadata.name", "app": "metadata.labels['app']"})],
                mounts=[api.VolumeMount(name="scratch", mount_path="/scratch"),
                        api.VolumeMount(name="creds", mount_path="/var/secrets"),
                        api.VolumeMount(name="meta", mount_path="/podinfo")]))
            ex = lambda cmd: k.runtime.exec("default/p", "c", cmd)  # noqa: E731
            got = [ex(["/bin/sh", "-c", "echo persisted > scratch/f"]),
                   ex(["/bin/cat", "scratch/f"]), ex(["/bin/cat", "var/secrets/token"]),
                   ex(["/bin/cat", "podinfo/podname"]), ex(["/bin/cat", "podinfo/app"])]
            assert [g[1] for g in got] == [0] * 5
            assert [g[0].strip() for g in got[1:]] == ["persisted", "s3cr3t", "p", "p"]
            read = k.runtime.read_file("default/p", "c", "scratch/f")
            assert read.strip() == b"persisted"
            k.runtime.write_file("default/p", "c", "scratch/put", b"uploaded")
            put = ex(["/bin/cat", "scratch/put"])
            assert (put[0].strip(), put[1]) == ("uploaded", 0)
            return got, read, put
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_exec_liveness_probe_drives_real_restart():
    def scenario(P):
        cs, clock, k = _world(P)
        try:
            probe = P.api.Probe(handler="exec", exec_command=["/bin/sh", "-c", "test -f healthy"],
                                period_seconds=1, failure_threshold=2)
            pid1 = _pid(start(cs, k, real_pod(
                P, "p", command=["/bin/sh", "-c", "touch healthy; exec sleep 1000"],
                liveness=probe)))
            _exec_until_ok(k, ["/bin/ls", "healthy"])
            clock.advance(1.5)
            k.tick()
            before = cs.pods.get("p", "default").status.container_statuses[0].restart_count
            assert before == 0
            assert k.runtime.exec("default/p", "c", ["/bin/rm", "healthy"])[1] == 0
            ticks = 0
            for _ in range(4):
                clock.advance(1.5)
                k.tick()
                ticks += 1
                if cs.pods.get("p", "default").status.container_statuses[0].restart_count >= 1:
                    break
            got = cs.pods.get("p", "default")
            assert got.status.container_statuses[0].restart_count >= 1
            assert _pid(got) != pid1
            return before, ticks, got.status.container_statuses[0].reason
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_local_cri_runs_real_processes():
    def scenario(P):
        procs = P.containers.ProcessContainerManager()
        cri = P.cri.LocalCRI(processes=procs)
        try:
            cri.pull_image("img")
            sb = cri.run_pod_sandbox("default/p")
            cid = cri.create_container(sb, "c", "img", command=["/bin/sleep", "1000"])
            cri.start_container(cid)
            listed = cri.list_containers(sb)
            assert listed[0]["state"] == "running" and listed[0]["pid"] > 0
            echo = tuple(cri.exec_sync(cid, ["/bin/echo", "through-cri"]))
            assert echo == ("through-cri\n", 0)
            os.kill(listed[0]["pid"], signal.SIGKILL)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                cur = cri.list_containers(sb)[0]
                if cur["state"] == "exited":
                    break
                time.sleep(0.01)
            assert (cur["state"], cur["exitCode"]) == ("exited", 137)
            with pytest.raises(ValueError):
                cri.exec_sync(cid, ["/bin/true"])
            cri.stop_pod_sandbox(sb)
            return echo, cur["state"], cur["exitCode"]
        finally:
            procs.remove_all()

    both(scenario)


@pytest.mark.timeout(60)
def test_unrunnable_entrypoint_does_not_abort_the_sync_tick():
    def scenario(P):
        cs, clock, k = _world(P)
        try:
            cs.pods.create(real_pod(P, "bad", command=["/no/such/binary"]))
            cs.pods.create(real_pod(P, "good", command=["/bin/sleep", "1000"]))
            deadline = time.monotonic() + 10
            bad = None
            while time.monotonic() < deadline:
                clock.advance(2.0)
                k.tick()
                bad = cs.pods.get("bad", "default")
                if (bad.status.container_statuses
                        and bad.status.container_statuses[0].restart_count >= 1):
                    break
                time.sleep(0.05)
            good = cs.pods.get("good", "default")
            assert good.status.phase == "Running" and _alive(_pid(good))
            assert bad.status.container_statuses[0].restart_count >= 1
            lines = k.runtime.read_logs("default/bad", "c") or []
            spawn_failed = any("spawn failed" in ln for ln in lines)
            assert spawn_failed
            return good.status.phase, bad.status.phase, spawn_failed
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_cp_path_guard_blocks_rootfs_escape():
    def scenario(P):
        cs, clock, k = _world(P)
        try:
            start(cs, k, real_pod(P, "p", command=["/bin/sleep", "1000"]))
            escaped = k.runtime.read_file("default/p", "c", "../rootfs-evil/x")
            k.runtime.write_file("default/p", "c", "../rootfs-evil/x", b"nope")
            rootfs = k.containers.rootfs("default/p", "c")
            evil = os.path.exists(os.path.join(os.path.dirname(rootfs), "rootfs-evil"))
            host = k.runtime.read_file("default/p", "c", "../../../../etc/hostname")
            assert (escaped, evil, host) == (None, False, None)
            return escaped, evil, host
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_list_containers_keeps_exit_code_for_late_pollers():
    def scenario(P):
        procs = P.containers.ProcessContainerManager()
        cri = P.cri.LocalCRI(processes=procs)
        try:
            cri.pull_image("img")
            sb = cri.run_pod_sandbox("default/p")
            cid = cri.create_container(sb, "c", "img", command=["/bin/sh", "-c", "exit 3"])
            cri.start_container(cid)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if cri.list_containers(sb)[0]["state"] == "exited":
                    break
                time.sleep(0.01)
            again = cri.list_containers(sb)[0]
            assert (again["state"], again["exitCode"]) == ("exited", 3)
            return again["state"], again["exitCode"]
        finally:
            procs.remove_all()
            cri.stop_pod_sandbox("default/p")

    both(scenario)


@pytest.mark.timeout(120)
def test_kubelet_restart_adopts_running_containers(tmp_path):
    def scenario(P):
        root = str(tmp_path / P.name / "containers")
        cs = P.Clientset(P.Store())
        k1 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(),
                             real_containers=True, container_root=root)
        k1.register()
        start(cs, k1, real_pod(
            P, "p", command=["/bin/sh", "-c", "echo survivor > mark; exec sleep 1000"]))
        pid1 = _pid(cs.pods.get("p", "default"))
        k2 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(),
                             real_containers=True, container_root=root)
        k3 = None
        try:
            adopted = k2.containers.stats["adopted"]
            assert adopted == 1
            for _ in range(3):
                k2.tick()
            pod = cs.pods.get("p", "default")
            assert pod.status.phase == "Running" and _pid(pod) == pid1 and _alive(pid1)
            mark = _exec_until_ok(k2, ["/bin/cat", "mark"])
            assert mark == ("survivor\n", 0)
            os.kill(pid1, signal.SIGKILL)
            _wait_dead(pid1)
            restarted = False
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                k2.tick()
                pod = cs.pods.get("p", "default")
                if pod.status.container_statuses[0].restart_count >= 1 and _pid(pod) != pid1:
                    restarted = True
                    break
                time.sleep(0.05)
            assert restarted and _alive(_pid(pod))
            k3 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(),
                                 real_containers=True, container_root=root)
            assert k3.containers.stats["adopted"] == 1
            return adopted, mark, restarted, k3.containers.stats["adopted"]
        finally:
            _teardown(k2, k1)

    both(scenario)


@pytest.mark.timeout(60)
def test_graceful_exit_preserves_persistent_containers(tmp_path):
    def scenario(P):
        root = str(tmp_path / P.name / "ctrs")
        m1 = P.containers.ProcessContainerManager(root=root)
        m2 = None
        try:
            pid = m1.start("default/p", "c", command=["/bin/sleep", "100"])
            ckpt = m1.checkpoint_path("default/p", "c")
            assert os.path.exists(ckpt)
            m1._atexit_cleanup()
            kept = (_alive(pid), os.path.exists(ckpt))
            assert kept == (True, True)
            os.makedirs(os.path.join(root, "default_q", "containers", "c"), exist_ok=True)
            bad = os.path.join(root, "default_q", "containers", "c", "checkpoint.json")
            with open(bad, "w") as f:
                f.write('["not", "a", "dict"]')
            m2 = P.containers.ProcessContainerManager(root=root)
            got = (m2.adopt_checkpoints(), m2.alive("default/p", "c"),
                   m2.pid("default/p", "c") == pid, os.path.exists(bad))
            assert got == (1, True, True, False)
            return os.path.relpath(ckpt, root), kept, got
        finally:
            if m2 is not None:
                m2.remove_all()
            m1.remove_all()

    both(scenario)


@pytest.mark.timeout(120)
def test_static_pods_from_manifest_dir(tmp_path):
    def scenario(P):
        mdir = tmp_path / P.name / "manifests"
        mdir.mkdir(parents=True)
        cs, clock, k = _world(P, static_pod_dir=str(mdir))
        manifest = mdir / "web.yaml"
        manifest.write_text(_manifest("web", ["/bin/sleep", "1000"]))
        try:
            for _ in range(3):
                k.tick()
            pod = cs.pods.get("web-n1", "default")
            assert pod.status.phase == "Running"
            assert pod.meta.annotations["kubernetes.io/config.mirror"] == "true"
            assert pod.spec.node_name == "n1" and _alive(_pid(pod))
            seen = [(pod.status.phase, dict(pod.meta.annotations))]
            cs.pods.delete("web-n1", "default")
            for _ in range(4):
                k.tick()
            seen.append(cs.pods.get("web-n1", "default").status.phase)
            assert seen[-1] in ("Pending", "Running")
            manifest.write_text(_manifest("web", ["/bin/sleep", "999"]))
            for _ in range(4):
                k.tick()
            seen.append(cs.pods.get("web-n1", "default").spec.containers[0].command)
            assert seen[-1] == ["/bin/sleep", "999"]
            user = real_pod(P, "db-n1", command=["/bin/sleep", "1000"])
            cs.pods.create(user)
            (mdir / "db.yaml").write_text(_manifest("db", None))
            for _ in range(3):
                k.tick()
            db = cs.pods.get("db-n1", "default")
            assert "kubernetes.io/config.mirror" not in db.meta.annotations
            seen.append(sorted(db.meta.annotations))
            manifest.unlink()
            k.tick()
            with pytest.raises(P.store_mod.NotFoundError):
                cs.pods.get("web-n1", "default")
            return seen
        finally:
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(120)
def test_http_manifest_pod_source():
    def scenario(P):
        doc = {"kind": "Pod", "metadata": {"name": "remote", "namespace": "default"},
               "spec": {"containers": [{"name": "c", "image": "img",
                                        "command": ["/bin/sleep", "1000"]}]}}
        body = {"data": yaml.safe_dump(doc).encode()}

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body["data"])))
                self.end_headers()
                self.wfile.write(body["data"])

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{srv.server_port}/manifest.yaml"
        cs, clock, k = _world(P, manifest_url=url)
        up = True
        try:
            for _ in range(3):
                k.tick()
            pod = cs.pods.get("remote-n1", "default")
            assert pod.status.phase == "Running" and _alive(_pid(pod))
            assert pod.meta.annotations["kubernetes.io/config.source"] == "http"
            doc["spec"]["containers"][0]["command"] = ["/bin/sleep", "999"]
            body["data"] = yaml.safe_dump(doc).encode()
            k.tick()
            within = cs.pods.get("remote-n1", "default").spec.containers[0].command
            assert within == ["/bin/sleep", "1000"]
            for _ in range(4):
                clock.advance(25.0)
                k.tick()
            after = cs.pods.get("remote-n1", "default").spec.containers[0].command
            assert after == ["/bin/sleep", "999"]
            srv.shutdown()
            srv.server_close()
            up = False
            for _ in range(3):
                clock.advance(25.0)
                k.tick()
            phase = cs.pods.get("remote-n1", "default").status.phase
            assert phase == "Running"
            return within, after, phase
        finally:
            if up:
                srv.shutdown()
                srv.server_close()
            t.join(timeout=5)
            _teardown(k)

    both(scenario)


@pytest.mark.timeout(60)
def test_transient_manifest_dir_failure_keeps_static_pods(tmp_path, monkeypatch):
    def scenario(P):
        mdir = tmp_path / P.name / "manifests"
        mdir.mkdir(parents=True)
        (mdir / "web.yaml").write_text(_manifest("web", ["/bin/sleep", "1000"]))
        cs, clock, k = _world(P, static_pod_dir=str(mdir))
        try:
            for _ in range(3):
                k.tick()
            phases = [cs.pods.get("web-n1", "default").status.phase]
            real_listdir = os.listdir

            def flaky(path):
                if str(path) == str(mdir):
                    raise OSError("transient I/O error")
                return real_listdir(path)

            monkeypatch.setattr(os, "listdir", flaky)
            for _ in range(2):
                k.tick()
            monkeypatch.setattr(os, "listdir", real_listdir)
            phases.append(cs.pods.get("web-n1", "default").status.phase)
            k.tick()
            phases.append(cs.pods.get("web-n1", "default").status.phase)
            assert phases == ["Running"] * 3
            return phases
        finally:
            monkeypatch.undo()
            _teardown(k)

    both(scenario)


def test_traversal_payload_keys_never_escape_the_volume_root(tmp_path):
    def scenario(P):
        api = P.api
        root = tmp_path / P.name / "volroot"
        outside = tmp_path / P.name / "outside"
        outside.mkdir(parents=True)
        evil = {"../../../outside/pwned": "boom", "/abs/path": "boom", "nested/key": "boom",
                "..": "boom", "..data": "boom", "..evil": "boom", "ok": "fine"}
        vh = P.volumehost.VolumeHost(root=str(root), fetch_configmap=lambda ns, n: dict(evil))
        pod = api.Pod(meta=api.ObjectMeta(name="p", namespace="default"),
                      spec=api.PodSpec(node_name="n1", containers=[api.Container(name="c")],
                                       volumes=[api.Volume(name="cfg", config_map_name="cm")]))
        try:
            first = vh.sync_pod(pod)
            vol_dir = vh.volume_path("default/p", "cfg")
            assert first == 1 and os.path.islink(os.path.join(vol_dir, "ok"))
            with open(os.path.join(vol_dir, "ok")) as f:
                content = f.read()
            assert content == "fine"
            assert list(outside.iterdir()) == []
            assert not os.path.exists(os.path.join(str(root), "abs"))
            second = vh.sync_pod(pod)
            assert second == 0
            visible = sorted(n for n in os.listdir(vol_dir) if not n.startswith(".."))
            return first, content, second, visible
        finally:
            vh.teardown_all()

    both(scenario)


@pytest.mark.timeout(120)
def test_two_kubelets_share_a_manifest_dir(tmp_path):
    def scenario(P):
        mdir = tmp_path / P.name / "manifests"
        mdir.mkdir(parents=True)
        cs = P.Clientset(P.Store())
        ks = []
        for n in ("n1", "n2"):
            k = P.HollowKubelet(cs, n, pod_start_latency=0.0, clock=FakeClock(),
                                real_containers=True, static_pod_dir=str(mdir),
                                container_root=str(tmp_path / P.name / f"ctrs-{n}"))
            k.register()
            ks.append(k)
        (mdir / "cp.yaml").write_text(_manifest("cp", ["/bin/sleep", "1000"]))
        try:
            for _ in range(4):
                for k in ks:
                    k.tick()
            pids = {}
            for n in ("n1", "n2"):
                pod = cs.pods.get(f"cp-{n}", "default")
                assert (pod.status.phase, pod.spec.node_name) == ("Running", n)
                assert pod.meta.annotations["kubernetes.io/config.mirror"] == "true"
                pids[n] = _pid(pod)
                assert _alive(pids[n])
            assert pids["n1"] != pids["n2"]
            os.kill(pids["n1"], signal.SIGKILL)
            deadline = time.monotonic() + 10
            new_pid = None
            while time.monotonic() < deadline:
                for k in ks:
                    k.tick()
                pod = cs.pods.get("cp-n1", "default")
                if (pod.status.container_statuses[0].restart_count >= 1
                        and _pid(pod) != pids["n1"]):
                    new_pid = _pid(pod)
                    break
                time.sleep(0.05)
            assert new_pid is not None and _alive(new_pid)
            assert _pid(cs.pods.get("cp-n2", "default")) == pids["n2"] and _alive(pids["n2"])
            (mdir / "cp.yaml").unlink()
            for _ in range(3):
                for k in ks:
                    k.tick()
            gone = []
            for n in ("n1", "n2"):
                with pytest.raises(P.store_mod.NotFoundError):
                    cs.pods.get(f"cp-{n}", "default")
                gone.append(n)
            assert not _alive(new_pid) and not _alive(pids["n2"])
            return gone
        finally:
            _teardown(*ks)

    both(scenario)


@pytest.mark.timeout(120)
def test_adoption_races_a_relist_storm(tmp_path):
    def scenario(P):
        root = str(tmp_path / P.name / "containers")
        cs = P.Clientset(P.Store())
        k1 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(),
                             real_containers=True, container_root=root)
        k1.register()
        start(cs, k1, real_pod(P, "p", command=["/bin/sleep", "1000"]))
        pid1 = _pid(cs.pods.get("p", "default"))
        k2 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(),
                             real_containers=True, container_root=root)
        try:
            assert k2.containers.stats["adopted"] == 1
            os.kill(pid1, signal.SIGKILL)
            _wait_dead(pid1)
            for _ in range(12):
                k2.tick()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                k2.tick()
                pod = cs.pods.get("p", "default")
                st = pod.status.container_statuses[0]
                if st.restart_count >= 1 and _pid(pod) != pid1:
                    break
                time.sleep(0.05)
            pod = cs.pods.get("p", "default")
            count = pod.status.container_statuses[0].restart_count
            assert count <= 1
            pid2 = _pid(pod)
            assert pid2 != pid1 and _alive(pid2)
            for _ in range(8):
                k2.tick()
            pod = cs.pods.get("p", "default")
            assert pod.status.container_statuses[0].restart_count == count
            assert _pid(pod) == pid2
            return pod.status.phase, count <= 1
        finally:
            _teardown(k2, k1)

    both(scenario)


@pytest.mark.timeout(120)
def test_real_container_fleet_across_nodes(tmp_path):
    def scenario(P):
        import importlib

        Scheduler = importlib.import_module(f"{P.root}.scheduler").Scheduler
        cs = P.Clientset(P.Store())
        ks = []
        for i in range(3):
            k = P.HollowKubelet(cs, f"n{i}", pod_start_latency=0.0, clock=FakeClock(),
                                real_containers=True,
                                container_root=str(tmp_path / P.name / f"ctrs-{i}"))
            k.register()
            ks.append(k)
        sched = Scheduler(cs, emit_events=False)
        sched.start()
        for i in range(6):
            p = real_pod(P, f"w{i}", command=["/bin/sleep", "1000"])
            p.spec.node_name = ""
            cs.pods.create(p)
        sched.pump()
        assert sched.run_pending() == 6
        pids = {}
        try:
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and len(pids) < 6:
                for k in ks:
                    k.tick()
                for i in range(6):
                    pod = cs.pods.get(f"w{i}", "default")
                    if pod.status.phase == "Running" and pod.status.container_statuses:
                        pids[f"w{i}"] = (_pid(pod), pod.spec.node_name)
                time.sleep(0.02)
            assert len(pids) == 6
            by_node: dict = {}
            for _, (pid, node) in pids.items():
                assert _alive(pid)
                by_node.setdefault(node, []).append(pid)
            assert len(by_node) >= 2
            placement = sorted((name, node) for name, (_, node) in pids.items())
        finally:
            _teardown(*ks)
        for name, (pid, _) in pids.items():
            assert not _alive(pid), f"{name} leaked pid {pid}"
        return placement

    both(scenario)


@pytest.mark.timeout(60)
def test_kubectl_exec_reaches_a_real_process(tmp_path):
    twin("test_kubelet_real", "test_kubectl_exec_reaches_a_real_process", tmp_path,
         extra_volatile=["containerID"])
