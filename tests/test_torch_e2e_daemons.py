"""Twins of ``tests/test_e2e_daemons.py`` on the port: the daemon stack
over the wire (the apiserver, the scheduler on the batch backend with
``device="cpu"``, the controller manager and a hollow fleet) and the HA
controller-manager failover; and the controller-manager entry point as a
process.

The stack runs in each package (the JAX one on its own scheduler, as its
test runs it): in both, the ReplicaSet controller names the same pods, and
every pod is bound and Running.  The failover is the JAX test run through
both packages (``tests/torch_twin``): equal pods and specs after."""

from __future__ import annotations

import importlib
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from tests.torch_kubelet_pkg import pkg
from tests.torch_twin import ROOTS, _reset_counters, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PODS = 300
N_NODES = 10


def _mod(which, name):
    return importlib.import_module(f"{ROOTS[which]}.{name}")


def _replicaset(P, name, replicas):
    api = P.api
    return api.ReplicaSet(
        meta=api.ObjectMeta(name=name, namespace="default"), replicas=replicas,
        selector=api.LabelSelector.from_match_labels({"app": name}),
        template=api.PodTemplateSpec(labels={"app": name}, spec=api.PodSpec(containers=[
            api.Container(name="c", resources=api.ResourceRequirements(
                requests={"cpu": api.Quantity("50m")}))])))


def _stack(which):
    """One ReplicaSet of ``N_PODS`` through the controller plane, over the
    wire.  Returns the sorted pod names and the count bound and Running."""
    P = pkg(which)
    _reset_counters(which)
    RemoteStore = _mod(which, "client.remote").RemoteStore
    server = _mod(which, "apiserver").APIServer(P.Store(event_log_window=50_000))
    server.start()
    stop = threading.Event()
    threads = []
    mgr = sched = None
    try:
        sched_cs = P.Clientset(RemoteStore(server.url))
        sched_mod = _mod(which, "scheduler")
        algo = sched_mod.GenericScheduler()
        if which == "port":
            backend = _mod(which, "ops.backend").BatchBackend(algorithm=algo, device="cpu")
            sched = sched_mod.Scheduler(sched_cs, algorithm=algo, backend=backend,
                                        emit_events=False)
            sched.start(manual=False)
            loop = lambda: sched.run_batch_loop(min_batch=1, max_wait=0.05,  # noqa: E731
                                                stop=stop)
        else:
            sched = sched_mod.Scheduler(sched_cs, algorithm=algo, emit_events=False)
            sched.start(manual=False)

            def loop():
                while not stop.is_set():
                    sched.schedule_one(timeout=0.05, async_bind=False)
        threads.append(threading.Thread(target=loop, daemon=True))
        threads[-1].start()

        mgr = _mod(which, "controllers.manager").ControllerManager(
            P.Clientset(RemoteStore(server.url)), enabled=["replicaset"])
        mgr.start(manual=False, workers_per_controller=2)
        fleet = P.HollowFleet(P.Clientset(RemoteStore(server.url)), N_NODES, cpu="64",
                              memory="128Gi", pods=200, pod_start_latency=0.0)
        fleet.register_all()
        cli = P.Clientset(RemoteStore(server.url))
        cli.replicasets.create(_replicaset(P, "web", N_PODS))
        deadline = time.time() + 40
        while time.time() < deadline:
            fleet.tick_all()
            pods, _ = cli.pods.list()
            if (len(pods) >= N_PODS and all(p.spec.node_name for p in pods)
                    and all(p.status.phase == "Running" for p in pods)):
                break
            time.sleep(0.1)
        pods, _ = cli.pods.list()
        return (sorted(p.meta.name for p in pods),
                sum(1 for p in pods if p.spec.node_name),
                sum(1 for p in pods if p.status.phase == "Running"))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        if mgr is not None:
            mgr.stop()
        if sched is not None:
            sched.informers.stop_all()
        server.stop()


@pytest.mark.timeout(110)
def test_daemon_stack_binds_a_replicaset_over_the_wire():
    jax_out = _stack("jax")
    port_out = _stack("port")
    assert port_out == jax_out
    names, bound, running = port_out
    assert len(names) == N_PODS and bound == N_PODS and running == N_PODS
    assert names[0] == "web-000001" and names[-1] == f"web-{N_PODS:06d}"


@pytest.mark.timeout(60)
def test_ha_controller_manager_failover(tmp_path):
    """The JAX test through both packages.  Its managers pump watches that
    arrive over HTTP, so a status the last pump saw is a matter of timing:
    the stores are held equal in their pods and in every object's spec."""
    def objects(which):
        (store,) = run("test_e2e_daemons", "test_ha_controller_manager_failover", which,
                       tmp_path)
        return {kind: {key: (obj.get("metadata", {}).get("ownerReferences"), obj.get("spec"))
                       for key, obj in items.items()}
                for kind, items in store.items()}

    jax_objects = objects("jax")
    assert objects("port") == jax_objects
    assert len(jax_objects["Pod"]) == 70


@pytest.mark.timeout(60)
def test_controller_manager_entry_rolls_out_a_deployment():
    """``python -m kubernetes_tpu_torch controller-manager --leader-elect``
    against the port's apiserver: a Deployment gets its ReplicaSet (named
    by the JAX template hash) and its pods; SIGTERM ends it with exit 0."""
    P = pkg("port")
    server = _mod("port", "apiserver").APIServer(P.Store())
    server.start()
    proc = None
    try:
        env = {**os.environ, "PYTHONPATH": ROOT}
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch", "controller-manager",
             "--apiserver", server.url, "--leader-elect", "--node-monitor-period", "1"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        cs = P.Clientset(_mod("port", "client.remote").RemoteStore(server.url))
        api = P.api
        template = api.PodTemplateSpec(labels={"app": "web"},
                                       spec=api.PodSpec(containers=[api.Container(name="c")]))
        cs.deployments.create(api.Deployment(
            meta=api.ObjectMeta(name="web", namespace="default"), replicas=3,
            selector=api.LabelSelector.from_match_labels({"app": "web"}), template=template))
        h = _mod("port", "controllers.deployment").template_hash(template)
        jax_api = importlib.import_module("kubernetes_tpu.api")
        jax_template = jax_api.PodTemplateSpec.from_dict(template.to_dict())
        assert h == importlib.import_module(
            "kubernetes_tpu.controllers.deployment").template_hash(jax_template)
        deadline = time.time() + 30
        while time.time() < deadline:
            pods, _ = cs.pods.list()
            if len(pods) == 3:
                break
            time.sleep(0.2)
        assert len(pods) == 3, proc.poll()
        rs = cs.replicasets.get(f"web-{h}", "default")
        assert rs.replicas == 3
        assert all(p.meta.controller_ref().name == f"web-{h}" for p in pods)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
        assert proc.returncode == 0, out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
