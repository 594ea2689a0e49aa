"""The port's daemon path on the CPU: leader election, the informer's gap
relist, the daemon stack against the JAX package's, HA failover over the
wire, and the two entry points as real processes.

- Leader election: twins of ``tests/test_policy_extender_leader.py``
  :153-200 on the port's ``LeaderElector``.
- Daemon-stack parity: the same seeded 60-node x 400-pod ``mixed``
  cluster, every pod created over the wire before the scheduler starts,
  served by one ``run_batch_loop(max_waves=1)`` of the JAX ``Scheduler`` +
  ``TPUBatchBackend`` against the JAX ``APIServer`` and of the port's
  ``Scheduler`` + ``BatchBackend(device="cpu")`` against the port's
  ``APIServer``.  Tolerance: exact; the binding maps and round-robin
  counters equal each other and the port's sequential oracle.
- A smaller twin of ``tests/test_e2e_daemons.py``
  ``test_ha_scheduler_failover_mid_flood``: no pod is bound twice.
- ``python -m kubernetes_tpu_torch.apiserver`` and ``python -m
  kubernetes_tpu_torch.scheduler --device cpu`` as processes: health,
  metrics, a 200-pod flood through ``workload.run_wire_churn``, exit 0 on
  SIGTERM with the stats line; and the refusals (no
  ``--disable-admission``; ``--device cuda`` without a card).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.apiserver import APIServer
from kubernetes_tpu_torch.client import (
    Clientset,
    Handler,
    LeaderElector,
    RemoteStore,
    SharedInformer,
)
from kubernetes_tpu_torch.daemon import run_with_leader_election
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
from kubernetes_tpu_torch.store import WATCH_GAP, Store, WatchEvent
from kubernetes_tpu_torch.testutil import make_node, make_pod
from kubernetes_tpu_torch.utils.features import (
    FeatureGates,
    SchedulerConfiguration,
    load_component_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


# -- leader election (tests/test_policy_extender_leader.py:153-200) ---------


def test_leader_election_single_holder():
    cs = Clientset(Store())
    clock = FakeClock()
    a = LeaderElector(cs, "scheduler", "instance-a", clock=clock)
    b = LeaderElector(cs, "scheduler", "instance-b", clock=clock)
    assert a.try_acquire_or_renew() is True
    assert b.try_acquire_or_renew() is False
    clock.now += 5  # a renews within the lease; b is still locked out
    assert a.try_acquire_or_renew() is True
    assert b.try_acquire_or_renew() is False


def test_leader_failover_on_stale_lease():
    cs = Clientset(Store())
    clock = FakeClock()
    a = LeaderElector(cs, "scheduler", "instance-a", lease_duration=15, clock=clock)
    b = LeaderElector(cs, "scheduler", "instance-b", lease_duration=15, clock=clock)
    assert a.try_acquire_or_renew()
    clock.now += 20  # a dies silently; the lease goes stale
    assert b.try_acquire_or_renew() is True
    assert b.is_leader
    clock.now += 1  # a comes back, but the lease is b's now
    assert a.try_acquire_or_renew() is False


def test_leader_release():
    cs = Clientset(Store())
    clock = FakeClock()
    a = LeaderElector(cs, "cm", "a", clock=clock)
    b = LeaderElector(cs, "cm", "b", clock=clock)
    assert a.try_acquire_or_renew()
    a.release()
    assert not a.is_leader
    assert b.try_acquire_or_renew() is True


@pytest.mark.timeout(60)
def test_leader_race_many_candidates():
    cs = Clientset(Store())
    clock = FakeClock()
    electors = [LeaderElector(cs, "x", f"i{i}", clock=clock) for i in range(8)]
    results = []
    threads = [threading.Thread(target=lambda e=e: results.append(e.try_acquire_or_renew()))
               for e in electors]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sum(results) == 1, "exactly one leader"


@pytest.mark.timeout(60)
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_payload_death_releases_the_lease_and_reports_failure():
    cs = Clientset(Store())

    def payload(stop):
        raise RuntimeError("payload crashed")

    ok = run_with_leader_election(cs, "kube-scheduler", "a", payload, threading.Event())
    assert ok is False
    # released: a standby takes the lease at once, with no stale wait
    assert LeaderElector(cs, "kube-scheduler", "b").try_acquire_or_renew()


# -- the informer's gap relist ----------------------------------------------


def test_informer_relists_on_a_gap_event():
    """A ``WATCH_GAP`` event (the transport lost continuity) makes the
    informer relist: it catches up on writes its stream never delivered
    and hands them to its handlers."""
    cs = Clientset(Store())
    cs.pods.create(make_pod("a"))
    inf = SharedInformer(cs.pods)
    added = []
    inf.add_handler(Handler(on_add=lambda p: added.append(p.meta.name)))
    inf.start_manual()
    lost = inf._watch
    lost.stop()  # the stream breaks: the writes below never reach it

    class GapOnce:
        def __init__(self):
            self.events = [WatchEvent(WATCH_GAP, "", "", inf.last_revision, {})]

        def get(self, timeout=None):
            return self.events.pop() if self.events else None

        def stop(self):
            pass

    inf._watch = GapOnce()
    cs.pods.create(make_pod("b"))
    cs.pods.create(make_pod("c"))
    inf.pump()
    assert sorted(inf.keys()) == ["default/a", "default/b", "default/c"]
    assert inf.stats["relists"] == 1 and added == ["a", "b", "c"]
    cs.pods.create(make_pod("d"))  # the relist's new watch is live
    inf.pump()
    assert "default/d" in inf.keys()
    inf.stop()


# -- daemon-stack parity ----------------------------------------------------

STACK = dict(n_nodes=60, total_pods=400, workload="mixed", seed=11)


def _precreate(url: str) -> list[str]:
    """The seeded cluster and every pod, created over the wire through the
    port's client (the wire form is the same for both packages)."""
    cs = Clientset(RemoteStore(url, timeout=60.0))
    pods = workload.create_cluster(cs, STACK["n_nodes"], STACK["total_pods"],
                                   STACK["workload"], STACK["seed"])
    assert all(d is not None for d in cs.pods.create_many(pods))
    return [p.meta.key for p in pods]


def _bindings(url: str) -> dict:
    items, _ = RemoteStore(url).list("Pod")
    return {f"{d['metadata']['namespace']}/{d['metadata']['name']}":
            (d.get("spec") or {}).get("nodeName") or None for d in items}


def _serve_one_wave(sched) -> None:
    sched.start()
    try:
        sched.run_batch_loop(min_batch=STACK["total_pods"], max_wait=5.0, max_waves=1,
                             poll_interval=0.002)
    finally:
        sched.informers.stop_all()


def _sequential_oracle() -> tuple[dict, int]:
    """The port's per-pod oracle on an in-process copy of the cluster: all
    pods exist before it starts, so its queue order is the LIST order the
    daemons drain in."""
    cs, pods = workload._churn_cluster(STACK["n_nodes"], STACK["total_pods"],
                                       STACK["workload"], STACK["seed"])
    cs.pods.create_many(pods)
    sched = Scheduler(cs, algorithm=GenericScheduler(), backend=None, emit_events=False)
    sched.start()
    sched.run_pending()
    return ({p.meta.key: p.spec.node_name or None for p in cs.pods.list()[0]},
            sched.algorithm._round_robin)


@pytest.mark.timeout(600)
def test_daemon_stack_parity_jax_stack_port_stack_and_oracle():
    from kubernetes_tpu.apiserver import APIServer as JaxAPIServer
    from kubernetes_tpu.client import Clientset as JaxClientset
    from kubernetes_tpu.client.remote import RemoteStore as JaxRemoteStore
    from kubernetes_tpu.ops import TPUBatchBackend
    from kubernetes_tpu.scheduler import GenericScheduler as JaxGeneric
    from kubernetes_tpu.scheduler import Scheduler as JaxScheduler
    from kubernetes_tpu.store import Store as JaxStore

    jax_server = JaxAPIServer(JaxStore())
    port_server = APIServer(Store())
    jax_server.start()
    port_server.start()
    try:
        keys = _precreate(jax_server.url)
        assert _precreate(port_server.url) == keys

        jalgo = JaxGeneric()
        _serve_one_wave(JaxScheduler(
            JaxClientset(JaxRemoteStore(jax_server.url)), algorithm=jalgo,
            backend=TPUBatchBackend(algorithm=jalgo, kernel_impl="xla"),
            enable_preemption=False))
        want = _bindings(jax_server.url)

        algo = GenericScheduler()
        backend = BatchBackend(algorithm=algo, device="cpu")
        _serve_one_wave(Scheduler(Clientset(RemoteStore(port_server.url)), algorithm=algo,
                                  backend=backend))
        got = _bindings(port_server.url)
    finally:
        jax_server.stop()
        port_server.stop()
    oracle, oracle_rr = _sequential_oracle()
    assert set(got) == set(keys) and sum(1 for n in got.values() if n) > 0
    assert got == want == oracle
    assert algo._round_robin == jalgo._round_robin == oracle_rr
    assert backend.stats["segments"] == 1 and backend.stats["oracle_pods"] == 0


# -- HA failover over the wire (tests/test_e2e_daemons.py:171) --------------


@pytest.mark.timeout(120)
def test_ha_scheduler_failover_mid_flood_binds_each_pod_once():
    n_nodes, n_pods = 10, 300
    server = APIServer(Store(event_log_window=100_000))
    server.start()
    daemons = []
    try:
        seed = Clientset(RemoteStore(server.url))
        seed.nodes.create_many([make_node(f"ha-n{i:02d}", cpu="64", memory="128Gi", pods=200,
                                          labels={"kubernetes.io/hostname": f"ha-n{i:02d}"})
                                for i in range(n_nodes)])
        seed.pods.create_many([make_pod(f"ha-p{i:04d}", cpu="50m", memory="64Mi",
                                        labels={"app": "ha"}) for i in range(n_pods)])
        fake_now = [time.time()]
        binds = {"sched-a": 0, "sched-b": 0}
        conflicts = {"sched-a": 0, "sched-b": 0}

        def make_daemon(ident):
            cs = Clientset(RemoteStore(server.url))
            elector = LeaderElector(cs, "kube-scheduler-ha", ident, lease_duration=2.0,
                                    renew_deadline=1.5, clock=lambda: fake_now[0])
            sched = Scheduler(cs, algorithm=GenericScheduler(), emit_events=False)
            orig_bind = sched._bind

            def counting_bind(pod, node_name):
                ok = orig_bind(pod, node_name)
                (binds if ok else conflicts)[ident] += 1
                return ok

            sched._bind = counting_bind
            sched.start(manual=False)  # threaded informers: the standby stays warm
            stop = threading.Event()

            def loop():
                is_leader, next_renew = False, 0.0
                while not stop.is_set():
                    now = time.time()
                    if not is_leader or now >= next_renew:
                        is_leader = elector.try_acquire_or_renew()
                        next_renew = now + 0.5
                    if not is_leader:
                        time.sleep(0.02)
                        continue
                    sched.schedule_one(timeout=0.02)

            t = threading.Thread(target=loop, daemon=True)
            daemons.append((sched, stop, t))
            return elector, stop, t

        el_a, stop_a, t_a = make_daemon("sched-a")
        el_b, stop_b, t_b = make_daemon("sched-b")
        t_a.start()
        deadline = time.time() + 10
        while time.time() < deadline and not el_a.is_leader:
            time.sleep(0.02)
        assert el_a.is_leader
        t_b.start()

        deadline = time.time() + 30  # phase 1: A makes progress mid-flood
        while time.time() < deadline and binds["sched-a"] < 100:
            fake_now[0] = time.time()
            time.sleep(0.05)
        assert binds["sched-a"] >= 100 and binds["sched-b"] == 0

        stop_a.set()  # phase 2: A crashes holding the lease, which must expire
        t_a.join(timeout=5)
        crash_at = time.time()
        fake_now[0] = crash_at
        assert not el_b.try_acquire_or_renew()
        fake_now[0] = crash_at + 3.0

        deadline = time.time() + 60  # phase 3: B takes over and drains the rest
        bound = 0
        while time.time() < deadline:
            fake_now[0] += 0.05
            bound = sum(1 for n in _bindings(server.url).values() if n)
            if bound >= n_pods:
                break
            time.sleep(0.05)
        stop_b.set()
        t_b.join(timeout=5)
        assert bound == n_pods and el_b.is_leader and binds["sched-b"] > 0
        # the store's CAS fails a second bind, so the sum reaches n_pods
        # only if no pod was bound twice
        assert binds["sched-a"] + binds["sched-b"] == n_pods
        assert conflicts["sched-b"] <= 5
    finally:
        for sched, stop, t in daemons:
            stop.set()
            t.join(timeout=5)
            sched.stop()
        server.stop()


# -- the entry points as processes ------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
            **extra}


def _wait_healthz(port: int, proc: subprocess.Popen, deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while True:
        assert proc.poll() is None, f"process exited early with {proc.returncode}"
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=1) as r:
                assert json.loads(r.read())["status"] == "ok"
            return
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def _terminate(proc: subprocess.Popen) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise


@pytest.mark.timeout(180)
def test_daemon_processes_serve_a_flood_and_exit_cleanly(tmp_path):
    ap, hp = _free_port(), _free_port()
    url = f"http://127.0.0.1:{ap}"
    procs = []
    try:
        apiserver = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.apiserver", "--port", str(ap),
             "--disable-admission"], env=_env(), cwd=tmp_path,
            stdout=open(tmp_path / "apiserver.out", "w"), stderr=subprocess.STDOUT)
        procs.append(apiserver)
        _wait_healthz(ap, apiserver)
        sched_out = tmp_path / "scheduler.out"
        scheduler = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.scheduler", "--apiserver", url,
             "--leader-elect", "--device", "cpu", "--backend", "batch",
             "--healthz-port", str(hp)], env=_env(), cwd=tmp_path,
            stdout=open(sched_out, "w"), stderr=open(tmp_path / "scheduler.err", "w"))
        procs.append(scheduler)
        _wait_healthz(hp, scheduler)

        r = workload.run_wire_churn(url, 40, 200, 2, "mixed", seed=4, wave_deadline_s=60)
        assert r["bound"] == 200 and r["unbound"] == 0 and len(r["wave_s"]) == 2
        assert r["create_to_bind_ms"]["p50"] <= r["create_to_bind_ms"]["p99"]
        with urllib.request.urlopen(f"http://127.0.0.1:{hp}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "scheduler_e2e_scheduling_latency_microseconds_count 200" in text

        assert _terminate(scheduler) == 0
        lines = [json.loads(line) for line in sched_out.read_text().splitlines()
                 if line.startswith('{"scheduler_stats"')]
        assert len(lines) == 1
        stats = lines[0]["scheduler_stats"]
        assert stats["bound"] == 200 and stats["oracle_pods"] == 0
        assert stats["kernel_pods"] == stats["drained"] >= 200
        assert stats["launches"] == 0  # the CPU runs the plain scan, never the kernel
        assert _terminate(apiserver) == 0
        assert "apiserver serving on http://" in (tmp_path / "apiserver.out").read_text()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.timeout(120)
def test_entry_points_refuse_without_admission_or_card(tmp_path):
    """The apiserver never serves as if admitted; the scheduler with its
    default ``--device cuda`` exits before it takes the lease where there
    is no card (hidden from it here on any host)."""
    out = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.apiserver", "--port",
                          str(_free_port())], env=_env(), cwd=tmp_path, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode != 0 and "ROADMAP.md" in out.stderr and "--disable-admission" in out.stderr
    server = APIServer(Store())
    server.start()
    try:
        out = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
                              "--apiserver", server.url, "--leader-elect"],
                             env=_env(CUDA_VISIBLE_DEVICES=""), cwd=tmp_path,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert server.store.list("Event")[0] == []  # no lease was taken
    finally:
        server.stop()


@pytest.mark.timeout(120)
def test_apiserver_entry_imports_no_torch():
    code = ("import sys, kubernetes_tpu_torch.apiserver.__main__\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_hyperkube_multiplexer():
    from kubernetes_tpu_torch.__main__ import COMPONENTS, main

    assert set(COMPONENTS) == {"apiserver", "kube-apiserver", "scheduler", "kube-scheduler"}
    assert main(["--help"]) == 0 and main([]) == 2 and main(["kubelet"]) == 2
    assert main(["apiserver", "--port", "0"]) == 2  # no --disable-admission


# -- feature gates and component config -------------------------------------


def test_feature_gates_and_config_layering(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.scheduler import __main__ as sched_main
    from kubernetes_tpu_torch.utils import features

    gates = FeatureGates()
    assert gates.enabled("PodPriority") and gates.enabled("BatchScheduling")
    gates.set_from_string("BatchScheduling=false, PodPriority=true")
    assert not gates.enabled("BatchScheduling")
    with pytest.raises(KeyError):
        gates.set_from_string("PallasKernels=true")  # the port has no Pallas gates
    with pytest.raises(ValueError):
        gates.set_from_string("PodPriority=maybe")

    cfg = tmp_path / "sched.json"
    cfg.write_text(json.dumps({"backend": "oracle", "batch_interval": 0.2,
                               "leader_elect": True}))
    assert load_component_config(SchedulerConfiguration, str(cfg)).backend == "oracle"
    monkeypatch.setattr(features, "DEFAULT_FEATURE_GATES", FeatureGates())
    monkeypatch.setattr(sched_main, "DEFAULT_FEATURE_GATES", features.DEFAULT_FEATURE_GATES)
    args = sched_main._parse(["--apiserver", "http://127.0.0.1:1", "--config", str(cfg),
                              "--batch-interval", "0.5"])
    # flag > file > default
    assert (args.backend, args.batch_interval, args.leader_elect,
            args.scheduler_name) == ("oracle", 0.5, True, "default-scheduler")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"policy_config_file": "p.json"}))
    with pytest.raises(ValueError, match="unknown config keys"):
        load_component_config(SchedulerConfiguration, str(bad))
    with pytest.raises(SystemExit):
        sched_main._parse(["--apiserver", "http://127.0.0.1:1", "--feature-gates",
                           "BatchScheduling=false"])
