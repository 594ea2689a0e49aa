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
- Daemon-stack preemption: both stacks at their defaults over the wire;
  a priority pod that binds only after an eviction evicts the same victim
  and binds alike.
- A smaller twin of ``tests/test_e2e_daemons.py``
  ``test_ha_scheduler_failover_mid_flood``: no pod is bound twice.
- ``python -m kubernetes_tpu_torch.apiserver`` and ``python -m
  kubernetes_tpu_torch.scheduler --device cpu`` as processes: health,
  metrics, a 200-pod flood through ``workload.run_wire_churn``, exit 0 on
  SIGTERM with the stats line; and the refusals (an auth or TLS flag;
  ``--device cuda`` without a card).
- The JAX daemon's configuration (``backend: "tpu"``,
  ``policy_config_file``, ``--policy-config-file``) loads, and the oracle
  loop binds asynchronously on a preempting ``Scheduler``.
"""

from __future__ import annotations

import json
import logging
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
from kubernetes_tpu_torch.client.remote import ForbiddenError
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


@pytest.mark.timeout(60)
def test_an_apiserver_outage_shorter_than_the_renew_deadline_keeps_the_lease(monkeypatch):
    """The holder's renewal meets an apiserver that is down: the round
    fails without raising (the JAX elector raises there and its daemon
    dies), the holder retries, and an outage shorter than the renew
    deadline leaves the payload running; a longer one loses the lease,
    the payload stops, and the daemon takes the lease again once the
    apiserver is back."""
    from kubernetes_tpu_torch import daemon

    class QuickElector(LeaderElector):
        def __init__(self, *a, **kw):
            super().__init__(*a, lease_duration=3.0, renew_deadline=1.5, **kw)

    monkeypatch.setattr(daemon, "LeaderElector", QuickElector)
    monkeypatch.setattr(daemon, "_ACQUIRE_RETRY_S", 0.1)
    store = Store()
    server = APIServer(store)
    server.start()
    port = server.port
    cs = Clientset(RemoteStore(server.url, timeout=2.0, max_retries=0))
    down = RemoteStore(server.url, timeout=2.0, max_retries=0)
    starts, stop = [], threading.Event()

    def payload(payload_stop):
        starts.append(time.monotonic())
        payload_stop.wait()

    t = threading.Thread(target=run_with_leader_election,
                         args=(cs, "kube-scheduler", "me", payload, stop), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while not starts and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(starts) == 1
        server.stop()
        # a round against the stopped server fails without raising
        assert LeaderElector(Clientset(down), "kube-scheduler", "other").try_acquire_or_renew() \
            is False
        time.sleep(0.9)  # within the 1.5 s deadline
        server = APIServer(store, port=port)
        server.start()
        time.sleep(1.5)  # renewals succeed again
        assert len(starts) == 1, "a short outage restarted the payload"
        server.stop()
        time.sleep(2.5)  # past the deadline: the lease is lost
        server = APIServer(store, port=port)
        server.start()
        deadline = time.monotonic() + 15
        while len(starts) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(starts) == 2, "the daemon did not take the lease back"
    finally:
        stop.set()
        t.join(timeout=20)
        server.stop()
    assert not t.is_alive()


def _scaled_lease(monkeypatch):
    """The reference's lease timing (lease 15 s, renew deadline 10 s, retry
    period 2 s) and the holder's 0.2 s poll, all scaled down tenfold."""
    from kubernetes_tpu_torch import daemon

    class ScaledElector(LeaderElector):
        def __init__(self, *a, **kw):
            super().__init__(*a, lease_duration=1.5, renew_deadline=1.0, **kw)

    monkeypatch.setattr(daemon, "LeaderElector", ScaledElector)
    monkeypatch.setattr(daemon, "_ACQUIRE_RETRY_S", 0.2)
    monkeypatch.setattr(daemon, "_LIVENESS_POLL_S", 0.02)
    return daemon


def _hang(port: int) -> socket.socket:
    """A listener on ``port`` that takes connections and never answers: an
    apiserver hung mid-restart, on which each of the holder's requests
    waits out its timeout and retries."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", port))
    sock.listen(64)
    return sock


def _lease_expiry(store: Store, lock_name: str) -> float:
    from kubernetes_tpu_torch.client.leaderelection import LEASE_ANNOTATION

    ev = [e for e in store.list("Event")[0] if e["metadata"]["name"] == lock_name][0]
    rec = json.loads(ev["metadata"]["annotations"][LEASE_ANNOTATION])
    return rec["renewTime"] + rec["leaseDurationSeconds"]


@pytest.mark.timeout(60)
def test_a_hung_apiserver_stops_the_payload_before_a_standby_can_take_the_lease(
        monkeypatch):
    """At the reference's proportions the holder's renewals hang in the
    client's retries (each call outlasts the renew deadline).  The renew
    deadline counts from the last renewal that succeeded (plus one retry
    period, as in the reference), not from a failed call's return, so the
    payload has stopped before the lease it last wrote expires, and so
    before a standby (reaching the store another way) takes it."""
    _scaled_lease(monkeypatch)
    store = Store()
    server = APIServer(store)
    server.start()
    port = server.port
    # a hung request takes 3 x 0.5 s: longer than the 1.0 s deadline
    cs = Clientset(RemoteStore(server.url, timeout=0.5, max_retries=2))
    events, stop = {}, threading.Event()

    def payload(payload_stop):
        events["start"] = time.time()
        while not payload_stop.is_set():  # binding, as far as the lease goes
            events["last_work"] = time.time()
            time.sleep(0.005)
        events["end"] = time.time()

    t = threading.Thread(target=run_with_leader_election,
                         args=(cs, "kube-scheduler", "holder", payload, stop), daemon=True)
    t.start()
    hung = None
    try:
        deadline = time.monotonic() + 10
        while "start" not in events and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "start" in events
        time.sleep(0.5)  # a few renewals
        server.stop()
        hung = _hang(port)
        standby = LeaderElector(Clientset(store), "kube-scheduler", "standby",
                                lease_duration=1.5, renew_deadline=1.0)
        deadline = time.monotonic() + 10
        while not standby.try_acquire_or_renew() and time.monotonic() < deadline:
            time.sleep(0.005)
        taken = time.time()
        assert standby.is_leader
        assert "end" in events, "the payload still runs beside the new holder"
        assert events["last_work"] < events["end"] < taken
    finally:
        stop.set()
        if hung is not None:
            hung.close()
        t.join(timeout=20)
    assert not t.is_alive()


@pytest.mark.timeout(60)
def test_a_payload_that_ignores_its_stop_is_fenced_before_the_lease_expires(monkeypatch):
    """A payload still running when its lease is lost must not outlive the
    lease: the holder ends the process before the expiry (the fence is
    recorded here instead of exiting)."""
    daemon = _scaled_lease(monkeypatch)
    fenced = []

    class Fenced(Exception):
        pass

    def fence(lock_name):
        fenced.append(time.time())
        release.set()
        raise Fenced(lock_name)

    monkeypatch.setattr(daemon, "_fence_exit", fence)
    store = Store()
    server = APIServer(store)
    server.start()
    cs = Clientset(RemoteStore(server.url, timeout=0.5, max_retries=0))
    started, release, raised = threading.Event(), threading.Event(), []

    def payload(payload_stop):
        started.set()
        release.wait(30)  # deaf to payload_stop

    def hold():
        try:
            run_with_leader_election(cs, "kube-scheduler", "holder", payload,
                                     threading.Event())
        except Fenced as e:
            raised.append(e)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    try:
        assert started.wait(10)
        time.sleep(0.5)
    finally:
        server.stop()
    try:
        t.join(timeout=10)
        assert not t.is_alive() and raised, "the holder was not fenced"
        assert fenced[0] < _lease_expiry(store, "kube-scheduler")
    finally:
        release.set()


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


PREEMPT_NODES, PREEMPT_FILLERS = 3, 6


def _preempt_precreate(url: str) -> None:
    """Three 2-CPU nodes and six 1-CPU fillers at priorities 0, 1 and 2,
    created over the wire before the scheduler starts."""
    cs = Clientset(RemoteStore(url, timeout=60.0))
    assert all(d is not None for d in cs.nodes.create_many([
        make_node(f"pn{i}", cpu="2", labels={"kubernetes.io/hostname": f"pn{i}"})
        for i in range(PREEMPT_NODES)]))
    fillers = []
    for i in range(PREEMPT_FILLERS):
        p = make_pod(f"filler-{i}", cpu="1")
        p.spec.priority = i % 3
        fillers.append(p)
    assert all(d is not None for d in cs.pods.create_many(fillers))


def _serve_preemption(sched, url: str) -> None:
    """The fillers in one wave; then a priority-100 pod that fits nowhere,
    created over the wire: its wave fails and the cohort pass evicts; once
    the scheduler's informers saw the eviction, the next wave binds it."""
    sched.start()
    try:
        sched.run_batch_loop(min_batch=PREEMPT_FILLERS, max_wait=5.0, max_waves=1,
                             poll_interval=0.002)
        vip = make_pod("vip", cpu="1")
        vip.spec.priority = 100
        Clientset(RemoteStore(url)).pods.create(vip)
        sched.run_batch_loop(min_batch=1, max_wait=5.0, max_waves=1, poll_interval=0.002)
        pods = sched.informers.informer("Pod")
        deadline = time.monotonic() + 30
        while len(pods.list()) != PREEMPT_FILLERS and time.monotonic() < deadline:
            sched.pump()
            time.sleep(0.02)
        assert len(pods.list()) == PREEMPT_FILLERS  # one victim gone, the vip in
        sched.run_batch_loop(min_batch=1, max_wait=5.0, max_waves=1, poll_interval=0.002)
    finally:
        sched.informers.stop_all()


@pytest.mark.timeout(300)
def test_daemon_stack_preemption_jax_stack_and_port_stack_at_defaults():
    """Both stacks at their defaults (preemption on): the same victim is
    evicted and the priority pod and every survivor bind alike."""
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
        _preempt_precreate(jax_server.url)
        _preempt_precreate(port_server.url)
        jalgo = JaxGeneric()
        jsched = JaxScheduler(JaxClientset(JaxRemoteStore(jax_server.url)), algorithm=jalgo,
                              backend=TPUBatchBackend(algorithm=jalgo, kernel_impl="xla"))
        _serve_preemption(jsched, jax_server.url)
        want = _bindings(jax_server.url)

        algo = GenericScheduler()
        sched = Scheduler(Clientset(RemoteStore(port_server.url)), algorithm=algo,
                          backend=BatchBackend(algorithm=algo, device="cpu"))
        assert sched.enable_preemption
        _serve_preemption(sched, port_server.url)
        got = _bindings(port_server.url)
    finally:
        jax_server.stop()
        port_server.stop()
    assert got == want and got["default/vip"] and all(got.values())
    evicted = {f"default/filler-{i}" for i in range(PREEMPT_FILLERS)} - set(got)
    assert len(evicted) == 1 and evicted == {f"default/filler-{i}"
                                             for i in range(PREEMPT_FILLERS)} - set(want)
    assert sched.metrics.preemption_victims.value == jsched.metrics.preemption_victims.value == 1
    assert algo._round_robin == jalgo._round_robin


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
        # the ingest seconds its drains observed, by the /metrics sums
        sums = {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                if ln.startswith(("scheduler_ingest_parse_seconds_sum",
                                  "scheduler_ingest_decode_seconds_sum"))}

        assert _terminate(scheduler) == 0
        lines = [json.loads(line) for line in sched_out.read_text().splitlines()
                 if line.startswith('{"scheduler_stats"')]
        assert len(lines) == 1
        stats = lines[0]["scheduler_stats"]
        assert stats["bound"] == 200 and stats["oracle_pods"] == 0
        assert stats["kernel_pods"] == stats["drained"] >= 200
        assert stats["launches"] == 0  # the CPU runs the plain scan, never the kernel
        # the watch readers parsed the frames before the informers wrapped
        # them; the drains observed part of each total, never more
        assert stats["ingest_lazy"] and stats["ingest_frames"] > 0
        assert 0 < sums["scheduler_ingest_parse_seconds_sum"] <= stats["ingest_parse_s"] + 1e-9
        assert 0 < sums["scheduler_ingest_decode_seconds_sum"] <= stats["ingest_decode_s"] + 1e-9
        assert _terminate(apiserver) == 0
        assert "apiserver serving on http://" in (tmp_path / "apiserver.out").read_text()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def _metric(text: str, name: str) -> float:
    return sum(float(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith(name) and not ln.startswith("#"))


@pytest.mark.timeout(240)
def test_durable_admitted_apiserver_survives_a_sigkill_under_the_daemon(tmp_path):
    """The apiserver at its defaults (the admission chain on) with
    ``--data-dir``: SIGKILLed while a wave is being bound and restarted on
    the same port and directory, it reads back every bind the LIST before
    the kill saw acknowledged; the scheduler daemon (not restarted)
    reconnects or relists and binds the rest, each pod once, no node over
    its capacity."""
    ap, hp = _free_port(), _free_port()
    url = f"http://127.0.0.1:{ap}"
    data = tmp_path / "data"
    procs = []

    def start_apiserver(tag):
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.apiserver", "--port", str(ap),
             "--data-dir", str(data)], env=_env(), cwd=tmp_path,
            stdout=open(tmp_path / f"apiserver-{tag}.out", "w"), stderr=subprocess.STDOUT)
        procs.append(proc)
        _wait_healthz(ap, proc)
        return proc

    try:
        apiserver = start_apiserver("first")
        scheduler = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.scheduler", "--apiserver", url,
             "--leader-elect", "--device", "cpu", "--healthz-port", str(hp)], env=_env(),
            cwd=tmp_path, stdout=open(tmp_path / "scheduler.out", "w"),
            stderr=open(tmp_path / "scheduler.err", "w"))
        procs.append(scheduler)
        _wait_healthz(hp, scheduler)
        rs = RemoteStore(url, timeout=30.0)
        # admission is on: a pod in a missing namespace is refused
        with pytest.raises(ForbiddenError):
            rs.create("Pod", make_pod("lost", namespace="nowhere").to_dict())

        def drill():
            nonlocal apiserver
            acked = {p["metadata"]["name"]: p["spec"].get("nodeName")
                     for p in rs.list("Pod")[0]}
            apiserver.send_signal(signal.SIGKILL)
            apiserver.wait(timeout=30)
            apiserver = start_apiserver("second")
            return {"acked": acked}

        r = workload.run_wire_churn(url, 40, 300, 3, "mixed", seed=4, wave_deadline_s=90,
                                    crash=(1, drill))
        acked = {k: v for k, v in r["crash"]["acked"].items() if v}
        assert acked, "no bind was acknowledged before the kill"
        pods, _ = rs.list("Pod")
        nodes, _ = rs.list("Node")
        now = {p["metadata"]["name"]: p["spec"].get("nodeName") for p in pods}
        assert all(now[name] == node for name, node in acked.items())
        assert r["bound"] == 300 and r["unbound"] == 0 and all(now.values())
        assert workload.overcommitted_nodes(pods, nodes) == []
        recovered = [json.loads(ln.split(" ", 2)[2]) for ln in
                     (tmp_path / "apiserver-second.out").read_text().splitlines()
                     if ln.startswith("apiserver recovered ")]
        assert len(recovered) == 1 and recovered[0]["revision"] >= len(acked)
        assert recovered[0]["replayed"] > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{hp}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert (_metric(text, "client_watch_reconnects_total")
                + _metric(text, "client_informer_relists_total")) > 0
        assert _terminate(scheduler) == 0
        assert _terminate(apiserver) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


@pytest.mark.timeout(120)
def test_entry_points_refuse_without_admission_or_card(tmp_path):
    """The apiserver never serves as if it had authenticated anyone: each
    auth, audit or TLS flag of the JAX entry point makes it exit non-zero,
    naming ROADMAP.md.  The scheduler with its default ``--device cuda``
    exits before it takes the lease where there is no card (hidden from it
    here on any host)."""
    for flag, value in (("--token-file", "tokens.csv"), ("--authorization-mode", "RBAC"),
                        ("--tls-cert-file", "c.pem")):
        out = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
                              "--port", str(_free_port()), flag, value], env=_env(),
                             cwd=tmp_path, capture_output=True, text=True, timeout=60)
        assert out.returncode != 0 and "ROADMAP.md" in out.stderr and flag in out.stderr
        assert "serving on" not in out.stdout
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
    # an auth flag is refused before anything serves
    assert main(["apiserver", "--port", "0", "--audit-log", "audit.jsonl"]) == 2


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
    bad.write_text(json.dumps({"algorithm_provider": "DefaultProvider"}))
    with pytest.raises(ValueError, match="unknown config keys"):
        load_component_config(SchedulerConfiguration, str(bad))
    with pytest.raises(SystemExit):
        sched_main._parse(["--apiserver", "http://127.0.0.1:1", "--feature-gates",
                           "BatchScheduling=false"])


def test_the_jax_daemons_configuration_and_flags_load(tmp_path, monkeypatch):
    """``backend: "tpu"`` (the JAX default) is the batch backend, and
    ``policy_config_file`` loads from the file and from the flag
    (flag > file > default)."""
    from kubernetes_tpu_torch.scheduler import __main__ as sched_main
    from kubernetes_tpu_torch.utils import features

    monkeypatch.setattr(features, "DEFAULT_FEATURE_GATES", FeatureGates())
    monkeypatch.setattr(sched_main, "DEFAULT_FEATURE_GATES", features.DEFAULT_FEATURE_GATES)
    cfg = tmp_path / "sched.json"
    cfg.write_text(json.dumps({"backend": "tpu", "policy_config_file": "file.json"}))
    assert load_component_config(SchedulerConfiguration, str(cfg)).policy_config_file == "file.json"
    base = ["--apiserver", "http://127.0.0.1:1"]
    args = sched_main._parse(base + ["--config", str(cfg)])
    assert (args.backend, args.policy_config_file) == ("batch", "file.json")
    args = sched_main._parse(base + ["--config", str(cfg), "--policy-config-file", "flag.json",
                                     "--backend", "oracle"])
    assert (args.backend, args.policy_config_file) == ("oracle", "flag.json")
    args = sched_main._parse(base + ["--backend", "tpu"])
    assert (args.backend, args.policy_config_file) == ("batch", "")
    assert SchedulerConfiguration().policy_config_file == ""


@pytest.mark.timeout(120)
def test_a_policy_the_scan_cannot_express_runs_on_the_oracle(tmp_path, monkeypatch, capsys,
                                                               caplog):
    """The batch daemon takes a policy the fused scan does not compute, as
    the JAX daemon does: it logs once at start-up that the waves run on the
    host oracle, binds, and counts those pods on /metrics
    (``scheduler_backend_oracle_pods_total``) and in its stats."""
    from kubernetes_tpu_torch.scheduler import __main__ as sched_main
    from kubernetes_tpu_torch.scheduler import scheduler as sched_mod

    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({"priorities": [{"name": "ServiceSpreadingPriority",
                                                  "weight": 1}]}))
    stop = threading.Event()
    scrapes = []
    orig = sched_mod.Scheduler.schedule_pending_batch

    def recording(self, max_batch=None):
        out = orig(self, max_batch)
        if out[0]:
            scrapes.append(self.metrics.registry.expose())
            stop.set()  # one wave bound: the daemon stops as on SIGTERM
        return out

    monkeypatch.setattr(sched_mod.Scheduler, "schedule_pending_batch", recording)
    monkeypatch.setattr(sched_main, "install_signal_stop", lambda: stop)
    server = APIServer(Store())
    server.start()
    try:
        cs = Clientset(RemoteStore(server.url))
        cs.nodes.create(make_node("n1"))
        cs.pods.create(make_pod("p", cpu="100m"))
        with caplog.at_level(logging.WARNING):
            assert sched_main.main(["--apiserver", server.url, "--backend", "tpu",
                                    "--device", "cpu", "--policy-config-file",
                                    str(policy)]) == 0
        assert _bindings(server.url) == {"default/p": "n1"}
    finally:
        server.stop()
    logged = [r.getMessage() for r in caplog.records if "host oracle" in r.getMessage()]
    assert len(logged) == 1 and str(policy) in logged[0]
    assert "scheduler_backend_oracle_pods_total 1" in scrapes[0]
    stats = [json.loads(line)["scheduler_stats"] for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"scheduler_stats"')]
    assert len(stats) == 1 and stats[0]["oracle_pods"] == 1 and stats[0]["kernel_pods"] == 0


@pytest.mark.timeout(120)
def test_oracle_daemon_binds_asynchronously_with_preemption_and_a_policy(tmp_path, monkeypatch,
                                                                          capsys):
    """The ``--backend oracle`` loop calls ``schedule_one(timeout=0.2,
    async_bind=True)`` as the JAX daemon does, on a ``Scheduler`` that
    preempts by default and runs the ``--policy-config-file`` algorithm."""
    from kubernetes_tpu_torch.scheduler import __main__ as sched_main
    from kubernetes_tpu_torch.scheduler import scheduler as sched_mod

    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({"priorities": [{"name": "MostRequestedPriority",
                                                  "weight": 2}]}))
    stop = threading.Event()
    calls = []
    orig = sched_mod.Scheduler.schedule_one

    def recording(self, timeout=0.0, async_bind=False):
        calls.append((timeout, async_bind, self.enable_preemption,
                      [(type(p).__name__, w) for p, w in self.algorithm.priorities]))
        if orig(self, timeout=timeout, async_bind=async_bind):
            stop.set()  # one pod scheduled: the daemon stops as on SIGTERM
        return True

    monkeypatch.setattr(sched_mod.Scheduler, "schedule_one", recording)
    monkeypatch.setattr(sched_main, "install_signal_stop", lambda: stop)
    server = APIServer(Store())
    server.start()
    try:
        cs = Clientset(RemoteStore(server.url))
        cs.nodes.create(make_node("n1"))
        cs.pods.create(make_pod("p", cpu="100m"))
        assert sched_main.main(["--apiserver", server.url, "--backend", "oracle",
                                "--device", "cpu", "--policy-config-file", str(policy)]) == 0
        deadline = time.monotonic() + 30
        while not _bindings(server.url)["default/p"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _bindings(server.url) == {"default/p": "n1"}
    finally:
        server.stop()
    assert calls and all(c == (0.2, True, True, [("MostRequestedPriority", 2)]) for c in calls)
    stats = [json.loads(line)["scheduler_stats"] for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"scheduler_stats"')]
    assert len(stats) == 1 and stats[0]["backend"] == "oracle"
    assert stats[0]["preemption_attempts"] == stats[0]["preemption_victims"] == 0
