"""Chaos disruptions and SLO enforcement in the port (``testing/chaos.py``,
``testing/slo.py``): twin of ``tests/test_chaos_slo.py`` on what the port
runs.  The port has no kubelets or controllers yet, so the workloads are
pods created directly and the partition is exercised on a stand-in
fleet; the protocol, the disruptions and the SLO gate are the JAX
package's.

Tolerance: exact (every pod bound exactly once; thresholds as stated).
"""

from __future__ import annotations

import time

import pytest

from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.faults import FaultPlan, active_plan
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testing import (
    ChaosMonkey,
    FaultInjection,
    NodePartition,
    PodKiller,
    SchedulerRestart,
    SLOChecker,
    SLOViolation,
)
from kubernetes_tpu_torch.testutil import make_node, make_pod
from kubernetes_tpu_torch.utils.metrics import Counter, Histogram


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def advance(self, dt):
        self.now += dt

    def __call__(self):
        return self.now


def _world(n_nodes=6, batch=False):
    clock = FakeClock()
    cs = Clientset(Store())
    for i in range(n_nodes):
        cs.nodes.create(make_node(f"node-{i}", cpu="4", memory="8Gi"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu") if batch else None
    sched = Scheduler(cs, algorithm=algo, backend=backend, clock=clock)
    sched.start()
    return cs, clock, sched


def test_slo_checker_enforces_reference_thresholds():
    slo = SLOChecker()
    slo.check_throughput(250.0)
    slo.assert_all()
    slo = SLOChecker()
    slo.check_throughput(55.0)  # the warn band (30..100)
    slo.assert_all()
    assert slo.warnings
    slo = SLOChecker()
    slo.check_throughput(12.0)  # below the 30 pods/s floor
    h = Histogram("lat", buckets=[10, 100, 1000])
    for v in [5, 20, 900, 900, 900]:
        h.observe(v)
    slo.check_latency_quantile("algo latency", h, 0.99, max_value=100)
    c = Counter("failures")
    c.inc(7)
    slo.check_counter_max("failures", c, 3)
    with pytest.raises(SLOViolation) as ei:
        slo.assert_all()
    msg = str(ei.value)
    assert "throughput" in msg and "p99" in msg and "failures" in msg


@pytest.mark.parametrize("batch", [False, True], ids=["oracle", "batch"])
def test_scheduler_slis_meet_slo_in_density_run(batch):
    """The scheduler_perf density gate on the port's SLI histograms."""
    cs, clock, sched = _world(6, batch=batch)
    cs.pods.create_many([make_pod(f"d{i:03d}", cpu="10m") for i in range(200)])
    start = time.perf_counter()
    for _ in range(30):
        sched.pump()
        if batch:
            sched.schedule_pending_batch()
        else:
            sched.run_pending()
        clock.advance(1.0)
        pods, _ = cs.pods.list()
        if all(p.spec.node_name for p in pods):
            break
    elapsed = time.perf_counter() - start
    bound = sum(1 for p in cs.pods.list()[0] if p.spec.node_name)
    assert bound == 200
    slo = SLOChecker()
    slo.check_throughput(bound / elapsed)
    slo.check_latency_quantile("e2e scheduling latency", sched.metrics.e2e_scheduling_latency,
                               0.99, max_value=1_000_000)
    slo.check_counter_max("schedule failures", sched.metrics.schedule_failures, 0)
    slo.assert_all()


def test_scheduler_restart_resumes_from_store():
    """Drop the scheduler mid-workload and rebuild it from nothing but the
    store: every pod lands exactly once."""
    cs, clock, sched = _world(6, batch=True)
    holder = {"scheduler": sched}
    cs.pods.create_many([make_pod(f"r{i:03d}", cpu="100m") for i in range(30)])

    def factory():
        algo = GenericScheduler()
        return Scheduler(cs, algorithm=algo, backend=BatchBackend(algorithm=algo, device="cpu"),
                         clock=clock)

    def tick(t):
        s = holder["scheduler"]
        if s is not None:
            s.pump()
            s.schedule_pending_batch(max_batch=4)  # the workload spans the restart
        clock.advance(2.0)

    def done():
        return all(p.spec.node_name for p in cs.pods.list()[0])

    cm = ChaosMonkey(tick, [SchedulerRestart(holder, factory)], inject_at=3, recover_at=6,
                     done=done, max_ticks=60)
    cm.run()
    assert cm.injected and cm.recovered and holder["scheduler"] is not sched
    pods, _ = cs.pods.list()
    assert len(pods) == 30 and all(p.spec.node_name for p in pods)
    assert 0 < sched.metrics.batch_size.sum < 30  # the old one did part of it


def test_pod_killer_deletes_running_pods_and_the_cache_follows():
    cs, clock, sched = _world(3)
    for i in range(10):
        pod = make_pod(f"k{i}", cpu="100m", node_name=f"node-{i % 3}")
        pod.status.phase = "Running"
        cs.pods.create(pod)
    sched.pump()
    killer = PodKiller(cs, rate=2, seed=3)

    def tick(t):
        sched.pump()
        clock.advance(1.0)

    cm = ChaosMonkey(tick, [killer], inject_at=1, recover_at=4, max_ticks=6)
    cm.run()
    left = cs.pods.list()[0]
    assert killer.killed == 6 and len(left) == 4
    assert sum(len(i.pods) for i in sched.snapshot().values()) == 4


def test_node_partition_silences_and_restores_a_fleet():
    class _Kubelet:
        def __init__(self, name):
            self.node_name = name
            self._last_heartbeat = 0.0

    class _Fleet:
        kubelets = [_Kubelet(f"node-{i}") for i in range(5)]

    fleet = _Fleet()
    part = NodePartition(fleet, {"node-0", "node-3"})
    part.begin()
    assert [k.node_name for k in fleet.kubelets] == ["node-1", "node-2", "node-4"]
    part.end()
    assert sorted(k.node_name for k in fleet.kubelets) == [f"node-{i}" for i in range(5)]
    assert all(k._last_heartbeat < 0 for k in fleet.kubelets if k.node_name in ("node-0",
                                                                                 "node-3"))


def test_a_raising_tick_never_leaks_an_armed_plan():
    plan = FaultPlan(seed=1).on("scheduler.bind", mode="drop")

    def tick(t):
        if t == 2:
            raise RuntimeError("workload blew up mid-fault")

    cm = ChaosMonkey(tick, [FaultInjection(plan)], inject_at=1, recover_at=5, max_ticks=10)
    with pytest.raises(RuntimeError):
        cm.run()
    assert cm.recovered and active_plan() is None
