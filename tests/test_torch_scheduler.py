"""The port's serving scheduler (``kubernetes_tpu_torch.scheduler``:
``SchedulerCache``, ``SchedulingQueue``/``PodBackoff``, ``Scheduler``) and
the slice as a whole, on the CPU.

Twins of the JAX package's scheduler tests (``tests/test_scheduler.py``
cache and scheduler cases, ``tests/test_scheduler_queue.py``, and
``tests/test_parity.py::test_backend_in_scheduler_end_to_end``), and the
churn parity test: the same seeded ``mixed`` cluster served in sequential
waves by the JAX ``Scheduler`` + ``TPUBatchBackend``, by the port's
``Scheduler`` + ``BatchBackend(device="cpu")`` and by the port's per-pod
oracle replay.  Tolerance: exact — every binding, the final round-robin
counter and the count of Scheduled events.

The JAX package is imported inside the tests that compare with it, so the
``cuda``-marked test also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_scheduler.py
"""

from __future__ import annotations

import importlib
import random
import threading
from collections import Counter

import pytest
import torch

from kubernetes_tpu_torch.api import Taint, Toleration
from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.scheduler import (
    FitError,
    GenericScheduler,
    Scheduler,
    SchedulerCache,
)
from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
from kubernetes_tpu_torch.scheduler.queue import PodBackoff, SchedulingQueue
from kubernetes_tpu_torch.scheduler.units import CPU_MILLI, MEM_MIB
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testutil import make_node, make_pod
from kubernetes_tpu_torch import workload


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


# -- NodeInfo: remove_node / replace_pod ------------------------------------


def test_nodeinfo_remove_node_and_replace_pod_bump_generation():
    info = NodeInfo(make_node("n1", labels={"failure-domain.beta.kubernetes.io/zone": "z"}))
    assumed = make_pod("p", cpu="1", host_ports=[80])
    info.add_pod(assumed)
    g = info.generation
    confirmed = make_pod("p", cpu="1", host_ports=[80], node_name="n1")
    assert info.replace_pod(assumed, confirmed)
    assert info.generation == g + 1
    assert info.pods == [confirmed] and info.requested[CPU_MILLI] == 1000
    assert info.used_ports == {("TCP", 80)}
    assert not info.replace_pod(make_pod("other"), make_pod("other"))
    assert info.generation == g + 1
    info.remove_node()
    assert info.node is None and info.zone_key == "" and info.generation == g + 2
    assert info.pods == [confirmed]  # pod aggregation stays until the pods go


def test_nodeinfo_replace_pod_keeps_affinity_list_in_step():
    from kubernetes_tpu_torch.api import Affinity, LabelSelector, PodAffinityTerm

    aff = Affinity(pod_anti_affinity_required=[PodAffinityTerm(
        selector=LabelSelector.from_match_labels({"a": "b"}))])
    info = NodeInfo(make_node("n1"))
    old = make_pod("p", affinity=aff)
    info.add_pod(old)
    new = make_pod("p", affinity=aff, node_name="n1")
    assert info.replace_pod(old, new)
    assert info.pods_with_affinity == [new]


# -- SchedulerCache: assume / confirm / expire (tests/test_scheduler.py) ----


def test_assume_confirm():
    clock = FakeClock()
    cache = SchedulerCache(ttl=30, clock=clock)
    cache.add_node(make_node("n1"))
    cache.assume_pod(make_pod("p", cpu="1"), "n1")
    assert cache.is_assumed("default/p")
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 1000
    cache.add_pod(make_pod("p", cpu="1", node_name="n1"))
    assert not cache.is_assumed("default/p")
    clock.now += 100
    assert cache.cleanup_expired() == []  # confirmed pods never expire
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 1000
    assert [p.spec.node_name for p in snap["n1"].pods] == ["n1"]  # the API truth


def test_assume_then_confirm_leaves_no_phantom():
    """An assume → confirm cycle swaps the object without re-aggregating:
    one pod on the node, the same requests, no phantom left behind."""
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    cache.assume_many([(make_pod(f"p{i}", cpu="100m", memory="64Mi"), "n1") for i in range(3)])
    for i in range(3):
        cache.add_pod(make_pod(f"p{i}", cpu="100m", memory="64Mi", node_name="n1"))
    snap = {}
    cache.snapshot_into(snap)
    assert len(snap["n1"].pods) == 3 and snap["n1"].requested[CPU_MILLI] == 300
    assert cache.pod_count() == 3


def test_confirm_on_another_node_trusts_the_api():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    cache.add_node(make_node("n2"))
    cache.assume_pod(make_pod("p", cpu="1"), "n1")
    cache.add_pod(make_pod("p", cpu="1", node_name="n2"))
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 0
    assert snap["n2"].requested[CPU_MILLI] == 1000


def test_assume_expiry_rolls_back():
    clock = FakeClock()
    cache = SchedulerCache(ttl=30, clock=clock)
    cache.add_node(make_node("n1"))
    cache.assume_pod(make_pod("p", cpu="1"), "n1")
    cache.finish_binding("default/p")
    clock.now = 31
    assert cache.cleanup_expired() == ["default/p"]
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 0


def test_forget_pod():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    pod = make_pod("p", cpu="1")
    cache.assume_pod(pod, "n1")
    cache.forget_pod(pod)
    assert not cache.is_assumed("default/p")
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 0


def test_snapshot_copy_on_write():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    cache.add_node(make_node("n2"))
    snap = {}
    cache.snapshot_into(snap)
    n1_before, n2_before = snap["n1"], snap["n2"]
    cache.assume_pod(make_pod("p", cpu="1"), "n1")
    cache.snapshot_into(snap)
    assert snap["n1"] is not n1_before  # generation moved -> recloned
    assert snap["n2"] is n2_before  # untouched -> same object
    assert snap["n1"].requested[CPU_MILLI] == 1000


def test_remove_pod_updates_aggregates():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    pod = make_pod("p", cpu="1", memory="1Gi", node_name="n1", host_ports=[80])
    cache.add_pod(pod)
    cache.remove_pod(pod)
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].requested[CPU_MILLI] == 0
    assert snap["n1"].requested[MEM_MIB] == 0
    assert snap["n1"].used_ports == set()


def test_remove_pod_keeps_shared_host_port():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    a = make_pod("a", host_ports=[8080], node_name="n1")
    b = make_pod("b", host_ports=[8080], node_name="n1")
    cache.add_pod(a)
    cache.add_pod(b)
    cache.remove_pod(a)
    snap = {}
    cache.snapshot_into(snap)
    assert ("TCP", 8080) in snap["n1"].used_ports
    cache.remove_pod(b)
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].used_ports == set()


def test_remove_node_keeps_pods_until_they_go():
    cache = SchedulerCache()
    cache.add_node(make_node("n1"))
    pod = make_pod("p", cpu="1", node_name="n1")
    cache.add_pod(pod)
    cache.remove_node("n1")
    assert cache.node_names() == []
    snap = {}
    cache.snapshot_into(snap)
    assert snap["n1"].node is None and snap["n1"].requested[CPU_MILLI] == 1000
    cache.remove_pod(pod)
    cache.snapshot_into(snap)
    assert "n1" not in snap


# -- the oracle -------------------------------------------------------------


def build_map(nodes):
    return {n.meta.name: NodeInfo(n) for n in nodes}


def test_schedule_picks_least_loaded():
    m = build_map([make_node("n1", cpu="4"), make_node("n2", cpu="4")])
    m["n1"].add_pod(make_pod("e", cpu="3", node_name="n1"))
    assert GenericScheduler().schedule(make_pod("p", cpu="1"), m).node_name == "n2"


def test_schedule_fit_error_has_reasons():
    m = build_map([make_node("n1", cpu="1")])
    with pytest.raises(FitError) as ei:
        GenericScheduler().schedule(make_pod("p", cpu="2"), m)
    assert "Insufficient cpu" in ei.value.failed_predicates["n1"]


def test_round_robin_tie_break():
    m = build_map([make_node(f"n{i}") for i in range(3)])
    g = GenericScheduler()
    picks = [g.schedule(make_pod(f"p{i}"), m).node_name for i in range(6)]
    assert picks == ["n0", "n1", "n2", "n0", "n1", "n2"]


# -- the scheduler end to end (tests/test_scheduler.py) ---------------------


@pytest.fixture
def cluster():
    return Clientset(Store())


def test_end_to_end_scheduling(cluster):
    for i in range(3):
        cluster.nodes.create(make_node(f"n{i}", cpu="4", memory="8Gi"))
    for i in range(6):
        cluster.pods.create(make_pod(f"p{i}", cpu="500m", memory="512Mi"))
    sched = Scheduler(cluster)
    sched.start()
    assert sched.run_pending() == 6
    pods, _ = cluster.pods.list()
    assert all(p.spec.node_name for p in pods)
    assert len({p.spec.node_name for p in pods}) == 3  # spread across all nodes


def test_unschedulable_pod_backoff_and_recovery(cluster):
    cluster.nodes.create(make_node("n1", cpu="1"))
    cluster.pods.create(make_pod("big", cpu="2"))
    clock = FakeClock()
    sched = Scheduler(cluster, clock=clock, emit_events=True)
    sched.start()
    assert sched.run_pending() == 1  # attempt happened, failed
    assert cluster.pods.list()[0][0].spec.node_name == ""
    assert len(sched.queue) == 0 and sched.queue.pending_delayed() == 1
    cluster.nodes.create(make_node("n2", cpu="4"))
    sched.pump()
    clock.now += 2.0
    assert sched.run_pending() == 1
    assert cluster.pods.get("big").spec.node_name == "n2"
    reasons = {e.reason for e in cluster.events.list()[0]}
    assert "FailedScheduling" in reasons and "Scheduled" in reasons


def test_scheduler_respects_existing_pods_via_watch(cluster):
    cluster.nodes.create(make_node("n1", cpu="4"))
    cluster.nodes.create(make_node("n2", cpu="4"))
    cluster.pods.create(make_pod("existing", cpu="3", node_name="n1"))
    sched = Scheduler(cluster)
    sched.start()
    cluster.pods.create(make_pod("new", cpu="3"))
    sched.pump()
    sched.run_pending()
    assert cluster.pods.get("new").spec.node_name == "n2"


def test_assumed_pod_blocks_capacity_until_confirm(cluster):
    cluster.nodes.create(make_node("n1", cpu="4"))
    cluster.nodes.create(make_node("n2", cpu="1"))
    sched = Scheduler(cluster)
    sched.start()
    cluster.pods.create(make_pod("a", cpu="3"))
    cluster.pods.create(make_pod("b", cpu="3"))
    sched.pump()
    sched.run_pending()
    assert cluster.pods.get("a").spec.node_name == "n1"
    assert cluster.pods.get("b").spec.node_name == ""


def test_metrics_recorded(cluster):
    cluster.nodes.create(make_node("n1"))
    cluster.pods.create(make_pod("p"))
    sched = Scheduler(cluster)
    sched.start()
    sched.run_pending()
    assert sched.metrics.schedule_attempts.value == 1
    assert sched.metrics.e2e_scheduling_latency.count == 1
    assert sched.metrics.binding_latency.count == 1
    assert "scheduler_e2e_scheduling_latency_microseconds" in sched.metrics.registry.expose()


def test_failed_pod_requeued_with_latest_spec(cluster):
    cluster.nodes.create(make_node("n1", taints=[Taint(key="k", value="v", effect="NoSchedule")]))
    cluster.pods.create(make_pod("p", cpu="100m"))
    clock = FakeClock()
    sched = Scheduler(cluster, clock=clock)
    sched.start()

    def patch(pod):
        pod.spec.tolerations = [Toleration(key="k", operator="Equal", value="v")]
        return pod

    sched.pump()
    cluster.pods.guaranteed_update("p", patch)
    sched.run_pending()  # the attempt sees the stale spec, fails, requeues LATEST
    sched.pump()
    clock.now += 2.0
    sched.run_pending()
    assert cluster.pods.get("p").spec.node_name == "n1"


def test_terminal_or_foreign_pods_never_queue(cluster):
    from kubernetes_tpu_torch.api import FAILED

    cluster.nodes.create(make_node("n1"))
    other = make_pod("other")
    other.spec.scheduler_name = "someone-else"
    done = make_pod("done")
    done.status.phase = FAILED
    cluster.pods.create(other)
    cluster.pods.create(done)
    cluster.pods.create(make_pod("mine"))
    sched = Scheduler(cluster)
    sched.start()
    assert [p.meta.name for p in sched.queue.snapshot_pending()] == ["mine"]


def test_bind_conflict_forgets_assumption(cluster):
    """A bind that loses to another writer rolls the assumption back and
    records FailedBinding; the informer then delivers the truth."""
    from kubernetes_tpu_torch.api import Binding

    cluster.nodes.create(make_node("n1"))
    cluster.nodes.create(make_node("n2"))
    cluster.pods.create(make_pod("p", cpu="1"))
    sched = Scheduler(cluster)
    sched.start()
    pod = sched.queue.pop(timeout=0)
    sched.cache.assume_pod(pod, "n1")
    cluster.pods.bind(Binding(pod_name="p", node_name="n2"))  # someone else wins
    assert sched._bind(pod, "n1") is False
    assert not sched.cache.is_assumed("default/p")
    assert sched.metrics.bind_failures.value == 1
    sched.pump()
    snap = sched.snapshot()
    assert snap["n2"].requested[CPU_MILLI] == 1000 and snap["n1"].requested[CPU_MILLI] == 0
    assert "FailedBinding" in {e.reason for e in cluster.events.list()[0]}


# -- the batch path ---------------------------------------------------------


def _batch_cluster(pkg, n_nodes=8, n_pods=40):
    client = importlib.import_module(f"{pkg}.client")
    store = importlib.import_module(f"{pkg}.store")
    tu = importlib.import_module(f"{pkg}.testutil")
    cs = client.Clientset(store.Store())
    for i in range(n_nodes):
        cs.nodes.create(tu.make_node(f"n{i}", cpu="8", memory="16Gi"))
    for i in range(n_pods):
        cs.pods.create(tu.make_pod(f"p{i}", cpu="500m", memory="512Mi"))
    return cs


def test_backend_in_scheduler_end_to_end():
    """Twin of ``test_parity.py::test_backend_in_scheduler_end_to_end``,
    held against the JAX ``Scheduler`` + ``TPUBatchBackend`` on the same
    cluster: the same bindings and round-robin counter."""
    from kubernetes_tpu.ops import TPUBatchBackend
    from kubernetes_tpu.scheduler import GenericScheduler as JaxGeneric
    from kubernetes_tpu.scheduler import Scheduler as JaxScheduler

    cs = _batch_cluster("kubernetes_tpu_torch")
    algo = GenericScheduler()
    sched = Scheduler(cs, algorithm=algo, backend=BatchBackend(algorithm=algo, device="cpu"))
    sched.start()
    assert sched.schedule_pending_batch() == (40, 0)
    pods, _ = cs.pods.list()
    assert all(p.spec.node_name for p in pods)
    assert max(Counter(p.spec.node_name for p in pods).values()) <= 110

    jcs = _batch_cluster("kubernetes_tpu")
    jalgo = JaxGeneric()
    jsched = JaxScheduler(jcs, algorithm=jalgo,
                          backend=TPUBatchBackend(algorithm=jalgo, kernel_impl="xla"))
    jsched.start()
    assert jsched.schedule_pending_batch() == (40, 0)
    want = {p.meta.key: p.spec.node_name for p in jcs.pods.list()[0]}
    assert {p.meta.key: p.spec.node_name for p in pods} == want
    assert algo._round_robin == jalgo._round_robin


def test_batch_assume_then_confirm_keeps_host_state_in_step():
    """Across waves the cache's assume → watch-confirm cycle must leave the
    backend's persistent host state seeing each pod exactly once: wave 2's
    bindings equal a fresh backend's on the same snapshot."""
    cs = Clientset(Store())
    for i in range(6):
        cs.nodes.create(make_node(f"n{i}", cpu="4", memory="8Gi"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    sched = Scheduler(cs, algorithm=algo, backend=backend)
    sched.start()
    for w in range(3):
        cs.pods.create_many([make_pod(f"w{w}-{i}", cpu="300m", labels={"app": "web"})
                             for i in range(12)])
        sched.pump()
        pending = list(sched.queue.snapshot_pending())
        snap = {n: i.clone() for n, i in sched.snapshot().items()}
        pctx = sched.priority_context(snap)
        fresh = GenericScheduler()
        fresh._round_robin = algo._round_robin
        want = BatchBackend(algorithm=fresh, device="cpu").schedule_batch(pending, snap, pctx)
        assert sched.schedule_pending_batch() == (12, 0)
        got = {p.meta.key: p.spec.node_name for p in cs.pods.list()[0]}
        assert [got[p.meta.key] for p in pending] == want
        sched.pump()
        assert sched.cache.pod_count() == 12 * (w + 1)
        assert not any(sched.cache.is_assumed(p.meta.key) for p in pending)
    snap = sched.snapshot()
    assert sum(len(i.pods) for i in snap.values()) == 36


def test_batch_e2e_sli_recorded_per_segment():
    """Pods committed in an earlier segment record a smaller e2e latency
    than pods committed later: the histogram shows a spread."""
    clock = [0.0]
    cs = Clientset(Store())
    for i in range(4):
        cs.nodes.create(make_node(f"n{i}", cpu="16", memory="32Gi", pods=110))
    for i in range(40):
        cs.pods.create(make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    sched = Scheduler(cs, algorithm=algo, backend=backend, clock=lambda: clock[0])
    sched.start()
    orig = backend.schedule_batch

    def stepped(pods, snapshot, pctx, on_segment=None, on_idle=None):
        collected = []
        orig(pods, snapshot, pctx, on_segment=collected.extend)
        half = len(collected) // 2
        for part in (collected[:half], collected[half:]):
            clock[0] += 1.0
            on_segment(part)

    backend.schedule_batch = stepped
    assert sched.schedule_pending_batch() == (40, 0)
    h = sched.metrics.e2e_scheduling_latency
    assert h.count == 40 and h.quantile(0.5) < h.quantile(0.99)


def test_batch_phases_and_on_idle_wiring(cluster):
    """Several segments: ``on_idle`` runs once, after every earlier segment
    was committed and while the last is in flight; on the CPU it gets no
    probe.  The wave's phase deltas land in ``last_batch_phases``."""
    for i in range(4):
        cluster.nodes.create(make_node(f"n{i}", cpu="16", memory="32Gi"))
    for i in range(30):
        cluster.pods.create(make_pod(f"p{i:02d}", cpu="100m"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu", max_segment_pods=8)
    sched = Scheduler(cluster, algorithm=algo, backend=backend)
    calls = []
    orig_idle = sched._pipeline_idle

    def spy(device_busy=None):
        calls.append((device_busy, sched.cache.pod_count()))
        orig_idle(device_busy=device_busy)

    sched._pipeline_idle = spy
    sched.start()
    assert sched.schedule_pending_batch() == (30, 0)
    assert calls == [(None, 24)]  # 3 of 4 segments committed before it
    ph = sched.last_batch_phases
    assert set(ph) == {"tensorize_s", "dispatch_s", "device_wait_s", "kernel_ms",
                       "commit_s", "prep_s", "decode_s", "promotions", "apply_s",
                       "frames", "frame_events", "parse_s", "confirm_fallbacks",
                       "host_syncs"}
    assert ph["commit_s"] > 0 and ph["prep_s"] > 0 and ph["kernel_ms"] == 0.0
    assert backend.stats["segments"] == 4


def test_pipeline_idle_polls_until_the_device_is_done(cluster, monkeypatch):
    """With a probe, the prep pumps and sleeps ``_PREP_POLL_S`` between
    polls until the probe reports the device idle; arrivals that land
    meanwhile are digested before the next drain."""
    from kubernetes_tpu_torch.scheduler import scheduler as sched_mod

    cluster.nodes.create(make_node("n1"))
    sched = Scheduler(cluster, backend=BatchBackend(device="cpu"))
    sched.start()
    monkeypatch.setattr(sched, "_poll_full_device_window", lambda: True)
    pumps = []
    orig_pump = sched.pump
    sched.pump = lambda: pumps.append(1) or orig_pump()
    polls = iter([True, True, False])

    def busy():
        if len(pumps) == 2:
            cluster.pods.create(make_pod("late"))
        return next(polls)

    sched._pipeline_idle(device_busy=busy)
    assert len(pumps) == 3  # one pump per poll, the last after the device finished
    assert [p.meta.name for p in sched.queue.snapshot_pending()] == ["late"]
    assert sched._last_prep_s >= 2 * sched_mod._PREP_POLL_S


def test_poll_window_follows_the_backend_device(cluster, monkeypatch):
    sched = Scheduler(cluster, backend=BatchBackend(device="cpu"))
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    assert sched._poll_full_device_window() is False
    sched.backend.device = torch.device("cuda")
    assert sched._poll_full_device_window() is True


def test_pipeline_idle_failure_is_contained(cluster):
    sched = Scheduler(cluster, backend=BatchBackend(device="cpu"))
    sched.start()

    def broken():
        raise RuntimeError("informer down")

    sched.pump = broken
    sched._pipeline_idle(device_busy=None)
    assert sched.metrics.pipeline_prep_failures.value == 1


def test_batch_path_needs_a_card_or_cpu(cluster, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(cluster, backend=BatchBackend())
    with pytest.raises(RuntimeError, match="CUDA"):
        workload.run_churn(10, 20, 2, "plain", seed=0)
    with pytest.raises(RuntimeError, match="no batch backend"):
        cluster.pods.create(make_pod("p"))
        s = Scheduler(cluster)
        s.start()
        s.schedule_pending_batch()


def test_aborted_batch_closes_host_state_and_next_batch_rebuilds(monkeypatch):
    """An ``on_segment`` that raises mid-batch: the backend closes and drops
    its persistent host state, and the next batch rebuilds it and schedules
    exactly as a fresh backend would."""
    from kubernetes_tpu_torch.models import snapshot as snap_mod
    from tests import torch_port_cases as cases

    closed = []
    orig_close = snap_mod.HostBatchState.close
    monkeypatch.setattr(snap_mod.HostBatchState, "close",
                        lambda self: (closed.append(self), orig_close(self)))
    M = cases.mods(cases.PORT)
    m, pods, pctx = cases.mixed(cases.PORT)
    backend = BatchBackend(device="cpu", max_segment_pods=16)
    seen = []

    def explode(entries):
        seen.append(len(entries))
        raise RuntimeError("commit failed")

    with pytest.raises(RuntimeError, match="commit failed"):
        backend.schedule_batch(pods, m, pctx, on_segment=explode)
    assert seen == [16] and len(closed) == 1 and backend._host_state is None
    algo = M.gs.GenericScheduler()
    backend.algorithm = algo
    got = backend.schedule_batch(pods, m, pctx)
    assert backend._host_state is not None and backend._host_state is not closed[0]
    oracle = M.gs.GenericScheduler()
    assert got == cases.oracle_batch(cases.PORT, pods, m, pctx, oracle)
    assert algo._round_robin == oracle._round_robin


# -- the repaired shapes and backend faults --------------------------------


def _wide_wave(cs, n_ordinary: int = 50):
    """Four nodes, ``n_ordinary`` small pods and, in the middle of them, a
    priority pod with one host port more than a signature row's shared
    port slot."""
    from kubernetes_tpu_torch.ops import fused_scan

    for i in range(4):
        cs.nodes.create(make_node(f"n{i}", cpu="8", memory="16Gi"))
    for i in range(n_ordinary):
        cs.pods.create(make_pod(f"p{i:03d}", cpu="100m"))
        if i == n_ordinary // 2:
            wide = make_pod("wide", cpu="100m", host_ports=list(
                range(20000, 20000 + fused_scan.MAX_PORTS + 1)))
            wide.spec.priority = 100
            cs.pods.create(wide)


def _failed_scheduling(cs) -> dict:
    return {e.involved_key: e.message for e in cs.events.list()[0]
            if e.reason == "FailedScheduling"}


def _assert_wave_bound_as_the_oracle(cs, sched, bound, failed, n_pods):
    """Every pod bound, none failed, and each on the node the sequential
    oracle picks for the same pods in the same order."""
    assert (bound, failed) == (n_pods, 0)
    placed = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}
    assert all(placed.values()) and len(placed) == n_pods
    assert _failed_scheduling(cs) == {}
    assert "refused_pods" not in sched.backend.stats
    assert sched.backend.stats["oracle_pods"] == 0
    ocs = Clientset(Store())
    for n in cs.nodes.list()[0]:
        ocs.nodes.create(n)
    algo = GenericScheduler()
    oracle = Scheduler(ocs, algorithm=algo)
    oracle.start()
    for p in sorted(cs.pods.list()[0], key=lambda p: p.meta.resource_version):
        pod = make_pod(p.meta.name, cpu="100m", host_ports=[hp for _, hp in p.host_ports()])
        pod.spec.priority = p.spec.priority
        ocs.pods.create(pod)
    oracle.pump()
    oracle.run_pending()
    want = {p.meta.name: p.spec.node_name for p in ocs.pods.list()[0]}
    assert placed == want


def test_a_wide_port_pod_binds_with_the_rest_of_the_wave(cluster):
    _wide_wave(cluster)
    algo = GenericScheduler()
    sched = Scheduler(cluster, algorithm=algo,
                      backend=BatchBackend(algorithm=algo, device="cpu"))
    sched.start()
    _assert_wave_bound_as_the_oracle(cluster, sched, *sched.schedule_pending_batch(), 51)
    # the priority pod drains first, alone in its segment; the rest follow
    assert sched.backend.stats["segments"] == 2
    # the loop goes on: the next wave schedules as before
    cluster.pods.create(make_pod("later", cpu="100m"))
    sched.pump()
    assert sched.schedule_pending_batch() == (1, 0)


def _many_zone_cluster(cs, n_zones: int = 300, n_pods: int = 6):
    for i in range(n_zones):
        cs.nodes.create(make_node(f"n{i:03d}", labels={
            "failure-domain.beta.kubernetes.io/zone": f"z{i}"}))
    for i in range(n_pods):
        cs.pods.create(make_pod(f"p{i}", cpu="100m"))


def test_a_cluster_of_many_zones_binds_every_pod(cluster):
    """300 zones, past what a 16-block cluster keeps in shared memory:
    every pod binds, on the node the oracle picks."""
    _many_zone_cluster(cluster)
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    sched = Scheduler(cluster, algorithm=algo, backend=backend)
    sched.start()
    _assert_wave_bound_as_the_oracle(cluster, sched, *sched.schedule_pending_batch(), 6)
    assert backend.stats["segments"] == 1 and backend.stats["kernel_pods"] == 6


def test_a_backend_fault_requeues_the_pods_no_segment_committed(cluster):
    for i in range(3):
        cluster.nodes.create(make_node(f"n{i}", cpu="8"))
    # a priority pod that fits nowhere fails in the committed first segment
    # and waits on the cohort pass the fault cancels
    big = make_pod("big", cpu="100")
    big.spec.priority = 100
    cluster.pods.create(big)
    for i in range(20):
        cluster.pods.create(make_pod(f"p{i:02d}", cpu="100m"))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu", max_segment_pods=8)
    sched = Scheduler(cluster, algorithm=algo, backend=backend)
    sched.start()
    launches = []
    orig = backend._dispatch

    def failing(static, init):
        launches.append(1)
        if len(launches) == 3:
            raise RuntimeError("launch failed")
        return orig(static, init)

    backend._dispatch = failing
    with pytest.raises(RuntimeError, match="launch failed"):
        sched.schedule_pending_batch()
    sched.pump()
    placed = {p.meta.name: p.spec.node_name for p in cluster.pods.list()[0]}
    bound = sorted(k for k, n in placed.items() if n)
    assert bound == [f"p{i:02d}" for i in range(7)]  # the first segment committed
    assert sorted(p.meta.name for p in sched.queue.snapshot_pending()) == ["big"] + [
        f"p{i:02d}" for i in range(7, 20)]
    assert sched.queue.pending_delayed() == 1  # big is backed off
    backend._dispatch = orig
    assert sched.schedule_pending_batch() == (13, 0)


@pytest.mark.cuda
@pytest.mark.timeout(300)
def test_on_card_a_wide_port_pod_and_many_zones_bind():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shapes are the fused CUDA kernel's")
    from kubernetes_tpu_torch.ops import fused_scan

    for build, n_pods in ((_wide_wave, 51), (_many_zone_cluster, 6)):
        cs = Clientset(Store())
        build(cs)
        algo = GenericScheduler()
        sched = Scheduler(cs, algorithm=algo,
                          backend=BatchBackend(algorithm=algo, device="cuda"))
        sched.start()
        before = fused_scan.launches
        _assert_wave_bound_as_the_oracle(cs, sched, *sched.schedule_pending_batch(), n_pods)
        assert fused_scan.launches > before


# -- run_batch_loop ---------------------------------------------------------


@pytest.mark.timeout(60)
def test_close_unblocks_batch_loop():
    sched = Scheduler(Clientset(Store()), emit_events=False)
    sched.start()
    out = []
    t = threading.Thread(target=lambda: out.append(sched.run_batch_loop(min_batch=10**6)),
                         daemon=True)
    t.start()
    try:
        sched.queue.close()
        t.join(timeout=10)
    finally:
        sched.stop()
    assert not t.is_alive(), "run_batch_loop did not exit on queue.close()"
    assert out == [0]


@pytest.mark.timeout(120)
def test_threaded_informers_and_sink_serve_an_arrival_stream():
    """``start(manual=False)``: informer threads and the event sink run;
    an arrival thread creates pods while ``run_batch_loop`` coalesces them
    into waves until the idle timeout ends it."""
    cs = Clientset(Store())
    for i in range(4):
        cs.nodes.create(make_node(f"n{i}", cpu="16", memory="32Gi"))
    algo = GenericScheduler()
    sched = Scheduler(cs, algorithm=algo, backend=BatchBackend(algorithm=algo, device="cpu"))
    sched.start(manual=False)

    def arrivals():
        for w in range(4):
            cs.pods.create_many([make_pod(f"a{w}-{i}", cpu="100m") for i in range(10)])

    t = threading.Thread(target=arrivals, daemon=True)
    try:
        t.start()
        bound = sched.run_batch_loop(min_batch=10, max_wait=0.5, idle_timeout=2.0)
        t.join(timeout=10)
    finally:
        sched.stop()
    assert not t.is_alive() and bound == 40
    assert sched.metrics.batch_size.count >= 1
    pods, _ = cs.pods.list()
    assert all(p.spec.node_name for p in pods)
    assert sum(e.count for e in cs.events.list()[0] if e.reason == "Scheduled") == 40
    assert not sched.broadcaster.running


# -- the queue (tests/test_scheduler_queue.py) ------------------------------


def test_backoff_doubles_and_caps():
    b = PodBackoff(initial=1.0, max_duration=60.0, clock=FakeClock())
    assert [b.get_backoff("default/p") for _ in range(8)] == [1.0, 2.0, 4.0, 8.0, 16.0,
                                                              32.0, 60.0, 60.0]


def test_backoff_is_per_pod_and_forget_resets():
    b = PodBackoff(clock=FakeClock())
    assert b.get_backoff("default/a") == 1.0
    assert b.get_backoff("default/a") == 2.0
    assert b.get_backoff("default/b") == 1.0
    assert b.peek("default/a") == 4.0 and b.peek("default/a") == 4.0  # peek never arms
    b.forget("default/a")
    assert b.get_backoff("default/a") == 1.0


def test_backoff_gc_drops_stale_entries_only():
    clock = FakeClock()
    b = PodBackoff(clock=clock)
    b.get_backoff("default/old")
    clock.advance(700)
    b.get_backoff("default/fresh")
    b.gc(max_age=600)
    assert b.get_backoff("default/old") == 1.0
    assert b.get_backoff("default/fresh") == 2.0


def test_fifo_order_and_dedup():
    q = SchedulingQueue(clock=FakeClock())
    q.add(make_pod("a"))
    q.add(make_pod("b"))
    q.add(make_pod("a"))  # same key while queued: deduped
    assert len(q) == 2
    assert q.pop(timeout=0).meta.name == "a"
    assert q.pop(timeout=0).meta.name == "b"
    assert q.pop(timeout=0) is None


def test_update_replaces_object_keeping_position():
    q = SchedulingQueue(clock=FakeClock())
    q.add(make_pod("a"))
    q.add(make_pod("b"))
    updated = make_pod("a", cpu="2")
    q.update(updated)
    assert q.pop(timeout=0) is updated
    q.update(make_pod("zzz"))  # unknown key: nothing enqueued
    assert q.pop(timeout=0).meta.name == "b"
    assert q.pop(timeout=0) is None


def test_removed_pod_becomes_phantom():
    q = SchedulingQueue(clock=FakeClock())
    q.add(make_pod("gone"))
    q.add(make_pod("stays"))
    q.remove("default/gone")
    assert len(q) == 1
    assert q.pop(timeout=0).meta.name == "stays"
    assert q.pop(timeout=0) is None


def test_requeue_after_backoff_delay():
    clock = FakeClock()
    q = SchedulingQueue(clock=clock)
    backoff = PodBackoff(initial=1.0, max_duration=60.0, clock=clock)
    pod = make_pod("p")
    q.add(pod)
    failed = q.pop(timeout=0)
    q.add_after(failed, backoff.get_backoff(failed.meta.key))
    assert len(q) == 0 and q.pending_delayed() == 1
    assert q.pop(timeout=0) is None
    clock.advance(1.0)
    assert q.pop(timeout=0) is pod and q.pending_delayed() == 0
    q.add_after(pod, backoff.get_backoff(pod.meta.key))
    clock.advance(1.0)
    assert q.pop(timeout=0) is None  # 2 s backoff: 1 s is not enough
    clock.advance(1.0)
    assert q.pop(timeout=0) is pod


def test_remove_while_delayed_is_phantom_on_expiry():
    clock = FakeClock()
    q = SchedulingQueue(clock=clock)
    pod = make_pod("p")
    q.add_after(pod, 5.0)
    q.remove(pod.meta.key)
    clock.advance(5.0)
    assert q.pop(timeout=0) is None and len(q) == 0


def test_drain_returns_ready_fifo_batch():
    clock = FakeClock()
    q = SchedulingQueue(clock=clock)
    for i in range(5):
        q.add(make_pod(f"p{i}"))
    q.add_after(make_pod("later"), 10.0)
    assert [p.meta.name for p in q.drain()] == ["p0", "p1", "p2", "p3", "p4"]
    assert len(q) == 0 and q.pending_delayed() == 1
    clock.advance(10.0)
    assert [p.meta.name for p in q.drain()] == ["later"]


def test_drain_respects_max_n_and_skips_phantoms():
    q = SchedulingQueue(clock=FakeClock())
    for i in range(4):
        q.add(make_pod(f"p{i}"))
    q.remove("default/p1")
    assert [p.meta.name for p in q.drain(max_n=3)] == ["p0", "p2"]
    assert [p.meta.name for p in q.drain()] == ["p3"]
    assert q.drain() == []


@pytest.mark.timeout(60)
def test_pop_blocks_until_add_and_close_unblocks():
    q = SchedulingQueue()
    out = []
    t = threading.Thread(target=lambda: out.append(q.pop(timeout=5)), daemon=True)
    t.start()
    q.add(make_pod("late"))
    t.join(timeout=5)
    assert not t.is_alive() and out[0].meta.name == "late"
    t = threading.Thread(target=lambda: out.append(q.pop(timeout=5)), daemon=True)
    t.start()
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and out[1] is None and q.closed


@pytest.mark.timeout(60)
def test_drain_races_arrival_thread():
    q = SchedulingQueue()
    n = 800
    done = threading.Event()

    def arrivals():
        for i in range(n):
            q.add(make_pod(f"p{i:04d}"))
        done.set()

    t = threading.Thread(target=arrivals, daemon=True)
    t.start()
    got: list[str] = []
    while not (done.is_set() and len(q) == 0):
        got.extend(p.meta.name for p in q.drain())
    got.extend(p.meta.name for p in q.drain())
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(got) == n and got == sorted(got) and len(set(got)) == n


@pytest.mark.timeout(60)
def test_backoff_requeue_lands_mid_drain():
    q = SchedulingQueue()
    backoff = PodBackoff(initial=0.0)
    for i in range(50):
        q.add(make_pod(f"p{i:03d}"))
    loser = q.drain(max_n=10)[0]
    requeued = threading.Event()

    def requeue():
        q.add_after(loser, backoff.get_backoff(loser.meta.key))  # 0.0: ready now
        requeued.set()

    t = threading.Thread(target=requeue, daemon=True)
    t.start()
    seen: list[str] = []
    for _ in range(50):
        seen.extend(p.meta.name for p in q.drain())
        if requeued.is_set() and loser.meta.name in seen:
            break
    t.join(timeout=5)
    assert not t.is_alive()
    assert seen.count(loser.meta.name) == 1 and len(seen) == 41 and len(q) == 0


@pytest.mark.timeout(60)
def test_wait_ready_blocks_then_sees_add_and_times_out():
    q = SchedulingQueue()
    assert q.wait_ready(timeout=0.01) is False
    out = []
    t = threading.Thread(target=lambda: out.append(q.wait_ready(timeout=5)), daemon=True)
    t.start()
    q.add(make_pod("wake"))
    t.join(timeout=5)
    assert not t.is_alive() and out == [True]
    assert q.wait_ready(timeout=0) is True  # non-consuming


# -- churn parity: JAX scheduler, port scheduler, port oracle replay -------

CHURN = dict(n_nodes=60, total_pods=400, waves=4, workload="mixed", seed=7)


def _jax_churn(n_nodes, total_pods, waves, workload, seed):
    import bench
    from kubernetes_tpu.client import Clientset as JaxClientset
    from kubernetes_tpu.ops import TPUBatchBackend
    from kubernetes_tpu.scheduler import GenericScheduler as JaxGeneric
    from kubernetes_tpu.scheduler import Scheduler as JaxScheduler
    from kubernetes_tpu.store import Store as JaxStore

    rng = random.Random(seed)
    cs = JaxClientset(JaxStore())
    for node in bench.make_nodes(n_nodes, rng, workload):
        cs.nodes.create(node)
    if workload == "mixed":
        for svc in bench.make_services():
            cs.services.create(svc)
    pods = bench.make_pods(total_pods, rng, workload)
    algo = JaxGeneric()
    sched = JaxScheduler(cs, algorithm=algo, enable_preemption=False,
                         backend=TPUBatchBackend(algorithm=algo, kernel_impl="xla"))
    return _serve_waves(cs, sched, pods, waves) + (algo._round_robin,)


def _port_churn(n_nodes, total_pods, waves, workload, seed, device):
    cs, pods = workload_cluster(n_nodes, total_pods, workload, seed)
    algo = GenericScheduler()
    sched = Scheduler(cs, algorithm=algo, backend=BatchBackend(algorithm=algo, device=device))
    return _serve_waves(cs, sched, pods, waves) + (algo._round_robin,)


def workload_cluster(n_nodes, total_pods, workload_name, seed):
    return workload._churn_cluster(n_nodes, total_pods, workload_name, seed)


def _serve_waves(cs, sched, pods, waves):
    """Sequential waves: one create_many, then one run_batch_loop wave.
    Returns (final binding map, drain batches, Scheduled event count)."""
    drains = []
    orig_drain = sched.queue.drain

    def recording_drain(max_n=None):
        out = orig_drain(max_n)
        if out:
            drains.append([p.meta.key for p in out])
        return out

    sched.queue.drain = recording_drain
    sched.start()
    per_wave = len(pods) // waves
    for w in range(waves):
        cs.pods.create_many(pods[w * per_wave:(w + 1) * per_wave])
        sched.run_batch_loop(min_batch=per_wave, max_wait=5.0, max_waves=1,
                             poll_interval=0.002)
    sched.pump()
    bindings = {p.meta.key: p.spec.node_name or None for p in cs.pods.list()[0]}
    events = sum(e.count for e in cs.events.list()[0] if e.reason == "Scheduled")
    return bindings, drains, events


@pytest.mark.timeout(300)
def test_churn_parity_jax_scheduler_port_scheduler_and_oracle_replay():
    want, _, want_events, want_rr = _jax_churn(**CHURN)
    got, drains, got_events, got_rr = _port_churn(**CHURN, device="cpu")
    assert len(drains) == CHURN["waves"]
    assert got == want
    assert got_rr == want_rr
    assert got_events == want_events == sum(1 for n in got.values() if n)
    replay = workload.oracle_replay_waves(drains, got, CHURN["n_nodes"], CHURN["total_pods"],
                                          CHURN["workload"], CHURN["seed"])
    assert replay["mode"] == "exact per-wave replay"
    assert replay["checked"] == CHURN["total_pods"] and replay["mismatches"] == 0
    assert replay["round_robin"] == got_rr


@pytest.mark.timeout(120)
def test_run_churn_threaded_matches_oracle_replay_on_cpu():
    """``workload.run_churn`` (arrival thread, event sink, one
    run_batch_loop per wave) against the per-wave oracle replay."""
    r = workload.run_churn(40, 160, 4, "mixed", seed=3, device="cpu")
    assert r["bound"] + r["unbound"] == 160 and r["drained"] >= 160
    assert r["backend"]["oracle_pods"] == 0
    assert r["backend"]["kernel_pods"] == r["drained"]
    assert r["scheduled_events"] == r["bound"]
    assert len(r["phase_timers"]) == 4
    replay = workload.oracle_replay_waves(r["drain_batches"], r["assignments"], 40, 160,
                                          "mixed", 3)
    assert replay["mismatches"] == 0 and replay["checked"] == 160
    assert replay["round_robin"] == r["round_robin"]


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_churn_on_card_matches_cpu_and_oracle_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batch path's fused scan is a CUDA kernel")
    from kubernetes_tpu_torch.ops import fused_scan

    before = fused_scan.launches
    got, drains, events, rr = _port_churn(**CHURN, device="cuda")
    assert fused_scan.launches - before >= CHURN["waves"]
    want, _, want_events, want_rr = _port_churn(**CHURN, device="cpu")
    assert got == want and rr == want_rr and events == want_events
    replay = workload.oracle_replay_waves(drains, got, CHURN["n_nodes"], CHURN["total_pods"],
                                          CHURN["workload"], CHURN["seed"])
    assert replay["mismatches"] == 0 and replay["round_robin"] == rr


@pytest.mark.timeout(300)
def test_run_churn_lazy_framed_and_eager_paths_equal_the_jax_scheduler():
    """``run_churn`` on the default ingest path (lazy decode, watch frames,
    columnar LIST, the frame confirm) and on the eager path (typed decode,
    per-event delivery) bind every pod as the JAX ``Scheduler`` does, with
    the same final round-robin counter.  Tolerance: exact."""
    args = (40, 160, 4, "mixed", 3)
    want, _, _, want_rr = _jax_churn(*args)
    lazy_run = workload.run_churn(*args, device="cpu")
    eager_run = workload.run_churn(*args, device="cpu", lazy_ingest=False)
    for r in (lazy_run, eager_run):
        assert r["assignments"] == want and r["round_robin"] == want_rr
    assert lazy_run["lazy_ingest"] and not eager_run["lazy_ingest"]
    lazy_ph, eager_ph = lazy_run["phase_timers"], eager_run["phase_timers"]
    assert sum(p["frames"] for p in lazy_ph) >= 4 and sum(p["frame_events"] for p in lazy_ph) >= 160
    assert sum(p["confirm_fallbacks"] for p in lazy_ph) == 0
    assert sum(p["frames"] for p in eager_ph) == 0 and sum(p["promotions"] for p in eager_ph) == 0
    from kubernetes_tpu_torch.api import lazy
    from kubernetes_tpu_torch.store import frames

    assert lazy.ENABLED and frames.ENABLED  # the eager run restored the defaults
