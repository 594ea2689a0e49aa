"""Preemption in the port (``scheduler/preemption.py``,
``ops/preemption_kernel.PreemptionState``, the ``Scheduler``'s PostFilter)
against the JAX package, on the CPU.

- Twins of ``tests/test_preemption_batch.py``: the ten oracle-parity cases
  (each package builds the same cluster; the exhaustive oracle and both
  fast paths of each package must agree, and the port's decisions must
  equal the JAX package's) and the four cohort cases through the batch
  path (the port's ``Scheduler`` + ``BatchBackend(device="cpu")`` against
  the JAX ``Scheduler`` + ``TPUBatchBackend``).
- Twins of the five preemption cases of ``tests/test_scheduler.py``
  (:277-348) on the per-pod path.
- ``workload.run_preemption`` at a small size, and the cohort's timers.

Tolerance: exact — the chosen node and victim keys of every decision, the
final binding of every pod, the preemption counters and the round-robin
counter.  The JAX package is imported inside the tests that compare with
it.
"""

from __future__ import annotations

import importlib
import random

import pytest

from kubernetes_tpu_torch import workload
from tests import torch_port_cases as cases


def _m(pkg: str):
    M = cases.mods(pkg)
    M.pre = importlib.import_module(f"{pkg}.scheduler.preemption")
    M.pk = importlib.import_module(f"{pkg}.ops.preemption_kernel")
    M.units = importlib.import_module(f"{pkg}.scheduler.units")
    return M


def prio(M, name, priority, cpu="1", memory="0", labels=None, affinity=None,
         host_ports=None, node_name=""):
    p = M.tu.make_pod(name, cpu=cpu, memory=memory, labels=labels, affinity=affinity,
                      host_ports=host_ports, node_name=node_name)
    p.spec.priority = priority
    return p


def _build_map(M, nodes, placed):
    m = {node.meta.name: M.NodeInfo(node) for node in nodes}
    for pod, node_name in placed:
        pod.spec.node_name = node_name
        m[node_name].add_pod(pod)
    return m


# -- the parity table (tests/test_preemption_batch.py:58-190) ----------------


def _simple_eviction(M):
    return prio(M, "vip", 100), _build_map(
        M, [M.tu.make_node("n1", cpu="2")],
        [(prio(M, "a", 0), "n1"), (prio(M, "b", 0), "n1")])


def _lowest_max_victim_priority(M):
    return prio(M, "vip", 100), _build_map(
        M, [M.tu.make_node("n1", cpu="1"), M.tu.make_node("n2", cpu="1")],
        [(prio(M, "mid", 5), "n1"), (prio(M, "lowly", 1), "n2")])


def _reprieve_spares_high_priority(M):
    return prio(M, "vip", 100, cpu="2"), _build_map(
        M, [M.tu.make_node("n1", cpu="4")],
        [(prio(M, "p1", 1), "n1"), (prio(M, "p2", 2), "n1"), (prio(M, "p3", 3), "n1")])


def _no_candidates(M):
    return prio(M, "vip", 50), _build_map(
        M, [M.tu.make_node("n1", cpu="1")], [(prio(M, "a", 50), "n1")])


def _insufficient_even_evicting_all(M):
    return prio(M, "vip", 100, cpu="4"), _build_map(
        M, [M.tu.make_node("n1", cpu="2")], [(prio(M, "a", 0), "n1")])


def _pod_count_dimension(M):
    return prio(M, "vip", 100, cpu="1"), _build_map(
        M, [M.tu.make_node("n1", cpu="32", pods=2)],
        [(prio(M, "a", 0, cpu="1"), "n1"), (prio(M, "b", 3, cpu="1"), "n1")])


def _port_conflict_with_survivor(M):
    return prio(M, "vip", 100, host_ports=[8080]), _build_map(
        M, [M.tu.make_node("n1", cpu="2"), M.tu.make_node("n2", cpu="1")],
        [(prio(M, "holder", 50, host_ports=[8080]), "n1"), (prio(M, "low", 0), "n1"),
         (prio(M, "mid", 5), "n2")])


def _affinity_preemptor(M):
    api = M.api
    aff = api.Affinity(pod_affinity_required=[api.PodAffinityTerm(
        selector=api.LabelSelector.from_match_labels({"app": "web"}),
        topology_key=cases.HOST)])
    nodes = [M.tu.make_node(f"n{i}", cpu="2", labels={cases.HOST: f"n{i}"}) for i in (1, 2, 3)]
    return prio(M, "vip", 100, cpu="2", affinity=aff), _build_map(
        M, nodes,
        [(prio(M, "web1", 1, labels={"app": "web"}), "n1"), (prio(M, "low1", 0), "n1"),
         (prio(M, "web2", 50, labels={"app": "web"}), "n2"), (prio(M, "low2", 0), "n2"),
         (prio(M, "low3", 0), "n3")])


def _overcommitted_node(M):
    m = _build_map(M, [M.tu.make_node("n1", cpu="2")], [])
    for i, p in enumerate([0, 0, 2]):
        m["n1"].add_pod(prio(M, f"f{i}", p, cpu="1", node_name="n1"))
    return prio(M, "vip", 100, cpu="2"), m


def _randomized(trial: int):
    """One of the eight clusters of ``test_parity_randomized_clusters``."""
    def build(M):
        rng = random.Random(11)
        for t in range(trial + 1):
            nodes = [M.tu.make_node(f"n{i}", cpu=rng.choice(["1", "2", "4"]),
                                    pods=rng.choice([3, 110]), labels={cases.HOST: f"n{i}"})
                     for i in range(6)]
            placed = [(prio(M, f"p{t}-{i}", rng.choice([0, 1, 5, 50]),
                            cpu=rng.choice(["1", "2"])), rng.choice(nodes).meta.name)
                      for i in range(14)]
            m = _build_map(M, nodes, [])
            for pod, node in placed:
                info = m[node]
                if (info.requested[0] + M.units.pod_request_vec(pod)[0] <= info.allocatable[0]
                        and len(info.pods) < info.allocatable_pods):
                    pod.spec.node_name = node
                    info.add_pod(pod)
            vip = prio(M, f"vip{t}", rng.choice([10, 100]), cpu=rng.choice(["1", "2", "4"]))
        return vip, m
    return build


def _decisions(pkg: str, build) -> list:
    """(node, victim keys) or None from the exhaustive oracle, the
    vectorized fast path (state) and branch-and-bound over the prefilter's
    candidates, in package ``pkg``."""
    M = _m(pkg)
    pod, m = build(M)
    oracle = M.pre.find_preemption_target(pod, m)
    state = M.pk.PreemptionState(m)
    cands = state.candidates_for(M.units.pod_request_vec(pod).units, pod.spec.priority)
    got = [oracle] + [M.pre.find_preemption_target_fast(pod, m, cands, **kw)
                      for kw in ({"state": state}, {})]
    return [None if t is None else (t.node_name, sorted(v.meta.key for v in t.victims))
            for t in got]


PARITY = {
    "simple_eviction": (_simple_eviction, ("n1", ["default/b"])),
    "prefers_lowest_max_victim_priority": (_lowest_max_victim_priority,
                                           ("n2", ["default/lowly"])),
    "reprieve_spares_high_priority": (_reprieve_spares_high_priority, ("n1", ["default/p1"])),
    "no_candidates": (_no_candidates, None),
    "insufficient_even_evicting_all": (_insufficient_even_evicting_all, None),
    "pod_count_dimension": (_pod_count_dimension, ("n1", ["default/a"])),
    "port_conflict_with_survivor": (_port_conflict_with_survivor, ("n2", ["default/mid"])),
    "affinity_preemptor": (_affinity_preemptor, "n1"),
    "overcommitted_node": (_overcommitted_node, ...),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_table_equals_the_jax_package(case):
    build, expect = PARITY[case]
    port = _decisions(cases.PORT, build)
    assert port == _decisions(cases.JAX, build)
    assert port[1] == port[0] and port[2] == port[0]  # both fast paths == oracle
    if expect is ...:
        return
    if isinstance(expect, str):
        assert port[0] is not None and port[0][0] == expect
    else:
        assert port[0] == expect


def test_parity_randomized_clusters_equal_the_jax_package():
    decided = 0
    for trial in range(8):
        port = _decisions(cases.PORT, _randomized(trial))
        assert port == _decisions(cases.JAX, _randomized(trial)), trial
        assert port[1] == port[0] and port[2] == port[0], trial
        decided += port[0] is not None
    assert decided > 0


# -- cohort end-to-end through the batch path (:196-331) ----------------------


def _batch_sched(pkg: str, nodes: list):
    M = _m(pkg)
    client = importlib.import_module(f"{pkg}.client")
    store = importlib.import_module(f"{pkg}.store")
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    cs = client.Clientset(store.Store())
    for name, cpu in nodes:
        cs.nodes.create(M.tu.make_node(name, cpu=cpu))
    algo = sched_mod.GenericScheduler()
    if pkg == cases.JAX:
        from kubernetes_tpu.ops import TPUBatchBackend

        backend = TPUBatchBackend(algorithm=algo, kernel_impl="xla")
    else:
        from kubernetes_tpu_torch.ops.backend import BatchBackend

        backend = BatchBackend(algorithm=algo, device="cpu")
    sched = sched_mod.Scheduler(cs, algorithm=algo, backend=backend)
    sched.start()
    return M, cs, sched


def _placed(cs) -> dict:
    return {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}


def _wave(M, cs, sched, pods: list) -> tuple:
    for p in pods:
        cs.pods.create(prio(M, *p[:2], cpu=p[2]))
    sched.pump()
    return sched.schedule_pending_batch()


def _cohort_run(pkg: str, nodes: list, waves: list) -> dict:
    """Each wave creates its pods and runs one batch; the record holds each
    batch's (bound, failed), the counters after each batch, the placements
    after each batch, the queue length, the Preempted events and rr."""
    M, cs, sched = _batch_sched(pkg, nodes)
    out = {"batches": [], "placed": []}
    for pods in waves:
        out["batches"].append((_wave(M, cs, sched, pods),
                               sched.metrics.preemption_attempts.value,
                               sched.metrics.preemption_victims.value, len(sched.queue)))
        out["placed"].append(_placed(cs))
    events, _ = cs.events.list()
    out["preempted_events"] = sum(1 for e in events if e.reason == "Preempted")
    out["rr"] = sched.algorithm._round_robin
    return out


def _cohort_twin(nodes, waves) -> dict:
    port = _cohort_run(cases.PORT, nodes, waves)
    assert port == _cohort_run(cases.JAX, nodes, waves)
    return port


def test_cohort_preemption_batch_path_equals_the_jax_package():
    nodes = [(f"n{i}", "2") for i in range(4)]
    got = _cohort_twin(nodes, [[(f"filler-{i}", 0, "1") for i in range(8)],
                               [(f"vip-{i}", 100, "2") for i in range(4)], []])
    (fill, *_), (wave, attempts, victims, _), (after, *_) = got["batches"]
    assert fill == (8, 0) and wave == (0, 4) and (attempts, victims) == (4, 8)
    assert after == (4, 0)
    assert sorted(got["placed"][-1]) == [f"vip-{i}" for i in range(4)]
    assert all(got["placed"][-1].values()) and got["preempted_events"] >= 1


def test_cohort_requeues_unpreemptable_with_backoff_as_the_jax_package():
    got = _cohort_twin([("n0", "1")], [[("vip", 100, "4")]])
    assert got["batches"] == [((0, 1), 1, 0, 0)]  # parked in backoff, not hot-requeued


def test_cohort_fits_now_grant_skips_eviction_as_the_jax_package():
    got = _cohort_twin([("big", "8"), ("small", "2")],
                       [[("fat-filler", 0, "8"), ("small-filler", 0, "2")],
                        [(f"vip-{i}", 100, "3") for i in range(2)], []])
    assert [b[0] for b in got["batches"]] == [(2, 0), (0, 2), (2, 0)]
    assert got["batches"][1][2] == 1  # one victim: vip-1 took vip-0's surplus
    placed = got["placed"][-1]
    assert "small-filler" in placed and "fat-filler" not in placed
    assert placed["vip-0"] == "big" and placed["vip-1"] == "big"


def test_cohort_sequential_state_update_as_the_jax_package():
    got = _cohort_twin([(f"n{i}", "2") for i in range(2)],
                       [[(f"filler-{i}-{j}", j, "1") for i in range(2) for j in range(2)],
                        [(f"vip-{i}", 100, "2") for i in range(2)], []])
    assert got["batches"][2][0][0] == 2
    assert sorted(n for k, n in got["placed"][-1].items() if k.startswith("vip")) == ["n0", "n1"]


# -- the per-pod path (tests/test_scheduler.py:277-348) -----------------------


def _oracle_run(pkg: str, nodes: list, steps: list, **sched_kw) -> dict:
    """The per-pod scheduler: each step creates pods and runs
    ``run_pending``.  Returns the placements after each step, the events
    by reason and the preemption counters."""
    M = _m(pkg)
    client = importlib.import_module(f"{pkg}.client")
    store = importlib.import_module(f"{pkg}.store")
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    cs = client.Clientset(store.Store())
    for name, cpu in nodes:
        cs.nodes.create(M.tu.make_node(name, cpu=cpu))
    sched = sched_mod.Scheduler(cs, **sched_kw)
    sched.start()
    placed = []
    for pods in steps:
        for name, priority, cpu in pods:
            cs.pods.create(prio(M, name, priority, cpu=cpu))
        sched.pump()
        sched.run_pending()
        placed.append(_placed(cs))
    events, _ = cs.events.list()
    return {"placed": placed, "reasons": sorted(e.reason for e in events),
            "counters": (sched.metrics.preemption_attempts.value,
                         sched.metrics.preemption_victims.value)}


def _oracle_twin(nodes, steps, **kw) -> dict:
    port = _oracle_run(cases.PORT, nodes, steps, **kw)
    assert port == _oracle_run(cases.JAX, nodes, steps, **kw)
    return port


def test_preemption_evicts_lower_priority_as_the_jax_package():
    got = _oracle_twin([("n1", "2")], [[("low-a", 0, "1"), ("low-b", 0, "1")],
                                       [("vip", 100, "1")]])
    final = got["placed"][-1]
    assert final["vip"] == "n1" and len(final) == 2
    assert "Preempted" in got["reasons"] and got["counters"] == (1, 1)


def test_preemption_minimal_victims_as_the_jax_package():
    got = _oracle_twin([("n1", "4")], [[(f"p{p}", p, "1") for p in (1, 2, 3)],
                                       [("vip", 100, "2")]])
    assert set(got["placed"][-1]) == {"p2", "p3", "vip"}


def test_no_preemption_among_equal_priority_as_the_jax_package():
    got = _oracle_twin([("n1", "1")], [[("a", 50, "1")], [("b", 50, "1")]])
    assert got["placed"][-1] == {"a": "n1", "b": ""} and got["counters"] == (1, 0)


def test_preemption_prefers_cheapest_node_as_the_jax_package():
    got = _oracle_twin([("n1", "1"), ("n2", "1")],
                       [[("mid", 5, "1")], [("lowly", 1, "1")], [("vip", 100, "1")]])
    lowly_node = got["placed"][1]["lowly"]
    final = got["placed"][-1]
    assert "lowly" not in final and final["vip"] == lowly_node and "mid" in final


def test_preemption_disabled_as_the_jax_package():
    got = _oracle_twin([("n1", "1")], [[("low", 0, "1")], [("vip", 100, "1")]],
                       enable_preemption=False)
    assert got["placed"][-1] == {"low": "n1", "vip": ""} and got["counters"] == (0, 0)


def test_the_scheduler_preempts_by_default():
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store import Store

    assert Scheduler(Clientset(Store())).enable_preemption is True


# -- the preset -----------------------------------------------------------------


@pytest.mark.timeout(120)
def test_run_preemption_binds_every_preemptor_with_one_victim_each():
    r = workload.run_preemption(30, device="cpu", seed=0)
    assert (r["fillers"], r["preemptors"]) == (120, 15)
    assert r["fill_bound"] == 120 and r["wave_failed"] == 15
    assert r["victims"] == r["attempts"] == r["preemptor_bound_after"] == 15
    assert r["fillers_bound"] + r["fillers_evicted"] == 120 and r["fillers_evicted"] == 15
    c = r["cohort"]
    assert c["preemptors"] == c["preempted"] == 15
    assert 0 < c["state_s"] + c["rank_s"] + c["evict_s"] <= c["total_s"]
    assert r["evictions_per_sec"] == pytest.approx(15 / c["total_s"])
    assert r["backend"]["oracle_pods"] == 0


@pytest.mark.timeout(120)
def test_run_preemption_odd_preemptors_take_branch_and_bound_exactly():
    """Preemptors with host ports or required affinity are not
    fast-eligible; every cohort decision still equals the exhaustive
    oracle on the state it was made on."""
    from kubernetes_tpu_torch.scheduler import preemption

    checked = []
    fast = preemption.find_preemption_target_fast

    def checking(pod, node_info_map, candidates, predicates=None, pvcs=None, pvs=None, **kw):
        got = fast(pod, node_info_map, candidates, predicates, pvcs=pvcs, pvs=pvs, **kw)
        want = preemption.find_preemption_target(pod, node_info_map, predicates, pvcs, pvs)
        assert (got.node_name, sorted(v.meta.key for v in got.victims)) == (
            want.node_name, sorted(v.meta.key for v in want.victims))
        checked.append(preemption._fast_eligible(pod, predicates))
        return got

    preemption.find_preemption_target_fast = checking
    try:
        r = workload.run_preemption(40, 160, 20, device="cpu", seed=3, odd_share=0.5)
    finally:
        preemption.find_preemption_target_fast = fast
    assert len(checked) == 20 and 0 < checked.count(False) < 20
    assert r["victims"] == r["preemptor_bound_after"] == 20
