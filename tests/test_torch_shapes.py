"""Segments the fused kernel used to refuse: more zones than it keeps in
registers (in shared memory, and past it in global memory), a batch whose
host ports outnumber a signature row's port slot, and a pod whose own
ports outnumber it (a kernel segment of its own).

On the CPU every kernel segment of ``BatchBackend(device="cpu")`` must pass
``fused_scan.plan`` (what the card's path calls before a launch), and the
bindings must equal the JAX package's ``TPUBatchBackend(kernel_impl="xla")``
and its oracle.  The ``cuda``-marked twin in ``test_torch_kernel.py``
holds the kernel's shared-memory zone path against ``scan_ref`` on a card.

Tolerance: exact equality of every binding and of the round-robin counter.
"""

import pytest
import torch

from kubernetes_tpu.ops.backend import TPUBatchBackend
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import backend as port_backend
from kubernetes_tpu_torch.ops import fused_scan, scan_ref
from kubernetes_tpu_torch.ops.backend import BatchBackend
from tests import torch_port_cases as cases


def _jax(build, **kw):
    M = cases.mods(cases.JAX)
    m, pods, pctx = build(cases.JAX, **kw)
    oracle = M.gs.GenericScheduler()
    want = cases.oracle_batch(cases.JAX, pods, m, pctx, oracle)
    algo = M.gs.GenericScheduler()
    got = TPUBatchBackend(algorithm=algo, kernel_impl="xla").schedule_batch(pods, m, pctx)
    assert got == want and algo._round_robin == oracle._round_robin
    return got, algo._round_robin


def _port_with_plans(build, monkeypatch, **kw):
    """The port's CPU backend, with the fused kernel's plan taken of every
    segment it scans."""
    plans = []
    real = scan_ref.scan

    def scan_and_plan(static, state):
        plans.append(fused_scan.plan(static))
        return real(static, state)

    monkeypatch.setattr(port_backend.scan_ref, "scan", scan_and_plan)
    M = cases.mods(cases.PORT)
    m, pods, pctx = build(cases.PORT, **kw)
    algo = M.gs.GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    got = backend.schedule_batch(pods, m, pctx)
    return got, algo._round_robin, backend, plans


@pytest.mark.parametrize("n_zones,n_nodes,where", [(12, 64, "shared"), (64, 160, "shared"),
                                                   (300, 1000, "shared"),
                                                   (1000, 1000, "global")])
def test_many_zones_plan_and_match_the_reference(monkeypatch, n_zones, n_nodes, where):
    kw = dict(n_zones=n_zones, n_nodes=n_nodes, n_pods=90)
    want, rr_want = _jax(cases.many_zones, **kw)
    got, rr_got, backend, plans = _port_with_plans(cases.many_zones, monkeypatch, **kw)
    assert got == want and rr_got == rr_want
    assert backend.stats["oracle_pods"] == 0 and plans
    for pl in plans:
        assert pl.zones_at == where
        if where == "shared":
            assert pl.msg_a >= 10 + 2 * n_zones and pl.zone_off >= pl.inbox_b_off
        else:
            assert pl.msg_a == 12 and pl.zone_off == 0
        assert pl.smem_bytes + fused_scan.STATIC_RESERVE <= fused_scan.SMEM_LIMIT


def test_host_ports_are_cut_under_the_kernels_vocabulary(monkeypatch):
    kw = dict(n_ports=300, n_nodes=24)
    want, rr_want = _jax(cases.host_ports, **kw)
    got, rr_got, backend, plans = _port_with_plans(cases.host_ports, monkeypatch, **kw)
    assert got == want and rr_got == rr_want
    assert backend.stats["oracle_pods"] == 0
    assert backend.stats["segments"] >= 2, "304 distinct ports do not fit one segment"
    assert all(0 < p.sw for p in plans)


def _wide_port_pod(pkg, **kw):
    """A small host-port batch with one pod whose own ports outnumber the
    kernel's vocabulary."""
    M = cases.mods(pkg)
    m, pods, pctx = cases.host_ports(pkg, n_ports=8, n_pods=0, n_nodes=4)
    pods.insert(3, M.tu.make_pod(
        "wide", cpu="100m", host_ports=list(range(20000, 20000 + fused_scan.MAX_PORTS + 1))))
    return m, pods, pctx


def test_a_pod_with_more_ports_than_the_slot_binds_in_a_segment_of_its_own(monkeypatch):
    """Such a pod is never sent to the oracle: it is a kernel segment of its
    own on both devices (the card reads its flags past the row's shared
    slot from global memory), the bindings equal the JAX package's, and
    the segments after it keep their port width."""
    want, rr_want = _jax(_wide_port_pod)
    got, rr_got, backend, plans = _port_with_plans(_wide_port_pod, monkeypatch)
    assert got == want and rr_got == rr_want
    assert backend.stats["oracle_pods"] == 0 and backend.stats["segments"] == 3
    m, pods, _ = _wide_port_pod(cases.PORT)
    for device in ("cpu", "cuda"):
        backend.device = torch.device(device)  # the cut is the same on both
        segs = backend._segments(pods)
        assert [k for k, _ in segs] == ["kernel", "kernel", "kernel"]
        assert segs[1][1] == [(3, pods[3])]
    assert [pl.sws < pl.sw for pl in plans] == [False, True, False]
    assert plans[2].sw == plans[0].sw, "the wide pod widened the next segment's rows"
    assert backend.tensorizer._sticky["ports"] <= fused_scan.MAX_PORTS


def test_no_zone_count_is_refused_and_the_planner_places_them():
    """Past shared memory's zone budget the planner keeps the statistics
    in global memory; check_shape names no zone limit."""
    static, init = cases.tensorize(cases.PORT, "many_zones", n_zones=1000, n_nodes=1000,
                                   n_pods=20)
    assert static.num_zones == 1000
    s, st = from_reference(vars(static), vars(init), "cpu")
    fused_scan.check_shape(s)
    pl = fused_scan.plan(s)
    assert pl.zones_at == "global" and pl.cs == 4
    b = fused_scan.pack(s, st, pl)
    assert b["zbuf"].numel() == fused_scan.zbuf_words(1000, pl.cs) and not b["zbuf"].any()
    assert fused_scan.params(s, st, b, pl).zbuf == b["zbuf"].data_ptr()
