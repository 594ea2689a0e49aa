"""Segments the fused kernel used to refuse: more zones than it keeps in
registers, and a batch whose host ports outnumber its port vocabulary.
A pod whose own ports outnumber it is refused on the card before launch,
and it alone.

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


@pytest.mark.parametrize("n_zones,n_nodes", [(12, 64), (64, 160)])
def test_many_zones_plan_and_match_the_reference(monkeypatch, n_zones, n_nodes):
    kw = dict(n_zones=n_zones, n_nodes=n_nodes, n_pods=90)
    want, rr_want = _jax(cases.many_zones, **kw)
    got, rr_got, backend, plans = _port_with_plans(cases.many_zones, monkeypatch, **kw)
    assert got == want and rr_got == rr_want
    assert backend.stats["oracle_pods"] == 0 and plans
    for pl in plans:
        assert pl.msg_a >= 10 + 2 * n_zones and pl.zone_off >= pl.inbox_b_off
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


def test_a_pod_with_more_ports_than_the_vocabulary_is_refused_on_the_card():
    """Such a pod is never sent to the oracle.  The card's path refuses the
    batch before tensorizing it, with the kernel's limit; the CPU's plain
    scan takes the pod as a kernel segment of its own, and the bindings
    equal the JAX package's."""
    want, rr_want = _jax(_wide_port_pod)
    M = cases.mods(cases.PORT)
    m, pods, pctx = _wide_port_pod(cases.PORT)
    algo = M.gs.GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    segs = backend._segments(pods)
    assert [k for k, _, _ in segs] == ["kernel", "kernel", "kernel"]
    assert segs[1][1] == [(3, pods[3])]
    got = backend.schedule_batch(pods, m, pctx)
    assert got == want and algo._round_robin == rr_want
    assert backend.stats["oracle_pods"] == 0 and backend.stats["segments"] == 3
    # the card's branch of the same cut: the pod alone is refused, before
    # anything is tensorized, with the kernel's limit
    backend.device = torch.device("cuda")
    card = backend._segments(pods)
    assert [k for k, _, _ in card] == ["kernel", "refused", "kernel"]
    assert card[1][1] == [(3, pods[3])] and card[0][1] == segs[0][1] and card[2][1] == segs[2][1]
    assert [r for _, _, r in segs] == [None, None, None] and card[0][2] is card[2][2] is None
    assert str(card[1][2]) == (
        f"fused scan supports at most {fused_scan.MAX_PORTS} host ports a segment, pod "
        f"default/wide has 257")


def test_zone_cap_is_derived_and_still_refuses_above_it():
    assert fused_scan.MAX_ZONES >= 64
    assert fused_scan.zone_bytes(fused_scan.MAX_ZONES) <= fused_scan.ZONE_SMEM
    assert fused_scan.zone_bytes(fused_scan.MAX_ZONES + 1) > fused_scan.ZONE_SMEM
    static, init = cases.tensorize(cases.PORT, "many_zones")
    assert static.num_zones > fused_scan.REG_ZONES
    static.num_zones = fused_scan.MAX_ZONES + 1
    s, _ = from_reference(vars(static), vars(init), "cpu")
    with pytest.raises(ValueError, match=f"at most {fused_scan.MAX_ZONES} zones"):
        fused_scan.check_shape(s)
