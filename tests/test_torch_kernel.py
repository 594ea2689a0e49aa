"""The fused CUDA scan (``ops/fused_scan.py`` + ``ops/csrc/fused_scan.cu``).

Its host packing, CPU refusal and shape guard are checked here on CPU
tensors.  The ``cuda``-marked tests also hold the zone statistics in
shared and in global memory, and a signature row wider than its shared
port slot, against the plain scan.  The kernel itself has no CPU mode: the ``cuda``-marked test holds
it against the plain scan on a card and skips with a reason elsewhere.
This file imports nothing of the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py

Tolerance: exact equality of chosen node indices and round-robin counter."""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import fused_scan, scan_ref
from tests import torch_port_cases as cases


def test_pack_layout_on_cpu_tensors():
    """The kernel's packed layout, checked against the ScanStatic it came
    from (packing is plain torch code and runs anywhere)."""
    static, init = cases.tensorize(cases.PORT, "mixed")
    s, st = from_reference(vars(static), vars(init), "cpu")
    pl = fused_scan.plan(s)
    b = fused_scan.pack(s, st, pl)
    assert all(t.is_contiguous() for t in b.values())
    n, r = s.node_alloc.shape
    assert b["alloc"].shape[1] == pl.ns >= n
    assert torch.equal(b["alloc"][:, :n], s.node_alloc.t().int())
    assert not b["exists"][n:].any()  # padded columns are never feasible
    assert torch.equal(b["spread_inc_t"][3, :s.spread_inc.shape[0]], s.spread_inc[:, 3])
    w = s.pod_vol_ids.shape[1]
    pv, pad = b["pod_vol"][:, :w], b["pod_vol"][:, w:]
    assert b["pod_vol"].shape[1] == pl.w4 and not pad.any()
    assert torch.equal(pv >> 6, s.pod_vol_ids)
    assert torch.equal((pv >> 3) & 7, s.pod_vol_kind)
    assert torch.equal((pv & 1).bool(), s.pod_vol_valid)
    assert torch.equal(((pv >> 1) & 1).bool(), s.pod_vol_count_only)
    assert torch.equal(((pv >> 2) & 1).bool(), s.pod_vol_ro_ok)
    assert torch.equal((b["volf"][:, :n] & 1).bool(), st.vol_any)
    assert torch.equal(((b["volf"][:, :n] >> 1) & 1).bool(), st.vol_ns)
    # one signature row: request, nonzero, spread flag, active terms
    # (TERM_FIELDS fields each, active first in term order), host ports
    sig, t, nf = b["sig"], s.term_matches_sig.shape[0], fused_scan.TERM_FIELDS
    assert sig.shape[1] == pl.sw
    assert torch.equal(sig[:, :r], s.g_request)
    assert torch.equal(sig[:, r:r + 2], s.g_nonzero)
    assert torch.equal(sig[:, r + 2].bool(), s.g_has_spread)
    ports = sig[:, r + 4 + nf * t: r + 4 + nf * t + s.g_ports.shape[1]]
    assert torch.equal(ports.bool(), s.g_ports)
    for g in range(s.static_ok.shape[0]):
        active = {k for k in range(t)
                  if s.term_matches_sig[k, g] or s.own_all[g, k] or s.own_w[g, k]}
        cnt = int(sig[g, r + 3])
        assert cnt == len(active)
        entries = sig[g, r + 4: r + 4 + nf * t].reshape(t, nf)
        assert entries[:cnt, 0].tolist() == sorted(active)
        for tt, m, ra, raa, own_all, own_w, symw, symraa, selfm in entries[:cnt].tolist():
            assert m == int(s.term_matches_sig[tt, g]) and ra == int(s.own_ra[g, tt])
            assert raa == int(s.own_raa[g, tt]) and own_all == int(s.own_all[g, tt])
            assert own_w == int(s.own_w[g, tt]) and symw == m * int(s.sym_w[tt])
            assert symraa == int(m and s.is_raa[tt]) and selfm == int(s.self_match[tt])
    # working state planes are copies: the kernel may update them in place
    assert b["cnt"].data_ptr() != st.pod_count.data_ptr()
    assert b["dm"].data_ptr() != st.dm.data_ptr()


def test_fused_scan_refuses_cpu_tensors():
    static, init = cases.tensorize(cases.PORT, "plain")
    s, st = from_reference(vars(static), vars(init), "cpu")
    before = fused_scan.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_scan.schedule(s, st)
    assert fused_scan.launches == before


def test_shape_guard_names_the_limit():
    """The guard names what is past the kernel's fixed arrays; zones and
    host ports are not among them any more."""
    static, init = cases.tensorize(cases.PORT, "plain")
    static.num_zones = 5000
    s, _ = from_reference(vars(static), vars(init), "cpu")
    fused_scan.check_shape(s)
    s.vol_limits = torch.zeros(fused_scan.MAX_KINDS + 1, dtype=s.vol_limits.dtype)
    with pytest.raises(ValueError, match="volume kinds"):
        fused_scan.check_shape(s)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_fused_kernel_matches_scan_ref_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused scan is a CUDA kernel with no CPU mode")
    static, init = cases.tensorize(cases.PORT, case)
    s, st = from_reference(vars(static), vars(init), "cuda")
    want, rr_want = scan_ref.scan(s, st)
    got, rr_got = fused_scan.schedule(s, st)
    assert rr_got == rr_want
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_plan_fits_the_card(case):
    """The planner reserved enough shared memory for the kernel's static
    arrays, and the card can place at least one cluster of the plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan is checked by the CUDA runtime")
    static, init = cases.tensorize(cases.PORT, case)
    s, st = from_reference(vars(static), vars(init), "cuda")
    pl = fused_scan.plan(s)
    q = fused_scan.query(s, st, fused_scan.pack(s, st, pl), pl)
    assert q["static_smem"] <= fused_scan.STATIC_RESERVE
    assert q["max_active_clusters"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_zones,n_nodes,where", [
    (16, 64, "shared"), (64, 300, "shared"), (235, 5000, "shared"),
    # past the shared-memory budget at 16 blocks, and at 4 blocks
    (236, 5000, "global"), (300, 1000, "shared"), (1000, 1000, "global")])
def test_zone_path_matches_scan_ref_on_card(n_zones, n_nodes, where):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused scan is a CUDA kernel with no CPU mode")
    static, init = cases.tensorize(cases.PORT, "many_zones", n_zones=n_zones,
                                   n_nodes=n_nodes, n_pods=200)
    assert static.num_zones == n_zones > fused_scan.REG_ZONES
    s, st = from_reference(vars(static), vars(init), "cuda")
    assert fused_scan.plan(s).zones_at == where
    want, rr_want = scan_ref.scan(s, st)
    got, rr_got = fused_scan.schedule(s, st)
    assert rr_got == rr_want
    np.testing.assert_array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_ports,wide", [(8, fused_scan.MAX_PORTS + 1), (40, 700), (60, 1000)])
def test_wide_port_row_matches_scan_ref_on_card(n_ports, wide):
    """A segment whose port vocabulary is wider than a signature row's
    shared slot (one pod with ``wide`` ports of its own, or ``n_ports``
    pods of one port each): flags past the slot come from global memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused scan is a CUDA kernel with no CPU mode")
    static, init = cases.tensorize(cases.PORT, "host_ports", n_ports=n_ports, n_nodes=24,
                                   wide=wide)
    s, st = from_reference(vars(static), vars(init), "cuda")
    pl = fused_scan.plan(s)
    assert s.g_ports.shape[1] > fused_scan.MAX_PORTS and pl.sws < pl.sw
    want, rr_want = scan_ref.scan(s, st)
    got, rr_got = fused_scan.schedule(s, st)
    assert rr_got == rr_want
    np.testing.assert_array_equal(got, want.cpu().numpy())
