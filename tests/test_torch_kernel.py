"""The fused CUDA scan (``ops/fused_scan.py`` + ``ops/csrc/fused_scan.cu``).

Its host packing, CPU refusal and shape guard are checked here on CPU
tensors.  The kernel itself has no CPU mode: the ``cuda``-marked test holds
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
    b = fused_scan.pack(s, st)
    assert all(t.is_contiguous() for t in b.values())
    assert torch.equal(b["alloc"], s.node_alloc.t().int())
    assert torch.equal(b["spread_inc_t"][3], s.spread_inc[:, 3])
    pv = b["pod_vol"]
    assert torch.equal(pv >> 6, s.pod_vol_ids)
    assert torch.equal((pv >> 3) & 7, s.pod_vol_kind)
    assert torch.equal((pv & 1).bool(), s.pod_vol_valid)
    assert torch.equal(((pv >> 1) & 1).bool(), s.pod_vol_count_only)
    assert torch.equal(((pv >> 2) & 1).bool(), s.pod_vol_ro_ok)
    assert torch.equal((b["volf"] & 1).bool(), st.vol_any)
    assert torch.equal(((b["volf"] >> 1) & 1).bool(), st.vol_ns)
    t = s.term_matches_sig.shape[0]
    for g in range(s.static_ok.shape[0]):
        active = {k for k in range(t)
                  if s.term_matches_sig[k, g] or s.own_all[g, k] or s.own_w[g, k]}
        n = int(b["term_count"][g])
        assert n == len(active)
        assert b["term_list"][g, :n].tolist() == sorted(active)
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
    static, init = cases.tensorize(cases.PORT, "plain")
    static.num_zones = fused_scan.MAX_ZONES + 1
    s, _ = from_reference(vars(static), vars(init), "cpu")
    with pytest.raises(ValueError, match="zones"):
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
