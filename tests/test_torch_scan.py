"""The port's plain scan against the JAX package's scans on the very same
input: the JAX tensorizer's BatchStatic/InitialState go through
``carry.from_reference`` into ``scan_ref.scan`` on the CPU, and must equal
both the XLA scan (``schedule_batch_arrays``) and the fused Pallas kernel
run in interpret mode.  Tolerance: exact equality of the chosen node
indices and the final round-robin counter."""

import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.pallas_kernel as pk
from kubernetes_tpu.ops.batch_kernel import schedule_batch_arrays
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import scan_ref
from tests import torch_port_cases as cases


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    pk._pallas_runner.cache_clear()
    yield
    pk._pallas_runner.cache_clear()


def _port_scan(static, init, device="cpu"):
    s, st = from_reference(vars(static), vars(init), device)
    chosen, rr = scan_ref.scan(s, st)
    return chosen.cpu().numpy(), rr


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_scan_ref_matches_xla_scan(case):
    static, init = cases.tensorize(cases.JAX, case)
    want, rr_want = schedule_batch_arrays(static, init)
    got, rr_got = _port_scan(static, init)
    assert rr_got == rr_want
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", ["plain", "mixed", "terms_only", "volumes_only",
                                  "ties", "few_feasible"])
def test_scan_ref_matches_pallas_interpret(case, interpret_pallas):
    static, init = cases.tensorize(cases.JAX, case)
    want, rr_want = pk.schedule_batch_pallas(static, init)
    got, rr_got = _port_scan(static, init)
    assert rr_got == rr_want
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cases_cover_ties_and_feasibility_edges():
    """The tie case rotates over several nodes, and the edge case has both
    unschedulable (n_feasible == 0) and pinned (n_feasible == 1) pods."""
    static, init = cases.tensorize(cases.JAX, "ties")
    got, rr = _port_scan(static, init)
    assert len(set(got.tolist())) == 9 and rr == init.round_robin + len(got)
    static, init = cases.tensorize(cases.JAX, "few_feasible")
    got, rr = _port_scan(static, init)
    pinned = [k for k, p in enumerate(static.pod_names) if "pin" in p]
    big = [k for k, p in enumerate(static.pod_names) if "big" in p]
    assert (got[big] == -1).all()
    assert (got[pinned] == static.node_names.index("n2")).all()


def test_scan_ref_leaves_state_untouched_and_rr_offset():
    static, init = cases.tensorize(cases.JAX, "ties")
    init.round_robin = 7
    s, st = from_reference(vars(static), vars(init), "cpu")
    before = st.requested.clone()
    got, rr = scan_ref.scan(s, st)
    assert torch.equal(st.requested, before)
    want, rr_want = schedule_batch_arrays(static, init)
    assert rr == rr_want == 7 + len(got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
