"""The port's CPU oracle (``GenericScheduler``) against the JAX package's
on seeded clusters in the style of ``test_parity.py``: each package builds
the same cluster with its own objects and schedules the batch sequentially
with cache feedback.  Tolerance: exact equality of every binding and of the
final round-robin counter."""

import pytest

from tests import torch_port_cases as cases


def _run(pkg, case, priorities=None, **kw):
    M = cases.mods(pkg)
    m, pods, pctx = cases.CASES[case](pkg, **kw)
    prio = getattr(M.priorities, priorities)() if priorities else None
    algo = M.gs.GenericScheduler(priorities=prio)
    return cases.oracle_batch(pkg, pods, m, pctx, algo), algo._round_robin


@pytest.mark.parametrize("case,kw", [
    ("mixed", {}),
    ("mixed", {"seed": 5, "n_nodes": 16, "n_pods": 70}),
    ("terms_only", {}),
    ("volumes_only", {}),
    ("ties", {}),
    ("few_feasible", {}),
])
def test_oracle_matches_reference(case, kw):
    want, rr_want = _run(cases.JAX, case, **kw)
    got, rr_got = _run(cases.PORT, case, **kw)
    assert got == want
    assert rr_got == rr_want


def test_oracle_matches_reference_most_requested():
    want, rr_want = _run(cases.JAX, "plain", priorities="cluster_autoscaler_priorities")
    got, rr_got = _run(cases.PORT, "plain", priorities="cluster_autoscaler_priorities")
    assert got == want and rr_got == rr_want
