"""The port's tensorizer against the JAX package's: the same seeded cluster,
built by each package with its own objects, must tensorize to equal arrays.
Tolerance: exact equality (every array is integer or boolean)."""

import numpy as np
import pytest

from tests import torch_port_cases as cases

STATIC_FIELDS = (
    "n_pad", "num_zones", "v_state", "use_vols", "use_ports", "node_names",
    "node_exists", "node_alloc", "node_alloc_pods", "node_zone", "group_of_pod",
    "static_ok", "node_aff_raw", "taint_intol_raw", "static_score", "g_request",
    "g_nonzero", "g_ports", "port_vocab", "g_has_spread", "spread_inc",
    "interpod_raw", "term_matches_sig", "sym_w", "own_w", "own_ra", "own_raa",
    "own_all", "is_raa", "self_match", "node_domain", "dom_valid", "vol_vocab",
    "pod_vol_ids", "pod_vol_valid", "pod_vol_ro_ok", "pod_vol_kind",
    "pod_vol_count_only", "vol_limits", "weights",
)
INIT_FIELDS = (
    "requested", "nonzero_requested", "pod_count", "ports_used", "spread_counts",
    "round_robin", "dm", "downer", "total_match", "vol_any", "vol_ns", "nk",
)


def _assert_same(ref, got, fields, what):
    for f in fields:
        a, b = getattr(ref, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{what}.{f}"
            assert np.array_equal(a, b), f"{what}.{f} differs"
        else:
            assert a == b, f"{what}.{f}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", sorted(cases.CASES))
def test_tensorizer_matches_reference(case):
    ref_static, ref_init = cases.tensorize(cases.JAX, case)
    static, init = cases.tensorize(cases.PORT, case)
    assert len(ref_static.terms) == len(static.terms)
    _assert_same(ref_static, static, STATIC_FIELDS, "BatchStatic")
    _assert_same(ref_init, init, INIT_FIELDS, "InitialState")


def test_mixed_case_exercises_every_plane():
    static, init = cases.tensorize(cases.PORT, "mixed")
    assert static.terms and static.use_vols and static.use_ports
    assert static.num_zones == 3 and static.g_has_spread.any()
    assert static.taint_intol_raw.any() and static.node_aff_raw.any()
    assert static.interpod_raw.any() and init.vol_any.any() and init.dm.any()
    assert (~static.static_ok[: static.group_of_pod.max() + 1, :12]).any()
