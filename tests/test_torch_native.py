"""The port's host helpers (``kubernetes_tpu_torch/native.py``): the native
label matcher and the native deep copy, held against the port's own Python
versions and against the JAX package's ``kubernetes_tpu.native`` on the
same seeded inputs.

Tolerance: exact equality of every match bit and every copied value.
"""

from __future__ import annotations

import copy
import os
import random

import numpy as np
import pytest

import kubernetes_tpu.native as jax_native
import kubernetes_tpu_torch.native as native
from kubernetes_tpu_torch.api.selectors import LabelSelector, Requirement
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.store.store import _py_fast_deepcopy
from tests import torch_port_cases as cases


def random_labels(rng):
    return {f"k{rng.randrange(6)}": f"v{rng.randrange(4)}" for _ in range(rng.randrange(5))}


def random_selector(rng):
    reqs = []
    for _ in range(rng.randrange(1, 4)):
        op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt", "Eq"])
        key = f"k{rng.randrange(6)}"
        if op in ("Gt", "Lt"):
            key, values = "num", [str(rng.randrange(10))]
        elif op in ("Exists", "DoesNotExist"):
            values = []
        else:
            values = [f"v{rng.randrange(4)}" for _ in range(rng.randrange(1, 3))]
        reqs.append((key, op, values))
    return reqs


def py_eval(reqs, labels):
    for key, op, values in reqs:
        if op == "Eq":
            if labels.get(key) != values[0]:
                return False
        elif not Requirement(key, op, list(values)).matches(labels):
            return False
    return True


def _corpus(seed):
    rng = random.Random(seed)
    labelmaps = []
    for _ in range(60):
        labels = random_labels(rng)
        if rng.random() < 0.5:
            labels["num"] = str(rng.randrange(-5, 15))
        labelmaps.append(labels)
    return labelmaps, [random_selector(rng) for _ in range(40)]


def _matrix(engine, labelmaps, selectors):
    lids = [engine.add_labelmap(m) for m in labelmaps]
    sids = [engine.add_selector(s) for s in selectors]
    return engine.match_matrix(sids, lids), engine.match_any(sids[:5], lids)


def test_native_library_builds_into_the_ports_build_dir():
    assert native.get_lib() is not None, "the host has g++: the native build must work"
    built = [f for f in os.listdir(native.BUILD_DIR) if f.startswith("liblabelmatch-")]
    assert built, "the library is built under kubernetes_tpu_torch/_build"
    assert native.CSRC == os.path.join(os.path.dirname(native.__file__), "csrc")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_matrix_equals_python_semantics_and_the_reference(seed):
    labelmaps, selectors = _corpus(seed)
    eng = native.MatchEngine()
    assert eng.native
    got, got_any = _matrix(eng, labelmaps, selectors)
    want = np.array([[py_eval(s, m) for m in labelmaps] for s in selectors])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_any, want[:5].any(axis=0))
    ref, ref_any = _matrix(jax_native.MatchEngine(), labelmaps, selectors)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_any, ref_any)


def test_python_fallback_equals_native(monkeypatch):
    labelmaps, selectors = _corpus(3)
    native_out = _matrix(native.MatchEngine(), labelmaps, selectors)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    eng = native.MatchEngine()
    assert not eng.native
    py_out = _matrix(eng, labelmaps, selectors)
    for a, b in zip(native_out, py_out):
        np.testing.assert_array_equal(a, b)


def test_match_any_and_simple_selectors():
    eng = native.MatchEngine()
    lids = [eng.add_labelmap({"app": "web"}), eng.add_labelmap({"app": "db"}),
            eng.add_labelmap({})]
    sids = [eng.add_simple_selector({"app": "web"}), eng.add_simple_selector({"app": "db"})]
    assert eng.match_any(sids, lids).tolist() == [True, True, False]
    assert eng.match_matrix([], lids).shape == (0, 3)


def test_label_selector_bridge():
    eng = native.MatchEngine()
    sel = LabelSelector(match_labels={"app": "web"},
                        match_expressions=[Requirement("tier", "NotIn", ["legacy"])])
    sid = eng.add_label_selector(sel)
    lids = [eng.add_labelmap({"app": "web", "tier": "modern"}),
            eng.add_labelmap({"app": "web", "tier": "legacy"}),
            eng.add_labelmap({"app": "web"})]  # a missing key satisfies NotIn
    assert eng.match_matrix([sid], lids).tolist() == [[True, False, True]]


def test_gt_lt_non_numeric():
    eng = native.MatchEngine()
    sid = eng.add_selector([("cores", "Gt", ["4"])])
    lids = [eng.add_labelmap({"cores": "8"}), eng.add_labelmap({"cores": "abc"}),
            eng.add_labelmap({})]
    assert eng.match_matrix([sid], lids).tolist() == [[True, False, False]]


def _random_json(rng, depth=0):
    r = rng.random()
    if depth > 3 or r < 0.3:
        return rng.choice([None, True, 3, -7, 2.5, "s", f"x{rng.randrange(9)}"])
    if r < 0.65:
        return {f"k{i}": _random_json(rng, depth + 1) for i in range(rng.randrange(4))}
    return [_random_json(rng, depth + 1) for _ in range(rng.randrange(4))]


def _containers(x, out):
    if isinstance(x, (dict, list)):
        out.append(x)
        for v in (x.values() if isinstance(x, dict) else x):
            _containers(v, out)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fastcopy_equals_deepcopy_with_fresh_containers(seed):
    fn = native.get_fastcopy()
    assert fn is not None, "the host has gcc and the CPython headers"
    rng = random.Random(seed)
    for _ in range(50):
        src = {"top": _random_json(rng), "m": {"labels": {"a": "b"}, "l": [1, {"y": None}]}}
        for copier in (fn, _py_fast_deepcopy, jax_native.get_fastcopy() or copy.deepcopy):
            got = copier(src)
            assert got == copy.deepcopy(src)
            ids = {id(c) for c in _containers(src, [])}
            assert not ids & {id(c) for c in _containers(got, [])}


def test_store_isolation_with_the_active_copier():
    s = Store()
    stored = s.create("Pod", {"kind": "Pod", "metadata": {"name": "p", "namespace": "default",
                                                          "labels": {"k": "v"}}})
    stored["metadata"]["labels"]["k"] = "hacked"
    assert s.get("Pod", "default", "p")["metadata"]["labels"]["k"] == "v"


def test_helpers_report_which_version_serves(monkeypatch):
    assert native.helpers() == {"matcher": "native", "fastcopy": "native"}
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "get_fastcopy", lambda: None)
    assert native.helpers() == {"matcher": "python", "fastcopy": "python"}


def test_a_failed_build_falls_back_and_an_edited_source_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    src = tmp_path / "k.c"
    src.write_text("int f(void) { return 1; }\n")
    first = native._compile("k", ["gcc", "-O2", "-shared", "-fPIC"], str(src))
    assert first and os.path.dirname(first) == str(tmp_path / "_build")
    assert native._compile("k", ["gcc", "-O2", "-shared", "-fPIC"], str(src)) == first
    src.write_text("int f(void) { return 2; }\n")
    assert native._compile("k", ["gcc", "-O2", "-shared", "-fPIC"], str(src)) != first
    src.write_text("this is not C\n")
    assert native._compile("k", ["gcc", "-O2", "-shared", "-fPIC"], str(src)) is None


def test_tensorizer_counts_equal_with_native_and_python_engines(monkeypatch):
    """The tensorizer's initial state (spread and affinity counts come from
    the matcher) is the same with either engine."""
    static, init = cases.tensorize(cases.PORT, "mixed")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    static_py, init_py = cases.tensorize(cases.PORT, "mixed")
    for k, v in vars(init).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, vars(init_py)[k], err_msg=k)
