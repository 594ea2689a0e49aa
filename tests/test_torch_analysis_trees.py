"""Cross-tree parity of the language-agnostic passes (races, concurrency,
metrics, tracecov, parity): on the JAX package's default scopes and on
the port's, given as explicit scope lists, the JAX pass and the port's
give the same ``(code, path, line, symbol, message)`` list.  Each pass
runs once per package and tree.  And the port's baseline holds only the
JAX baseline's six keys retargeted at the port's paths, and findings that
only the port's tree has.

Tolerance: exact equality."""

from __future__ import annotations

import importlib

import pytest

from kubernetes_tpu_torch.analysis import core as pcore
from kubernetes_tpu_torch.analysis.core import load_baseline, repo_root

ROOT = repo_root()
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
GROUP_A = ("parity", "races", "metrics", "tracecov", "concurrency")


def _scopes(tree: str) -> dict:
    """A package's default scopes, as explicit lists."""
    def m(mod):
        return importlib.import_module(f"{tree}.analysis.{mod}")

    return {
        "parity": {"oracle_paths": list(m("parity").DEFAULT_ORACLE_PATHS),
                   "kernel_paths": list(m("parity").DEFAULT_KERNEL_PATHS)},
        "races": {"paths": list(m("races").DEFAULT_PATHS)},
        "metrics": {"paths": list(m("metrics_lint").DEFAULT_PATHS)},
        "tracecov": {"paths": list(m("tracecov").DEFAULT_PATHS),
                     "hot_modules": list(m("tracecov").HOT_PATH_MODULES),
                     "phase_files": list(m("tracecov").PHASE_FILES)},
        "concurrency": {"paths": list(m("concurrency_hazards").DEFAULT_PATHS)},
    }


@pytest.fixture(scope="module")
def results() -> dict:
    """(tree, package) -> pass -> the normalized finding list."""
    out = {}
    for tree in PACKAGES:
        scopes = _scopes(tree)
        for pkg in PACKAGES:
            core = importlib.import_module(f"{pkg}.analysis.core")
            report = core.run_analysis(root=ROOT, passes=list(GROUP_A), scopes=scopes)
            by_pass = {p: [] for p in GROUP_A}
            for f in report.findings:
                by_pass[core._CODE_PREFIX_PASS[f.code[:2]]].append(
                    (f.code, f.path, f.line, f.symbol,
                     f.message.replace("kubernetes_tpu_torch", "kubernetes_tpu")))
            out[tree, pkg] = by_pass
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("pass_name", GROUP_A)
@pytest.mark.parametrize("tree", PACKAGES)
def test_equal_findings_on_both_trees(results, tree, pass_name):
    jax, port = results[tree, "kubernetes_tpu"][pass_name], results[tree, "kubernetes_tpu_torch"][pass_name]
    assert port == jax, (port, jax)


def test_the_jax_trees_unbaselined_finding_is_found_by_both(results):
    for pkg in PACKAGES:
        keys = {(c, p, s) for c, p, _ln, s, _m in results["kubernetes_tpu", pkg]["tracecov"]}
        assert ("TC501", "kubernetes_tpu/store/store.py",
                "Store._flush_pending_locked.store.coalesce") in keys


def test_the_ports_baseline_is_the_jax_keys_and_port_only_findings(results):
    """Every group-A finding on the port's tree is baselined (or none is
    left); an entry either is one of the JAX baseline's keys retargeted
    (same code, same name), or names a finding the JAX pass does not make
    on the JAX tree at that path."""
    baseline = load_baseline(pcore.default_baseline_path())
    jax_baseline = load_baseline(importlib.import_module(
        "kubernetes_tpu.analysis.core").default_baseline_path())
    port_keys = {f"{c}:{p}:{s}" for fs in results["kubernetes_tpu_torch",
                                                  "kubernetes_tpu_torch"].values()
                 for c, p, _ln, s, _m in fs}
    assert port_keys == {k for k in baseline if k[:2] not in ("TS", "DC")}

    def tail(key):
        code, _path, symbol = key.split(":", 2)
        return code, symbol.rsplit(".", 1)[-1]

    retargeted = {tail(k) for k in jax_baseline}
    assert retargeted <= {tail(k) for k in baseline}
    jax_tree = {(c, p, s) for fs in results["kubernetes_tpu", "kubernetes_tpu"].values()
                for c, p, _ln, s, _m in fs}
    for key in baseline:
        if tail(key) in retargeted:
            continue
        code, path, symbol = key.split(":", 2)
        jax_path = "kubernetes_tpu/" + path.split("/", 1)[1]
        assert (code, jax_path, symbol) not in jax_tree, key
