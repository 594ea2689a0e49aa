"""The port's analysis CLI on its own tree: ``python -m
kubernetes_tpu_torch.analysis`` keeps the reference CLI's flags and exit
codes, and ``--prune-baseline`` round-trips.

Both tests are written here rather than run from the JAX module: one key
of the port's baseline anchors two findings (the same fault seam on two
lines of one function), so ``--no-baseline`` lists exactly the
baseline's keys, not one finding a key as the JAX tests count.  The gate
itself is ``tests/test_torch_analysis_gate.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from kubernetes_tpu_torch.analysis import core as pcore
from kubernetes_tpu_torch.analysis.core import load_baseline, repo_root

ROOT = repo_root()


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.analysis", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.timeout(300)
def test_cli_exit_codes():
    clean = _cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "warning" not in clean.stdout  # no stale baseline entry
    baseline = load_baseline(pcore.default_baseline_path())
    as_json = _cli("--json", "--no-baseline")
    doc = json.loads(as_json.stdout)
    assert doc["passes"] == ["trace", "parity", "races", "metrics", "tracecov", "device",
                             "concurrency"]
    # --no-baseline re-exposes exactly what the baseline suppresses
    assert {f["key"] for f in doc["findings"]} == set(baseline), doc["findings"]
    assert as_json.returncode == (1 if baseline else 0), as_json.stdout
    assert as_json.stdout.strip() == json.dumps(doc, indent=2, sort_keys=True)
    assert set(doc["counts"]) == set(pcore.PASS_NAMES)
    for per in doc["counts"].values():
        assert set(per) == {"findings", "suppressed"}
        assert per["suppressed"] == 0
    assert sum(per["findings"] for per in doc["counts"].values()) == len(doc["findings"])
    assert doc["counts"]["trace"]["findings"] == doc["counts"]["device"]["findings"] == 0
    assert set(doc["timings_ms"]) == set(pcore.PASS_NAMES)
    # usage errors
    assert _cli("--baseline", os.path.join(ROOT, "no-such-baseline.json")).returncode == 2
    listed = _cli("--list-passes")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == list(pcore.PASS_NAMES)


@pytest.mark.timeout(300)
def test_cli_prune_baseline_round_trip(tmp_path):
    """--prune-baseline drops exactly the stale entries, keeping the
    header and the surviving entries' order and reasons; a second run on
    the pruned file is clean with nothing stale."""
    with open(pcore.default_baseline_path(), encoding="utf-8") as f:
        doc = json.load(f)
    ghost = {"key": "RL999:nowhere.py:Ghost.method.attr", "reason": "points at nothing"}
    doc["suppressions"] = doc["suppressions"] + [ghost]
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(doc, indent=2) + "\n")
    assert _cli("--prune-baseline", "--no-baseline").returncode == 2
    pruned = _cli("--baseline", str(p), "--prune-baseline")
    assert pruned.returncode == 0, pruned.stdout + pruned.stderr
    assert f"pruned stale baseline entry [races RL999]: {ghost['key']}" in pruned.stderr
    after = json.loads(p.read_text())
    assert after["_comment"] == doc["_comment"]
    assert after["suppressions"] == doc["suppressions"][:-1]
    rerun = _cli("--baseline", str(p), "--json", "--strict-baseline")
    assert rerun.returncode == 0, rerun.stdout + rerun.stderr
    redoc = json.loads(rerun.stdout)
    assert redoc["findings"] == [] and redoc["stale_suppressions"] == []
    assert {f["key"] for f in redoc["suppressed"]} == {e["key"] for e in after["suppressions"]}
    assert sum(per["suppressed"] for per in redoc["counts"].values()) == len(redoc["suppressed"])
