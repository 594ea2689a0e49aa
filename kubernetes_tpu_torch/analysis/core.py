"""Analyzer spine: findings, baseline suppressions, reporters, the pass runner.

A :class:`Finding` is keyed by ``code:path:symbol`` — deliberately NOT by
line number, so a baseline entry survives unrelated edits above the
finding.  ``symbol`` is the dotted enclosing-scope path plus the offending
name (e.g. ``make_step.step.gid`` or ``Controller._worker_loop.counter``),
which moves only when the code it names moves.

The baseline file is a checked-in JSON document; every suppression MUST
carry a non-empty ``reason`` (enforced at load time) so nothing is ever
waved through silently.  Stale entries (keys matching no current finding)
are reported so the baseline can only shrink, never rot.

Scopes.  The passes are the reference package's (``kubernetes_tpu/
analysis``), with the same rules, codes and CLI; only their default
scopes name this package.  A path of a reference scope maps to its
counterparts under ``kubernetes_tpu_torch/`` by this table, and nothing
is left out (the step and ``FrontierRun`` of the reference's one step
module are two modules here):

    kubernetes_tpu/<path>                -> <path>
    kubernetes_tpu/ops/batch_kernel.py   -> ops/scan_ref.py, ops/frontier.py
    kubernetes_tpu/ops/pallas_kernel.py  -> ops/fused_scan.py

The modules only this package has join the scope of their layer: under
``ops/`` the hot-path and kernel lists take ``mesh_scan.py``,
``frontier_refresh.py``, ``node_cache.py``, ``preemption_kernel.py`` and
``_build.py`` (directory scopes hold them already), the hot-path list
takes the fused scan's launch wrapper ``fused_scan.py`` too, and
``cluster.py`` joins ``daemon.py`` in the races and concurrency scopes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

PASS_NAMES = ("trace", "parity", "races", "metrics", "tracecov", "device",
              "concurrency")


def repo_root() -> str:
    """The directory containing the ``kubernetes_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


@dataclass(frozen=True)
class Finding:
    code: str  # e.g. "TS101"
    path: str  # repo-relative posix path
    line: int  # 1-based, for humans; not part of the key
    symbol: str  # stable anchor (scope path + name)
    message: str

    @property
    def key(self) -> str:
        return f"{self.code}:{self.path}:{self.symbol}"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "key": self.key,
        }

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.symbol}] {self.message}"


class BaselineError(ValueError):
    """Malformed baseline file (bad JSON, missing/empty reason)."""


def load_baseline(path: str) -> dict[str, str]:
    """key -> justification.  Every entry must justify itself."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise BaselineError(f"{path}: invalid JSON: {e}") from e
    entries = doc.get("suppressions")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected a top-level 'suppressions' list")
    out: dict[str, str] = {}
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict) or "key" not in entry:
            raise BaselineError(f"{path}: suppression #{i} has no 'key'")
        reason = entry.get("reason")
        if not isinstance(reason, str) or not reason.strip():
            raise BaselineError(
                f"{path}: suppression {entry['key']!r} has no justification "
                f"('reason' must be a non-empty string)"
            )
        if entry["key"] in out:
            raise BaselineError(f"{path}: duplicate suppression {entry['key']!r}")
        out[entry["key"]] = reason.strip()
    return out


def prune_baseline(path: str, stale_keys: list[str]) -> list[str]:
    """Rewrite the baseline file with the given stale entries removed.

    Surviving entries keep their order, reasons, and any extra fields;
    top-level keys other than ``suppressions`` (the ``_comment`` header)
    are preserved verbatim.  Returns the keys actually removed.  The file
    is validated through :func:`load_baseline` first so a malformed
    baseline is an error, never a silent truncation."""
    load_baseline(path)  # raises BaselineError on anything malformed
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    stale = set(stale_keys)
    kept, removed = [], []
    for entry in doc["suppressions"]:
        if entry["key"] in stale:
            removed.append(entry["key"])
        else:
            kept.append(entry)
    if removed:
        doc["suppressions"] = kept
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    return removed


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale_suppressions: list[str] = field(default_factory=list)
    passes_run: list[str] = field(default_factory=list)
    timings: dict[str, float] = field(default_factory=dict)  # pass -> seconds

    def counts(self) -> dict[str, dict[str, int]]:
        """Per-pass finding/suppression totals, keyed by pass name, every
        requested pass present (zeros included) — the stable shape CI
        diffs between runs."""
        out = {p: {"findings": 0, "suppressed": 0} for p in self.passes_run}
        for bucket, fs in (("findings", self.findings),
                           ("suppressed", self.suppressed)):
            for f in fs:
                p = _CODE_PREFIX_PASS.get(f.code[:2])
                if p in out:
                    out[p][bucket] += 1
        return out

    def to_dict(self) -> dict:
        return {
            "passes": self.passes_run,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "stale_suppressions": self.stale_suppressions,
            "timings_ms": {p: round(t * 1000.0, 3)
                           for p, t in self.timings.items()},
        }

    def format_text(self) -> str:
        lines: list[str] = []
        by_file: dict[str, list[Finding]] = {}
        for f in self.findings:
            by_file.setdefault(f.path, []).append(f)
        for path in sorted(by_file):
            lines.append(path)
            for f in sorted(by_file[path], key=lambda x: (x.line, x.code)):
                lines.append(f"  {f.line}: {f.code} [{f.symbol}] {f.message}")
        lines.append(
            f"{len(self.findings)} finding(s), {len(self.suppressed)} baselined, "
            f"passes: {', '.join(self.passes_run)}"
        )
        if self.stale_suppressions:
            lines.append(
                f"warning: {len(self.stale_suppressions)} stale baseline entr"
                f"{'y' if len(self.stale_suppressions) == 1 else 'ies'} "
                f"(matched nothing — prune them):"
            )
            for key in self.stale_suppressions:
                lines.append(f"  {key}")
        return "\n".join(lines)


# finding-code prefix -> the pass that can produce it (stale-entry
# detection must not call a races suppression "stale" in a parity-only run)
_CODE_PREFIX_PASS = {"TS": "trace", "PC": "parity", "RL": "races",
                     "MN": "metrics", "TC": "tracecov", "DC": "device",
                     "CH": "concurrency"}


def _split_baseline(
    findings: list[Finding], baseline: dict[str, str], passes: list[str]
) -> tuple[list[Finding], list[Finding], list[str]]:
    live: list[Finding] = []
    suppressed: list[Finding] = []
    used: set[str] = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            used.add(f.key)
        else:
            live.append(f)
    stale = sorted(
        key
        for key in set(baseline) - used
        if _CODE_PREFIX_PASS.get(key[:2], passes[0] if passes else "") in passes
    )
    return live, suppressed, stale


def run_analysis(
    root: Optional[str] = None,
    passes: Optional[list[str]] = None,
    baseline: Optional[dict[str, str]] = None,
    scopes: Optional[dict[str, dict]] = None,
) -> Report:
    """Run the requested passes over the tree at ``root``.

    ``scopes`` overrides per-pass file scopes (used by the fixture tests to
    aim a pass at seeded-violation files): ``{"trace": {"paths": [...]},
    "parity": {"oracle_paths": [...], "kernel_paths": [...]},
    "races": {"paths": [...]}}``.
    """
    import time

    from . import (concurrency_hazards, device_contracts, metrics_lint,
                   parity, races, trace_safety, tracecov)

    root = root or repo_root()
    passes = list(passes) if passes else list(PASS_NAMES)
    scopes = scopes or {}
    unknown = [p for p in passes if p not in PASS_NAMES]
    if unknown:
        raise ValueError(f"unknown pass(es): {unknown}; valid: {list(PASS_NAMES)}")

    runners: dict[str, Callable[[], list[Finding]]] = {
        "trace": lambda: trace_safety.run(root, **scopes.get("trace", {})),
        "parity": lambda: parity.run(root, **scopes.get("parity", {})),
        "races": lambda: races.run(root, **scopes.get("races", {})),
        "metrics": lambda: metrics_lint.run(root, **scopes.get("metrics", {})),
        "tracecov": lambda: tracecov.run(root, **scopes.get("tracecov", {})),
        "device": lambda: device_contracts.run(root, **scopes.get("device", {})),
        "concurrency": lambda: concurrency_hazards.run(
            root, **scopes.get("concurrency", {})),
    }
    findings: list[Finding] = []
    timings: dict[str, float] = {}
    for name in passes:
        t0 = time.perf_counter()
        findings.extend(runners[name]())
        timings[name] = time.perf_counter() - t0
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))

    report = Report(passes_run=passes, timings=timings)
    if baseline:
        report.findings, report.suppressed, report.stale_suppressions = _split_baseline(
            findings, baseline, passes
        )
    else:
        report.findings = findings
    return report


def iter_py_files(root: str, rel_paths: list[str]) -> list[tuple[str, str]]:
    """Expand repo-relative files/directories into (abs_path, rel_path)
    pairs, sorted for deterministic finding order.

    A scope path that matches nothing is a hard error: a typo'd or renamed
    entry must not silently shrink the gate's coverage to zero files."""
    out: list[tuple[str, str]] = []
    for rel in rel_paths:
        abs_p = os.path.join(root, rel)
        if not os.path.exists(abs_p):
            raise ValueError(
                f"analysis scope path does not exist: {rel!r} (under {root}) — "
                f"fix the scope list rather than scanning nothing"
            )
        if os.path.isdir(abs_p):
            for dirpath, dirnames, filenames in os.walk(abs_p):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        out.append((full, os.path.relpath(full, root).replace(os.sep, "/")))
        elif os.path.isfile(abs_p):
            out.append((abs_p, rel.replace(os.sep, "/")))
    return out
