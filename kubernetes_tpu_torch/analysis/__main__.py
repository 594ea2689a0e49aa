"""ktpu-analyze CLI.

    python -m kubernetes_tpu_torch.analysis [--json] [--pass NAME]...
                                            [--baseline PATH | --no-baseline]
                                            [--prune-baseline] [--profile]
                                            [--changed[=REF]]
                                            [--root DIR] [--list-passes]

Exit codes: 0 = clean (all findings baselined), 1 = unbaselined findings,
2 = usage/baseline error.  Nonzero-on-findings is the commit-gate
contract: `python -m kubernetes_tpu_torch.analysis && git commit …`.
``--prune-baseline`` rewrites the baseline file with stale entries
removed (reasons on surviving entries preserved); exit semantics are
unchanged — findings still fail the run after the prune.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .core import (
    _CODE_PREFIX_PASS,
    PASS_NAMES,
    BaselineError,
    default_baseline_path,
    load_baseline,
    prune_baseline,
    repo_root,
    run_analysis,
)


def _changed_files(root: str, ref: str) -> set[str]:
    """Repo-relative paths changed vs ``ref`` plus untracked files.

    Raises ValueError on a bad ref (surfaced as exit 2): a typo'd ref
    must not silently report zero files as 'nothing changed'."""
    diff = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=root, capture_output=True, text=True,
    )
    if diff.returncode != 0:
        raise ValueError(
            f"--changed: git diff against {ref!r} failed: "
            f"{diff.stderr.strip() or 'unknown git error'}"
        )
    out = {line.strip() for line in diff.stdout.splitlines() if line.strip()}
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=root, capture_output=True, text=True,
    )
    if untracked.returncode == 0:
        out.update(line.strip() for line in untracked.stdout.splitlines()
                   if line.strip())
    return out

PASS_DESCRIPTIONS = {
    "trace": "trace-safety over ops/ (TS1xx: host escapes and Python branches in torch-traced bodies, set-order nondeterminism)",
    "parity": "oracle↔kernel parity coverage (PC2xx: unmapped predicates/priorities, stale markers)",
    "races": "controller/kubelet race lint (RL3xx: unlocked cross-thread writes, lock-order cycles)",
    "metrics": "metrics-name lint (MN4xx: snake_case names, counters end _total, histograms carry a unit, no duplicate registrations, SLO specs resolve to registered metrics)",
    "tracecov": "trace-coverage lint (TC5xx: fault seams outside spans, unmirrored phase timers, span-free hot-path modules, wave-phase spans outside the hot scope)",
    "device": "device-contract lint (DC6xx: raw device pointers of dead tensors, unsanctioned host syncs on the wave hot path, shape-bearing values in the kernel build identity, snapshot writes bypassing clone-on-write)",
    "concurrency": "concurrency-hazard & resource-lifecycle lint (CH7xx: blocking calls under held locks, swallowed exceptions, unjoined threads / unclosed handles, callbacks invoked under locks, unbounded growth on daemon paths)",
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.analysis",
        description="Project-native static analysis: trace-safety, parity coverage, race lint.",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    parser.add_argument(
        "--pass",
        dest="passes",
        action="append",
        choices=PASS_NAMES,
        help="run only the named pass (repeatable; default: all)",
    )
    baseline_group = parser.add_mutually_exclusive_group()
    baseline_group.add_argument(
        "--baseline", default=None, help="baseline suppression file (JSON)"
    )
    baseline_group.add_argument(
        "--no-baseline", action="store_true", help="report every finding, suppressing nothing"
    )
    parser.add_argument("--root", default=None, help="repo root (default: autodetected)")
    parser.add_argument(
        "--strict-baseline",
        action="store_true",
        help="also fail (exit 1) on stale baseline entries",
    )
    parser.add_argument(
        "--prune-baseline",
        action="store_true",
        help="rewrite the baseline file with stale entries removed "
             "(surviving entries keep their reasons and order)",
    )
    parser.add_argument(
        "--changed",
        nargs="?",
        const="HEAD",
        default=None,
        metavar="REF",
        help="report findings only for files changed vs REF (default: HEAD) "
             "plus untracked files — the full scope is still scanned, so "
             "cross-file summaries and stale-baseline detection stay exact; "
             "only the REPORT is diff-scoped",
    )
    parser.add_argument(
        "--profile",
        action="store_true",
        help="print per-pass wall-time to stderr",
    )
    parser.add_argument("--list-passes", action="store_true", help="list passes and exit")
    args = parser.parse_args(argv)

    if args.list_passes:
        for name in PASS_NAMES:
            print(f"{name:8s} {PASS_DESCRIPTIONS[name]}")
        return 0

    baseline = None
    baseline_path = None
    if args.prune_baseline and args.no_baseline:
        print("--prune-baseline needs a baseline file (conflicts with "
              "--no-baseline)", file=sys.stderr)
        return 2
    if not args.no_baseline:
        baseline_path = args.baseline or default_baseline_path()
        try:
            baseline = load_baseline(baseline_path)
        except FileNotFoundError:
            print(f"baseline file not found: {baseline_path}", file=sys.stderr)
            return 2
        except BaselineError as e:
            print(str(e), file=sys.stderr)
            return 2

    try:
        report = run_analysis(
            root=args.root or repo_root(), passes=args.passes, baseline=baseline
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.prune_baseline and report.stale_suppressions:
        removed = prune_baseline(baseline_path, report.stale_suppressions)
        for key in removed:
            code = key.split(":", 1)[0]
            pass_name = _CODE_PREFIX_PASS.get(code[:2], "unknown")
            print(f"pruned stale baseline entry [{pass_name} {code}]: {key}",
                  file=sys.stderr)
        report.stale_suppressions = []

    if args.changed is not None:
        try:
            changed = _changed_files(args.root or repo_root(), args.changed)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        report.findings = [f for f in report.findings if f.path in changed]
        report.suppressed = [f for f in report.suppressed if f.path in changed]

    if args.json:
        # sort_keys: CI diffs two runs' output textually — field order
        # must never depend on dict construction order
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(report.format_text())
    if args.profile:
        for name in report.passes_run:
            print(f"profile: {name:8s} {report.timings.get(name, 0.0) * 1000.0:8.1f} ms",
                  file=sys.stderr)
    if report.findings:
        return 1
    if args.strict_baseline and report.stale_suppressions:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
