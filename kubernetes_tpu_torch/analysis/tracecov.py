"""Trace-coverage lint (TC5xx): span coverage is structural, not manual.

The flight recorder is only as good as the sites that feed it:
a fault seam that fires outside any span leaves a blank where the
dump-on-fault story needs context, and a phase timer that never mirrors
to the trace layer makes the profile and the trace disagree about where
a wave's time went.  Until this pass, keeping those aligned was a
review-time convention; now it is a gate.

Rules
-----
- **TC500** — file in scope does not parse (same contract as RL300).
- **TC501** — a ``faults.hit(...)`` call site whose enclosing function is
  not *trace-covered*.  A function is trace-covered when it contains a
  trace marker itself (``.span(`` / ``.wave(`` / ``.complete(`` /
  ``.instant(`` call, or a ``NULL_SPAN`` reference — counted only in
  modules that import the tracing layer), or when every intra-module
  caller of its name is trace-covered (fixed point).  The caller rule is
  the trace twin of the races pass's caller-held-lock propagation: a
  helper extracted out of a span body (``bind_many`` →
  ``_bind_many_locked``) stays silent without a baseline entry.
- **TC502** — a phase timer ``X["<name>_s"] += t1 - t0`` in a phase-path
  file with no matching ``.complete("<name>", ...)`` in the same
  function: the stats profile and the trace would disagree about this
  phase.
- **TC503** — a wave-hot-path module with no trace marker at all: a new
  subsystem on the hot path must open at least one span before it ships.
- **TC504** — the inverse of TC503: a module that opens *wave-phase*
  spans (a ``.wave(`` call, or ``.complete(..., cat="phase")``) but is
  missing from ``HOT_PATH_MODULES``.  Wave phases feed the SLO burn-rate
  engine and the per-wave profile; a module emitting them from outside
  the declared hot set silently escapes the TC501/TC503 coverage gates,
  so the scope list must grow with the code — loudly.

Like every pass here the analysis is lexical and over-approximates
toward SILENCE: a marker anywhere in the function counts, whether or not
it lexically wraps the fault seam — the gate exists to catch modules and
functions with no trace story, not to prove dynamic nesting.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, iter_py_files

DEFAULT_PATHS = ["kubernetes_tpu_torch"]

#: modules on the wave hot path (store txn -> watch -> informer ->
#: scheduler -> backend -> frontier -> the launch wrappers): each must
#: open at least one span (TC503).  The reference's one step module
#: (the step and the frontier run) is two modules here, ``scan_ref.py``
#: and ``frontier.py``; the modules that only the port has under
#: ``ops/`` join as the rest of the layer (see ``core.py``'s table)
HOT_PATH_MODULES = [
    "kubernetes_tpu_torch/store/store.py",
    "kubernetes_tpu_torch/store/wal.py",
    "kubernetes_tpu_torch/client/informer.py",
    "kubernetes_tpu_torch/client/remote.py",
    "kubernetes_tpu_torch/scheduler/scheduler.py",
    "kubernetes_tpu_torch/ops/backend.py",
    "kubernetes_tpu_torch/ops/scan_ref.py",
    "kubernetes_tpu_torch/ops/frontier.py",
    # the launch wrapper of the fused scan runs every wave on the card
    "kubernetes_tpu_torch/ops/fused_scan.py",
    "kubernetes_tpu_torch/ops/mesh_scan.py",
    "kubernetes_tpu_torch/ops/frontier_refresh.py",
    "kubernetes_tpu_torch/ops/node_cache.py",
    "kubernetes_tpu_torch/ops/preemption_kernel.py",
    "kubernetes_tpu_torch/ops/_build.py",
    "kubernetes_tpu_torch/utils/overload.py",
    "kubernetes_tpu_torch/parallel/mesh.py",
]

#: files whose ``*_s`` stats timers must mirror to the trace layer (TC502)
PHASE_FILES = [
    "kubernetes_tpu_torch/ops/backend.py",
    "kubernetes_tpu_torch/scheduler/scheduler.py",
]

_MARKER_ATTRS = {"span", "wave", "complete", "instant"}


def _imports_tracing(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and "tracing" in node.module:
                return True
            if any(a.name == "tracing" for a in node.names):
                return True
        elif isinstance(node, ast.Import):
            if any("tracing" in a.name for a in node.names):
                return True
    return False


class _Func:
    __slots__ = ("node", "qualname", "name", "marked", "callers")

    def __init__(self, node: ast.FunctionDef, qualname: str):
        self.node = node
        self.qualname = qualname
        self.name = node.name
        self.marked = False
        self.callers: set[str] = set()  # caller function NAMES


def _collect_funcs(tree: ast.Module) -> list[_Func]:
    out: list[_Func] = []

    def visit(node, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                out.append(_Func(child, qual))
                visit(child, qual)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix
                      else child.name)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _enclosing(funcs: list[_Func], line: int) -> Optional[_Func]:
    best: Optional[_Func] = None
    for f in funcs:
        if f.node.lineno <= line <= (f.node.end_lineno or f.node.lineno):
            if best is None or f.node.lineno > best.node.lineno:
                best = f
    return best


def _is_marker(node: ast.AST) -> bool:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr in _MARKER_ATTRS
    return isinstance(node, ast.Attribute) and node.attr == "NULL_SPAN"


def _is_fault_hit(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "hit"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "faults")


def _called_names(fn: ast.FunctionDef) -> set[str]:
    """Bare names this function calls: ``g(...)`` and ``self.g(...)``."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name):
            out.add(node.func.id)
        elif (isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "self"):
            out.add(node.func.attr)
    return out


def _covered_names(funcs: list[_Func]) -> set[str]:
    """Fixed point of marker coverage over the intra-module call graph:
    own marker, or every known caller covered.  Name-level (not
    instance-level) on both sides — over-approximates toward silence."""
    for f in funcs:
        for name in _called_names(f.node):
            for g in funcs:
                if g.name == name:
                    g.callers.add(f.name)
    covered = {f.name for f in funcs if f.marked}
    changed = True
    while changed:
        changed = False
        for f in funcs:
            if f.name in covered or not f.callers:
                continue
            if f.callers <= covered:
                covered.add(f.name)
                changed = True
    return covered


def _fault_label(call: ast.Call) -> str:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return "hit"


def _phase_timer_key(node: ast.AugAssign) -> Optional[str]:
    """``X["<k>_s"] += a - b`` -> ``<k>``; None for anything else."""
    if not isinstance(node.op, ast.Add):
        return None
    if not isinstance(node.target, ast.Subscript):
        return None
    sl = node.target.slice
    if not (isinstance(sl, ast.Constant) and isinstance(sl.value, str)
            and sl.value.endswith("_s")):
        return None
    if not (isinstance(node.value, ast.BinOp)
            and isinstance(node.value.op, ast.Sub)):
        return None
    return sl.value[:-2]


def _wave_phase_marker_line(tree: ast.Module) -> Optional[int]:
    """First line opening a *wave-phase* span — a ``.wave(`` call or a
    ``.complete(..., cat="phase")`` call — or None.  ``cat="trace"`` and
    other categories are background instrumentation, not wave phases."""
    best: Optional[int] = None
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        hit = node.func.attr == "wave"
        if not hit and node.func.attr == "complete":
            hit = any(kw.arg == "cat"
                      and isinstance(kw.value, ast.Constant)
                      and kw.value.value == "phase"
                      for kw in node.keywords)
        if hit and (best is None or node.lineno < best):
            best = node.lineno
    return best


def _completes_in(fn: ast.FunctionDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "complete"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value)
    return out


def run(
    root: str,
    paths: Optional[list[str]] = None,
    hot_modules: Optional[list[str]] = None,
    phase_files: Optional[list[str]] = None,
) -> list[Finding]:
    files = iter_py_files(root, paths or DEFAULT_PATHS)
    hot = set(hot_modules if hot_modules is not None else HOT_PATH_MODULES)
    phase = set(phase_files if phase_files is not None else PHASE_FILES)
    findings: list[Finding] = []

    seen_rel: set[str] = set()
    for abs_path, rel in files:
        seen_rel.add(rel)
        try:
            with open(abs_path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except SyntaxError as e:
            findings.append(Finding(
                code="TC500", path=rel, line=e.lineno or 1,
                symbol="<parse>",
                message=f"file does not parse: {e.msg}"))
            continue

        traced_module = _imports_tracing(tree)
        funcs = _collect_funcs(tree)
        marker_lines: list[int] = []
        if traced_module:
            for node in ast.walk(tree):
                if _is_marker(node):
                    marker_lines.append(node.lineno)
        for f in funcs:
            a, b = f.node.lineno, f.node.end_lineno or f.node.lineno
            if any(a <= ln <= b for ln in marker_lines):
                f.marked = True
        covered = _covered_names(funcs)

        # TC501: fault seams outside any trace-covered function
        for node in ast.walk(tree):
            if not _is_fault_hit(node):
                continue
            enc = _enclosing(funcs, node.lineno)
            if enc is not None and enc.name in covered:
                continue
            where = enc.qualname if enc is not None else "<module>"
            label = _fault_label(node)
            findings.append(Finding(
                code="TC501", path=rel, line=node.lineno,
                symbol=f"{where}.{label}",
                message=(
                    f"fault seam `faults.hit({label!r}, ...)` executes "
                    f"outside any span: `{where}` opens no span/marker and "
                    f"neither do all of its callers — a dump-on-fault here "
                    f"has no trace context"
                ),
            ))

        # TC502: phase timers not mirrored to the trace layer
        if rel in phase:
            for f in funcs:
                completes = None
                for node in ast.walk(f.node):
                    if not isinstance(node, ast.AugAssign):
                        continue
                    key = _phase_timer_key(node)
                    if key is None:
                        continue
                    # only the innermost function owns the timer
                    if _enclosing(funcs, node.lineno) is not f:
                        continue
                    if completes is None:
                        completes = _completes_in(f.node)
                    if key in completes:
                        continue
                    findings.append(Finding(
                        code="TC502", path=rel, line=node.lineno,
                        symbol=f"{f.qualname}.{key}_s",
                        message=(
                            f"phase timer `{key}_s` accumulated in "
                            f"`{f.qualname}` with no matching "
                            f"`.complete({key!r}, ...)` — the stats "
                            f"profile and the trace disagree about this "
                            f"phase"
                        ),
                    ))

        # TC503: hot-path module with no trace story at all
        if rel in hot and not marker_lines:
            findings.append(Finding(
                code="TC503", path=rel, line=1, symbol="<module>",
                message=(
                    "wave-hot-path module opens no span (no .span/.wave/"
                    ".complete/.instant call and no NULL_SPAN use" +
                    ("" if traced_module
                     else "; the tracing layer is not even imported") +
                    ") — waves crossing this module are invisible to the "
                    "flight recorder"
                ),
            ))

        # TC504: wave-phase spans opened outside the declared hot set
        if rel not in hot:
            ln = _wave_phase_marker_line(tree)
            if ln is not None:
                findings.append(Finding(
                    code="TC504", path=rel, line=ln, symbol="<module>",
                    message=(
                        "module opens wave-phase spans (`.wave(` / "
                        "`.complete(..., cat=\"phase\")`) but is not "
                        "listed in HOT_PATH_MODULES — it escapes the "
                        "TC501/TC503 coverage gates and its phases feed "
                        "the SLO engine unaudited; add it to the hot "
                        "scope (or the scope override)"
                    ),
                ))

    # a hot/phase scope entry that matches no scanned file is a config
    # error of THIS pass: fail loud, mirroring iter_py_files's contract
    for rel in sorted((hot | phase) - seen_rel):
        findings.append(Finding(
            code="TC500", path=rel, line=1, symbol="<scope>",
            message=(
                "trace-coverage scope names a file outside the scanned "
                "set — fix HOT_PATH_MODULES/PHASE_FILES (or the scope "
                "override) rather than silently checking nothing"
            ),
        ))
    return findings
