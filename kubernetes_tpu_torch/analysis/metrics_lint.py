"""Metrics-name lint (MN4xx): conventions for every metric the tree
registers.

Prometheus-style metrics are an API: dashboards, the SLO checks, and the
fault-matrix assertions all address them by NAME, so a misnamed metric
is a silent contract break.  The pass walks every scanned file for
constructions of the project's metric primitives (``Counter`` /
``Histogram`` / ``Gauge`` from ``utils.metrics``) with a literal name
and enforces:

- **MN401** — names are snake_case (``[a-z][a-z0-9_]*``): the Prometheus
  data model is case-sensitive and the exposition escapes nothing;
- **MN402** — counters end ``_total`` (the counter suffix convention the
  reference's metrics all follow);
- **MN403** — histograms carry a unit suffix (``_seconds`` /
  ``_microseconds`` / ``_milliseconds`` / ``_bytes`` / ``_fraction`` /
  ``_ratio``): a histogram without a unit cannot be read off a dashboard
  without source-diving;
- **MN404** — no duplicate registrations: the same literal name
  constructed at two different sites means two registries (or one
  registry twice) expose conflicting series under one name.
- **MN405** — every metric name an SLO spec reads (a ``RatioSLI`` /
  ``QuantileSLI`` construction, by position or by ``metric`` /
  ``bad_metric`` / ``total_metric`` / ``good_metric`` keyword) must
  resolve to a registration somewhere in the scanned set.  An SLI over a
  misspelled or deleted metric never sees data, and "no data" is
  deliberately never a breach — the burn-rate engine would go silently
  blind.

Only calls provably referring to the project's primitives count: the
file must import the name from a ``metrics`` module (or BE
``utils/metrics.py``), so ``collections.Counter`` never false-positives;
SLI constructions likewise require an import from an ``slo`` module (or
the file IS ``utils/slo.py``).
Symbols are the enclosing dotted scope plus the metric name — line-independent,
like every other pass (see ``core.Finding``).
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .core import Finding, iter_py_files

# the default scan scope: everywhere the runtime registers metrics
DEFAULT_PATHS = ["kubernetes_tpu_torch"]

_METRIC_CLASSES = ("Counter", "Histogram", "Gauge")
_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")
_HIST_UNITS = ("_seconds", "_microseconds", "_milliseconds", "_bytes",
               "_fraction", "_ratio")

#: SLI spec classes and which of their arguments carry metric names:
#: positional slots by index, plus the keyword set (MN405)
_SLI_CLASSES: dict[str, tuple[tuple[int, ...], frozenset[str]]] = {
    "RatioSLI": ((0, 1), frozenset(
        {"bad_metric", "total_metric", "good_metric"})),
    "QuantileSLI": ((0,), frozenset({"metric"})),
    "GaugeSLI": ((0,), frozenset({"metric"})),
}


def _imported_metric_names(tree: ast.Module, rel_path: str) -> dict[str, str]:
    """name-in-this-file -> metric class, for names provably bound to the
    project's metric primitives.  ``utils/metrics.py`` itself defines
    them, so its bare names count."""
    out: dict[str, str] = {}
    if rel_path.replace("\\", "/").endswith("utils/metrics.py"):
        for cls in _METRIC_CLASSES:
            out[cls] = cls
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[-1] != "metrics":
                continue
            for alias in node.names:
                if alias.name in _METRIC_CLASSES:
                    out[alias.asname or alias.name] = alias.name
    return out


def _imported_sli_names(tree: ast.Module, rel_path: str) -> dict[str, str]:
    """name-in-this-file -> SLI class, for names provably bound to the
    SLO layer's spec primitives (imported from an ``slo`` module, or the
    file IS ``utils/slo.py``)."""
    out: dict[str, str] = {}
    if rel_path.replace("\\", "/").endswith("utils/slo.py"):
        for cls in _SLI_CLASSES:
            out[cls] = cls
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[-1] != "slo":
                continue
            for alias in node.names:
                if alias.name in _SLI_CLASSES:
                    out[alias.asname or alias.name] = alias.name
    return out


class _Scope(ast.NodeVisitor):
    """Collect metric constructions with their enclosing dotted scope."""

    def __init__(self, names: dict[str, str],
                 sli_names: Optional[dict[str, str]] = None):
        self._names = names
        self._sli_names = sli_names or {}
        self._stack: list[str] = []
        # (metric class, literal name, line, scope path)
        self.found: list[tuple[str, str, int, str]] = []
        # (SLI class, referenced metric name, line, scope path)
        self.sli_refs: list[tuple[str, str, int, str]] = []

    def _visit_scoped(self, node) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_scoped
    visit_AsyncFunctionDef = _visit_scoped
    visit_ClassDef = _visit_scoped

    def visit_Call(self, node: ast.Call) -> None:
        cls = None
        if isinstance(node.func, ast.Name):
            cls = self._names.get(node.func.id)
        elif isinstance(node.func, ast.Attribute):
            # metrics.Counter(...) through a module alias named *metrics*
            if (isinstance(node.func.value, ast.Name)
                    and node.func.value.id.endswith("metrics")
                    and node.func.attr in _METRIC_CLASSES):
                cls = node.func.attr
        if cls is not None and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                scope = ".".join(self._stack)
                self.found.append((cls, first.value, node.lineno, scope))
        if isinstance(node.func, ast.Name):
            sli = self._sli_names.get(node.func.id)
            if sli is not None:
                slots, kwset = _SLI_CLASSES[sli]
                scope = ".".join(self._stack)
                for i in slots:
                    if (i < len(node.args)
                            and isinstance(node.args[i], ast.Constant)
                            and isinstance(node.args[i].value, str)):
                        self.sli_refs.append(
                            (sli, node.args[i].value, node.lineno, scope))
                for kw in node.keywords:
                    if (kw.arg in kwset
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        self.sli_refs.append(
                            (sli, kw.value.value, node.lineno, scope))
        self.generic_visit(node)


def run(root: str, paths: Optional[list[str]] = None) -> list[Finding]:
    findings: list[Finding] = []
    registrations: list[tuple[str, str, int, str, str]] = []
    sli_refs: list[tuple[str, str, int, str, str]] = []
    for abs_path, rel_path in iter_py_files(root, paths or DEFAULT_PATHS):
        with open(abs_path, "r", encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=rel_path)
            except SyntaxError:
                continue
        names = _imported_metric_names(tree, rel_path)
        sli_names = _imported_sli_names(tree, rel_path)
        if not names and not sli_names:
            continue
        visitor = _Scope(names, sli_names)
        visitor.visit(tree)
        for sli, metric_name, line, scope in visitor.sli_refs:
            symbol = f"{scope}.{metric_name}" if scope else metric_name
            sli_refs.append((metric_name, rel_path, line, symbol, sli))
        for cls, metric_name, line, scope in visitor.found:
            symbol = f"{scope}.{metric_name}" if scope else metric_name
            registrations.append((metric_name, rel_path, line, symbol, cls))
            if not _SNAKE.match(metric_name):
                findings.append(Finding(
                    "MN401", rel_path, line, symbol,
                    f"metric name {metric_name!r} is not snake_case"))
            if cls == "Counter" and not metric_name.endswith("_total"):
                findings.append(Finding(
                    "MN402", rel_path, line, symbol,
                    f"counter {metric_name!r} does not end in '_total'"))
            if cls == "Histogram" and not metric_name.endswith(_HIST_UNITS):
                findings.append(Finding(
                    "MN403", rel_path, line, symbol,
                    f"histogram {metric_name!r} carries no unit suffix "
                    f"(expected one of {', '.join(_HIST_UNITS)})"))
    # MN404: the same literal name at two different construction sites —
    # deterministic order (path, line), the FIRST site is the canonical
    # registration and every later one is flagged
    by_name: dict[str, list] = {}
    for reg in sorted(registrations, key=lambda r: (r[1], r[2])):
        by_name.setdefault(reg[0], []).append(reg)
    for metric_name, regs in by_name.items():
        for name, rel_path, line, symbol, _cls in regs[1:]:
            first = regs[0]
            findings.append(Finding(
                "MN404", rel_path, line, symbol,
                f"duplicate registration of {metric_name!r} "
                f"(first registered at {first[1]}:{first[2]})"))
    # MN405: SLO specs must read metrics that exist — an SLI over an
    # unregistered name sees "no data" forever and (by design) no data is
    # never a breach, so the misconfiguration would be silent
    registered_names = {r[0] for r in registrations}
    for metric_name, rel_path, line, symbol, sli in sorted(
            sli_refs, key=lambda r: (r[1], r[2])):
        if metric_name in registered_names:
            continue
        findings.append(Finding(
            "MN405", rel_path, line, symbol,
            f"{sli} reads metric {metric_name!r} which is registered "
            f"nowhere in the scanned set — the SLO over it is "
            f"permanently blind"))
    return findings
