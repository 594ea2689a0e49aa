"""Pass 2 — oracle↔kernel parity coverage (PC2xx).

The host oracle (``scheduler/predicates.py`` / ``scheduler/priorities.py``)
is the behavioral spec the CUDA kernels must reproduce bit-for-bit.  The
drift mode that hurts is silent: a predicate or priority added to the
oracle with no matching kernel mask schedules correctly in unit tests and
diverges only as a parity mismatch at scale (the backend falls back to
all-oracle when the *configured* set is unsupported — but a new entry in
DEFAULT_PREDICATES silently widens what "supported" claims to mean).

The contract this pass enforces:

- every registered oracle entity (a ``DEFAULT_PREDICATES`` key, a
  ``make_*`` predicate factory, a priority class carrying a ``name``
  attribute) must either
  (a) appear in a ``# kernel: implements <Name>[, <Name>…]`` marker in a
  kernel file (``ops/batch_kernel.py``, ``ops/pallas_kernel.py``,
  ``ops/backend.py``, ``models/snapshot.py`` — the mask may live in the
  tensorizer), or
  (b) carry an explicit ``# kernel: host-fallback — <why>`` marker inside
  its oracle definition block.

Findings:

- PC201 unmapped predicate (neither implemented nor marked host-fallback)
- PC202 unmapped priority
- PC203 ``implements`` marker names an unknown oracle entity (a rename or
  removal on the oracle side left a stale kernel claim — exactly the
  drift this pass exists to catch, in the other direction)
- PC204 entity both kernel-implemented and marked host-fallback (stale
  fallback marker: the kernel caught up, the oracle annotation didn't)
- PC205 host-fallback marker with no justification text
- PC206 ``implements`` marker outside the kernel call graph (module-level
  comment, or inside a private function no public kernel entry point
  reaches) — the marker is IGNORED: a claim next to deleted or orphaned
  code must not keep counting as coverage (ROADMAP "Parity markers are
  comment-level").  Such a marker's entity reverts to PC201/PC202 unless
  mapped elsewhere.

Reachability: the units are module-level functions and class methods of
the kernel files; roots are the public ones (no leading underscore —
the kernel API surface); edges follow any referenced name, bare or
attribute (``self._kernel_weights()``, ``tensorizer.build_static``,
callbacks passed by reference), resolved against unit names across the
whole kernel file set.  Nested functions belong to their enclosing
unit's span, so markers inside closures of reachable functions count.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .core import Finding, iter_py_files

DEFAULT_ORACLE_PATHS = [
    "kubernetes_tpu_torch/scheduler/predicates.py",
    "kubernetes_tpu_torch/scheduler/priorities.py",
]
DEFAULT_KERNEL_PATHS = [
    # the reference's step module is scan_ref.py + frontier.py here, and
    # its Pallas kernel module is fused_scan.py; the rest of ops/ that
    # only the port has joins (see core.py's table)
    "kubernetes_tpu_torch/ops/scan_ref.py",
    "kubernetes_tpu_torch/ops/frontier.py",
    "kubernetes_tpu_torch/ops/fused_scan.py",
    "kubernetes_tpu_torch/ops/backend.py",
    "kubernetes_tpu_torch/models/snapshot.py",
    "kubernetes_tpu_torch/ops/mesh_scan.py",
    "kubernetes_tpu_torch/ops/frontier_refresh.py",
    "kubernetes_tpu_torch/ops/node_cache.py",
    "kubernetes_tpu_torch/ops/preemption_kernel.py",
    "kubernetes_tpu_torch/ops/_build.py",
]

_IMPLEMENTS_RE = re.compile(r"#\s*kernel:\s*implements\s+(?P<names>[A-Za-z0-9_,\s]+)")
_FALLBACK_RE = re.compile(r"#\s*kernel:\s*host-fallback\s*(?:[-—–:]+\s*(?P<reason>.*))?$")


class OracleEntity:
    def __init__(self, name: str, kind: str, path: str, line: int, end_line: int):
        self.name = name
        self.kind = kind  # "predicate" | "priority"
        self.path = path
        self.line = line
        self.end_line = end_line
        self.fallback_line: Optional[int] = None
        self.fallback_reason: Optional[str] = None


def _collect_oracle_entities(abs_path: str, rel: str) -> list[OracleEntity]:
    with open(abs_path, "r", encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=rel)
    entities: list[OracleEntity] = []
    for node in tree.body:
        # registry dicts: DEFAULT_PREDICATES = {"Name": fn, …}
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            value = node.value
            if (
                isinstance(value, ast.Dict)
                and any(
                    isinstance(t, ast.Name) and "PREDICATES" in t.id for t in targets
                )
            ):
                for key in value.keys:
                    if isinstance(key, ast.Constant) and isinstance(key.value, str):
                        entities.append(
                            OracleEntity(key.value, "predicate", rel, key.lineno, key.lineno)
                        )
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("make_"):
            entities.append(
                OracleEntity(
                    node.name, "predicate", rel, node.lineno,
                    node.end_lineno or node.lineno,
                )
            )
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if (
                    isinstance(item, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "name" for t in item.targets)
                    and isinstance(item.value, ast.Constant)
                    and isinstance(item.value.value, str)
                ):
                    entities.append(
                        OracleEntity(
                            node.name, "priority", rel, node.lineno,
                            node.end_lineno or node.lineno,
                        )
                    )
                    break
    _attach_fallback_markers(src, entities)
    return entities


def _attach_fallback_markers(src: str, entities: list[OracleEntity]) -> None:
    for lineno, line in enumerate(src.splitlines(), start=1):
        m = _FALLBACK_RE.search(line)
        if not m:
            continue
        reason = (m.group("reason") or "").strip()
        # attach to the innermost (smallest) enclosing entity block
        best: Optional[OracleEntity] = None
        for e in entities:
            if e.line <= lineno <= e.end_line:
                if best is None or (e.end_line - e.line) < (best.end_line - best.line):
                    best = e
        if best is not None:
            best.fallback_line = lineno
            best.fallback_reason = reason


class _KernelUnit:
    """One call-graph node: a module-level function or a class method of
    a kernel file.  Nested defs are folded into the enclosing unit (their
    lines fall inside its span; their references count as its calls)."""

    def __init__(self, name: str, path: str, line: int, end_line: int,
                 refs: set, owner_class: Optional[str] = None):
        self.name = name
        self.path = path
        self.line = line
        self.end_line = end_line
        self.refs = refs  # every bare/attribute name the body references
        self.owner_class = owner_class  # None for module-level functions


def _unit_refs(node: ast.AST) -> set:
    refs: set = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            refs.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            refs.add(sub.attr)
    return refs


def _collect_kernel_units(abs_path: str, rel: str) -> list[_KernelUnit]:
    with open(abs_path, "r", encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=rel)
    units: list[_KernelUnit] = []

    def add(node: ast.AST, owner: Optional[str] = None) -> None:
        units.append(_KernelUnit(
            node.name, rel, node.lineno, node.end_lineno or node.lineno,
            _unit_refs(node), owner_class=owner))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(node)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add(item, owner=node.name)
    return units


def _reachable_spans(units: list[_KernelUnit]) -> dict[str, list[tuple[int, int]]]:
    """BFS from the public units over name-reference edges; returns the
    reachable line spans per file.  A reference to a CLASS name reaches
    that class's dunder methods (instantiation runs ``__init__``; the
    public methods are roots in their own right) — a marker inside the
    constructor of an instantiated kernel class must not be flagged."""
    by_name: dict[str, list[_KernelUnit]] = {}
    dunders_by_class: dict[str, list[_KernelUnit]] = {}
    for u in units:
        by_name.setdefault(u.name, []).append(u)
        if (u.owner_class is not None
                and u.name.startswith("__") and u.name.endswith("__")):
            dunders_by_class.setdefault(u.owner_class, []).append(u)
    work = [u for u in units if not u.name.startswith("_")]
    seen = set(id(u) for u in work)
    while work:
        u = work.pop()
        for ref in u.refs:
            for target in by_name.get(ref, ()):
                if id(target) not in seen:
                    seen.add(id(target))
                    work.append(target)
            for target in dunders_by_class.get(ref, ()):
                if id(target) not in seen:
                    seen.add(id(target))
                    work.append(target)
    spans: dict[str, list[tuple[int, int]]] = {}
    for u in units:
        if id(u) in seen:
            spans.setdefault(u.path, []).append((u.line, u.end_line))
    return spans


def _collect_implements(
    abs_path: str, rel: str, spans: Optional[list[tuple[int, int]]]
) -> tuple[list[tuple[str, str, int]], list[tuple[str, str, int]]]:
    """(counted, ignored): implements-marker mentions inside vs outside
    the reachable kernel spans of this file."""
    counted: list[tuple[str, str, int]] = []
    ignored: list[tuple[str, str, int]] = []
    with open(abs_path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            m = _IMPLEMENTS_RE.search(line)
            if not m:
                continue
            in_graph = spans is not None and any(
                lo <= lineno <= hi for lo, hi in spans)
            for name in m.group("names").split(","):
                name = name.strip()
                if name:
                    (counted if in_graph else ignored).append((name, rel, lineno))
    return counted, ignored


def run(
    root: str,
    oracle_paths: Optional[list[str]] = None,
    kernel_paths: Optional[list[str]] = None,
) -> list[Finding]:
    findings: list[Finding] = []
    entities: list[OracleEntity] = []
    for abs_path, rel in iter_py_files(root, oracle_paths or DEFAULT_ORACLE_PATHS):
        try:
            entities.extend(_collect_oracle_entities(abs_path, rel))
        except SyntaxError as e:
            findings.append(
                Finding("PC200", rel, e.lineno or 1, "syntax", f"unparseable oracle file: {e.msg}")
            )
    kernel_files = list(iter_py_files(root, kernel_paths or DEFAULT_KERNEL_PATHS))
    units: list[_KernelUnit] = []
    unparseable: set[str] = set()
    for abs_path, rel in kernel_files:
        try:
            units.extend(_collect_kernel_units(abs_path, rel))
        except SyntaxError as e:
            findings.append(
                Finding("PC200", rel, e.lineno or 1, "syntax",
                        f"unparseable kernel file: {e.msg}")
            )
            unparseable.add(rel)
    spans_by_file = _reachable_spans(units)
    implements: list[tuple[str, str, int]] = []
    for abs_path, rel in kernel_files:
        # an unparseable file has no call graph — count its markers as
        # before rather than mass-reporting PC206 on top of PC200
        counted, ignored = _collect_implements(
            abs_path, rel, spans_by_file.get(rel, []))
        if rel in unparseable:
            implements.extend(counted)
            implements.extend(ignored)
            continue
        implements.extend(counted)
        for name, _rel, lineno in ignored:
            findings.append(
                Finding(
                    code="PC206",
                    path=rel,
                    line=lineno,
                    symbol=f"marker.{name}",
                    message=(
                        f"implements marker for {name!r} sits outside every "
                        f"function the kernel call graph reaches (module-level "
                        f"comment or orphaned private code) — it does NOT "
                        f"count as kernel coverage; move it into the "
                        f"implementing function or delete it"
                    ),
                )
            )

    by_name: dict[str, OracleEntity] = {}
    for e in entities:
        # a name registered twice (dict entry + factory) keeps the first
        by_name.setdefault(e.name, e)
    implemented: dict[str, tuple[str, int]] = {}
    for name, rel, lineno in implements:
        implemented.setdefault(name, (rel, lineno))
        if name not in by_name:
            findings.append(
                Finding(
                    code="PC203",
                    path=rel,
                    line=lineno,
                    symbol=f"implements.{name}",
                    message=(
                        f"kernel claims to implement {name!r} but no such "
                        f"predicate/priority is registered in the oracle — "
                        f"renamed or removed without updating the marker?"
                    ),
                )
            )

    for e in by_name.values():
        is_impl = e.name in implemented
        has_fb = e.fallback_line is not None
        if is_impl and has_fb:
            findings.append(
                Finding(
                    code="PC204",
                    path=e.path,
                    line=e.fallback_line,
                    symbol=f"fallback.{e.name}",
                    message=(
                        f"{e.name} is marked host-fallback but a kernel implements "
                        f"marker exists at {implemented[e.name][0]}:"
                        f"{implemented[e.name][1]} — remove the stale marker"
                    ),
                )
            )
        elif has_fb and not (e.fallback_reason or "").strip():
            findings.append(
                Finding(
                    code="PC205",
                    path=e.path,
                    line=e.fallback_line,
                    symbol=f"fallback.{e.name}",
                    message=(
                        f"host-fallback marker on {e.name} has no justification — "
                        f"write why the kernel path doesn't cover it "
                        f"(`# kernel: host-fallback — <why>`)"
                    ),
                )
            )
        elif not is_impl and not has_fb:
            code = "PC201" if e.kind == "predicate" else "PC202"
            findings.append(
                Finding(
                    code=code,
                    path=e.path,
                    line=e.line,
                    symbol=f"unmapped.{e.name}",
                    message=(
                        f"registered {e.kind} {e.name!r} has no kernel implementation "
                        f"marker and no `# kernel: host-fallback` annotation — the "
                        f"batch path will silently diverge from the oracle"
                    ),
                )
            )
    return findings
