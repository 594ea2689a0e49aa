"""Pass 1 — trace-safety over the kernel packages (TS1xx).

Host Python leaking into code that runs under one of torch's tracers
fails in one of two ways: loudly (a graph break, or an error under
``fullgraph``/``torch.jit``), or *silently* — a ``float()`` on a traced
value specializes the captured program on one trace-time constant, and a
CUDA graph replays the host value it saw at capture forever.  This pass
finds both shapes before they run.  It is the reference package's pass
with "traced" retargeted from JAX's tracers to torch's.

What counts as *traced* (the call-graph part):

- a function decorated ``@torch.compile`` (bare or called),
  ``@torch.jit.script``, or ``partial(torch.compile, …)``;
- a function passed by name into a tracer: ``torch.compile(fn)``,
  ``torch.jit.script(fn)`` / ``torch.jit.trace(fn, …)``, the
  ``torch.func`` transforms (``vmap``, ``grad``, ``grad_and_value``,
  ``functional_call``) and ``torch.cuda.make_graphed_callables`` —
  including when the reference rides a ``functools.partial(fn, …)``
  wrapper (direct argument or a ``name = partial(fn, …)`` alias) or a
  bound-method reference (``self._step`` → the method def);
- the body of a CUDA-graph capture, ``with torch.cuda.graph(g): …``: the
  body is checked against its function's taint, and what it calls is
  traced;
- transitively: any function called by simple name OR as a
  ``self.method(...)`` / ``cls.method(...)`` call from a traced function,
  any function a traced body wraps in ``functools.partial``, and any
  function *defined inside* a traced function.

What counts as *traced values* (the taint part): the traced function's
own parameters plus anything dataflow-derived from them or from a
``torch.`` expression.  Free (closure) variables are NOT tainted, and
neither are parameters annotated ``bool`` or defaulted to a bool/None
literal (the static-flag idiom).

Findings:

- TS101 host escape: ``float()/int()/bool()`` on a tainted value,
  ``.item()/.tolist()/.cpu()/.numpy()`` on a tainted value, or any
  ``np.``/``numpy.`` call inside a traced body.
- TS102 Python branch on a traced value: ``if``/``while`` whose test
  reads a tainted name.  Pure ``is``/``is not`` tests are exempt.
- TS103 nondeterministic set iteration feeding tensor builders: a
  ``for`` (or comprehension) over a set display/comprehension/``set()``
  result, not wrapped in ``sorted()``, in a function that also builds
  tensors (``np``'s and ``jnp``'s ``array/asarray/zeros/full/stack/…``,
  and ``torch.tensor/as_tensor/zeros/full/stack/cat``).  Scanned in ALL
  functions, not just traced ones — the host-side tensorizer is where
  iteration order becomes device-visible data.

The port runs nothing under a torch tracer today (no ``torch.compile``,
``torch.jit``, CUDA-graph capture or ``torch.func``), so on its tree only
TS103 can fire; the torch fixture
(``tests/torch_analysis_fixtures/fixture_trace_safety.py``) is what
exercises TS101 and TS102.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, iter_py_files

DEFAULT_PATHS = [
    "kubernetes_tpu_torch/ops",
    "kubernetes_tpu_torch/models",
    "kubernetes_tpu_torch/parallel",
]

#: tracer entry points, by dotted name with any ``torch.`` prefix removed:
#: a function passed into one (or decorated by one) runs under trace.
#: ``compile`` alone would be the builtin, so it counts only as
#: ``torch.compile``
TRACER_CALLS = {
    "compile",
    "jit.script",
    "jit.trace",
    "func.vmap",
    "func.grad",
    "func.grad_and_value",
    "func.functional_call",
    "vmap",
    "cuda.make_graphed_callables",
}
#: the same tracers imported by their own names (``from torch.func
#: import vmap``)
TRACER_BARE_NAMES = {"vmap", "functional_call", "make_graphed_callables"}
#: ``with torch.cuda.graph(g):`` — the body is captured
CAPTURE_CALLS = {"cuda.graph"}
DEVICE_MODULES = {"torch"}
HOST_CAST_CALLS = {"float", "int", "bool", "complex"}
HOST_ATTR_CALLS = {"item", "tolist", "numpy", "cpu"}
NP_MODULES = {"np", "numpy", "onp"}
TENSOR_BUILDER_ATTRS = {
    "array",
    "asarray",
    "stack",
    "concatenate",
    "zeros",
    "ones",
    "full",
    "empty",
    "frombuffer",
    "fromiter",
}
#: torch's tensor builders (TS103)
TORCH_BUILDER_ATTRS = {"tensor", "as_tensor", "zeros", "full", "stack", "cat"}


def _func_defs(tree: ast.AST) -> list[tuple[ast.AST, tuple[str, ...]]]:
    """All function defs with their dotted scope path (classes included)."""
    out: list[tuple[ast.AST, tuple[str, ...]]] = []

    def walk(node: ast.AST, scope: tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, scope + (child.name,)))
                walk(child, scope + (child.name,))
            elif isinstance(child, ast.ClassDef):
                walk(child, scope + (child.name,))
            else:
                walk(child, scope)

    walk(tree, ())
    return out


def _dotted(expr: ast.expr) -> Optional[str]:
    """``torch.func.vmap`` -> "torch.func.vmap"; None past a call."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_tracer(expr: ast.expr, names: frozenset = frozenset(TRACER_CALLS)) -> bool:
    """``expr`` names one of torch's tracers (``torch.compile``,
    ``torch.jit.script``, ``torch.func.vmap``, a bare ``vmap`` …)."""
    dotted = _dotted(expr)
    if dotted is None:
        return False
    if dotted.startswith("torch."):
        return dotted[len("torch."):] in names
    if "." not in dotted:
        return dotted in TRACER_BARE_NAMES and dotted in names
    return dotted in names


def _is_tracer_decorator(dec: ast.expr) -> bool:
    if _is_tracer(dec):
        return True
    if isinstance(dec, ast.Call):
        # @torch.compile(mode=…) and @partial(torch.compile, …)
        if _is_tracer_decorator(dec.func):
            return True
        fn = dec.func
        if (isinstance(fn, ast.Name) and fn.id == "partial") or (
            isinstance(fn, ast.Attribute) and fn.attr == "partial"
        ):
            return any(_is_tracer_decorator(a) for a in dec.args)
    return False


def _capture_bodies(tree: ast.AST) -> list[ast.With]:
    """``with torch.cuda.graph(g):`` blocks: their bodies are captured."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and _is_tracer(item.context_expr.func, frozenset(CAPTURE_CALLS))
                for item in node.items):
            out.append(node)
    return out


def _is_static_flag_param(arg: ast.arg, default: Optional[ast.expr]) -> bool:
    """bool-annotated or bool/None-defaulted parameters are the static-flag
    idiom — excluded from taint."""
    ann = arg.annotation
    if isinstance(ann, ast.Name) and ann.id == "bool":
        return True
    if isinstance(ann, ast.Constant) and ann.value == "bool":
        return True
    if isinstance(default, ast.Constant) and (
        default.value is None or isinstance(default.value, bool)
    ):
        return True
    return False


def _is_partial_call(call: ast.Call) -> bool:
    fn = call.func
    return (isinstance(fn, ast.Name) and fn.id == "partial") or (
        isinstance(fn, ast.Attribute) and fn.attr == "partial"
    )


class _ModuleTraceIndex:
    """Which functions in one module execute under trace."""

    def __init__(self, tree: ast.AST):
        self.defs = _func_defs(tree)
        self.by_node: dict[ast.AST, tuple[str, ...]] = {
            node: path for node, path in self.defs
        }
        self.by_name: dict[str, list[ast.AST]] = {}
        for node, path in self.defs:
            self.by_name.setdefault(path[-1], []).append(node)
        # name = partial(fn, ...) aliases (module/class/function level):
        # a consumer receiving the alias name traces the wrapped fn
        self.partial_aliases: dict[str, list[str]] = {}
        for stmt in ast.walk(tree):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value is not None:
                refs = self._partial_refs(stmt.value)
                if refs:
                    targets = (stmt.targets if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    for t in targets:
                        for name in _assigned_names(t):
                            self.partial_aliases.setdefault(name, []).extend(refs)
        self.traced: set[ast.AST] = set()
        self._seed_roots(tree)
        self._closure()

    def _partial_refs(self, expr: ast.expr) -> list[str]:
        """Function names a ``partial(...)`` expression wraps (first
        positional arg, by bare name or attribute tail)."""
        if not (isinstance(expr, ast.Call) and _is_partial_call(expr) and expr.args):
            return []
        head = expr.args[0]
        if isinstance(head, ast.Name):
            return [head.id]
        if isinstance(head, ast.Attribute):
            return [head.attr]
        return []

    def _callable_refs(self, arg: ast.expr) -> list[str]:
        """Possible function-def names one consumer argument references:
        a bare name, a bound-method reference (``self._step`` →
        ``_step``), a ``partial(fn, …)`` wrapper, or a name aliasing a
        partial (interprocedural taint, ROADMAP open item)."""
        if isinstance(arg, ast.Name):
            return [arg.id] + self.partial_aliases.get(arg.id, [])
        if isinstance(arg, ast.Attribute):
            return [arg.attr]
        refs = self._partial_refs(arg)
        out = list(refs)
        for r in refs:
            out.extend(self.partial_aliases.get(r, []))
        return out

    def _seed_roots(self, tree: ast.AST) -> None:
        for node, _path in self.defs:
            if any(_is_tracer_decorator(d) for d in node.decorator_list):
                self.traced.add(node)
        for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
            if _is_tracer(call.func):
                for arg in list(call.args) + [kw.value for kw in call.keywords]:
                    for name in self._callable_refs(arg):
                        for fn in self.by_name.get(name, ()):
                            self.traced.add(fn)
        # what a CUDA-graph capture body calls runs under the capture
        self.captures = _capture_bodies(tree)
        for block in self.captures:
            for stmt in block.body:
                for call in (n for n in ast.walk(stmt) if isinstance(n, ast.Call)):
                    names: list[str] = []
                    if isinstance(call.func, ast.Name):
                        names.extend(self._callable_refs(call.func))
                    elif (isinstance(call.func, ast.Attribute)
                          and isinstance(call.func.value, ast.Name)
                          and call.func.value.id in ("self", "cls")):
                        names.append(call.func.attr)
                    for name in names:
                        for fn in self.by_name.get(name, ()):
                            self.traced.add(fn)

    def _closure(self) -> None:
        changed = True
        while changed:
            changed = False
            for node in list(self.traced):
                # nested defs run at trace time
                for child, _ in self.defs:
                    if child not in self.traced and self._encloses(node, child):
                        self.traced.add(child)
                        changed = True
                for call in (n for n in ast.walk(node) if isinstance(n, ast.Call)):
                    # simple-name calls out of a traced body
                    names: list[str] = []
                    if isinstance(call.func, ast.Name):
                        names.append(call.func.id)
                    # bound-method calls: self.helper(...) / cls.helper(...)
                    # run under the same trace (only the self/cls receiver
                    # is followed — other attribute calls are library code)
                    elif (isinstance(call.func, ast.Attribute)
                          and isinstance(call.func.value, ast.Name)
                          and call.func.value.id in ("self", "cls")):
                        names.append(call.func.attr)
                    # a traced body wrapping a helper in partial(...) will
                    # call it under trace wherever the wrapper flows
                    if _is_partial_call(call):
                        names.extend(self._partial_refs(call))
                    for name in names:
                        for fn in self.by_name.get(name, ()):
                            if fn not in self.traced:
                                self.traced.add(fn)
                                changed = True

    def _encloses(self, outer: ast.AST, inner: ast.AST) -> bool:
        return inner is not outer and any(
            n is inner
            for n in ast.walk(outer)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _has_device_call(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, (ast.Attribute, ast.Call)):
            root = n
            while isinstance(root, ast.Call):
                root = root.func
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in DEVICE_MODULES:
                return True
    return False


def _tainted_params(fn) -> set[str]:
    args = fn.args
    pos = list(args.posonlyargs) + list(args.args)
    defaults = list(args.defaults)
    # right-align defaults with positional args
    pad: list[Optional[ast.expr]] = [None] * (len(pos) - len(defaults)) + defaults
    tainted: set[str] = set()
    for arg, default in zip(pos, pad):
        if arg.arg == "self":
            continue
        if not _is_static_flag_param(arg, default):
            tainted.add(arg.arg)
    for arg, default in zip(args.kwonlyargs, args.kw_defaults):
        if not _is_static_flag_param(arg, default):
            tainted.add(arg.arg)
    if args.vararg:
        tainted.add(args.vararg.arg)
    if args.kwarg:
        tainted.add(args.kwarg.arg)
    return tainted


def _assigned_names(target: ast.expr) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: list[str] = []
        for el in target.elts:
            out.extend(_assigned_names(el))
        return out
    if isinstance(target, ast.Starred):
        return _assigned_names(target.value)
    return []


class _TraceBodyChecker(ast.NodeVisitor):
    """TS101/TS102 inside one traced function (nested defs are analyzed in
    their own right and skipped here)."""

    def __init__(self, fn, qual: str, rel: str, findings: list[Finding]):
        self.fn = fn
        self.qual = qual
        self.rel = rel
        self.findings = findings
        self.tainted = _tainted_params(fn)
        # dataflow fixpoint: two forward passes over the body cover the
        # loop-carried case (a name tainted later in a loop body)
        for _ in range(2):
            for stmt in ast.walk(fn):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    value = stmt.value
                    if value is None:
                        continue
                    targets = (
                        stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    )
                    if self._expr_tainted(value):
                        for t in targets:
                            self.tainted.update(_assigned_names(t))
                elif isinstance(stmt, ast.For):
                    if self._expr_tainted(stmt.iter):
                        self.tainted.update(_assigned_names(stmt.target))

    def _expr_tainted(self, expr: ast.expr) -> bool:
        return bool(_names_in(expr) & self.tainted) or _has_device_call(expr)

    def _emit(self, code: str, node: ast.AST, symbol_tail: str, msg: str) -> None:
        self.findings.append(
            Finding(
                code=code,
                path=self.rel,
                line=node.lineno,
                symbol=f"{self.qual}.{symbol_tail}",
                message=msg,
            )
        )

    # nested functions get their own checker
    def visit_FunctionDef(self, node) -> None:
        if node is not self.fn:
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in HOST_CAST_CALLS:
            if any(self._expr_tainted(a) for a in node.args):
                self._emit(
                    "TS101",
                    node,
                    fn.id,
                    f"host escape: `{fn.id}()` on a traced value concretizes at "
                    f"trace time (bakes a constant into the captured program)",
                )
        elif isinstance(fn, ast.Attribute):
            if fn.attr in HOST_ATTR_CALLS and self._expr_tainted(fn.value):
                self._emit(
                    "TS101",
                    node,
                    fn.attr,
                    f"host escape: `.{fn.attr}()` on a traced value forces a "
                    f"device→host sync inside a traced body",
                )
            else:
                root = fn
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in NP_MODULES:
                    self._emit(
                        "TS101",
                        node,
                        f"{root.id}.{fn.attr}",
                        f"host escape: `{root.id}.{fn.attr}()` call inside a traced "
                        f"body runs on host at trace time, not on the device",
                    )
        self.generic_visit(node)

    def _check_branch(self, node, kind: str) -> None:
        test = node.test
        if _is_identity_only(test):
            return
        hit = _names_in(test) & self.tainted
        if hit:
            self._emit(
                "TS102",
                node,
                f"{kind}.{'.'.join(sorted(hit))}",
                f"Python `{kind}` on traced value(s) {sorted(hit)}: use "
                f"`torch.where` (host branching on a tracer breaks or "
                f"specializes the captured graph)",
            )

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")
        self.generic_visit(node)


def _is_identity_only(test: ast.expr) -> bool:
    """`x is None` / `x is not None` never concretizes a tracer."""
    return isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    )


def _set_typed_names(fn) -> dict[str, int]:
    """Local names assigned a set display/comprehension/`set()` call."""
    out: dict[str, int] = {}
    for stmt in ast.walk(fn):
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            if stmt.value is None:
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            if _is_set_expr(stmt.value):
                for t in targets:
                    for name in _assigned_names(t):
                        out[name] = stmt.lineno
            else:
                for t in targets:
                    for name in _assigned_names(t):
                        out.pop(name, None)
    return out


def _is_set_expr(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
        return _is_set_expr(expr.left) or _is_set_expr(expr.right)
    return False


def _is_builder(n: ast.AST) -> bool:
    if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)):
        return False
    mod, attr = n.func.value.id, n.func.attr
    return ((mod in NP_MODULES | {"jnp"} and attr in TENSOR_BUILDER_ATTRS)
            or (mod == "torch" and attr in TORCH_BUILDER_ATTRS))


def _check_set_iteration(fn, qual: str, rel: str, findings: list[Finding]) -> None:
    has_builder = any(_is_builder(n) for n in ast.walk(fn))
    if not has_builder:
        return
    set_names = _set_typed_names(fn)

    def iter_expr_is_set(it: ast.expr) -> bool:
        if _is_set_expr(it):
            return True
        return isinstance(it, ast.Name) and it.id in set_names

    loops: list[tuple[ast.AST, ast.expr]] = []
    for n in ast.walk(fn):
        if isinstance(n, ast.For):
            loops.append((n, n.iter))
        elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in n.generators:
                loops.append((n, gen.iter))
    for node, it in loops:
        if iter_expr_is_set(it):
            findings.append(
                Finding(
                    code="TS103",
                    path=rel,
                    line=node.lineno,
                    symbol=f"{qual}.set-iter",
                    message=(
                        "iteration over a set in a tensor-building function: set "
                        "order is nondeterministic across processes — sort "
                        "(`sorted(...)`) before it can reach array contents"
                    ),
                )
            )


def run(root: str, paths: Optional[list[str]] = None) -> list[Finding]:
    findings: list[Finding] = []
    for abs_path, rel in iter_py_files(root, paths or DEFAULT_PATHS):
        with open(abs_path, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            findings.append(
                Finding(
                    code="TS100",
                    path=rel,
                    line=e.lineno or 1,
                    symbol="syntax",
                    message=f"unparseable file: {e.msg}",
                )
            )
            continue
        index = _ModuleTraceIndex(tree)
        for fn, path in index.defs:
            qual = ".".join(path)
            if fn in index.traced:
                checker = _TraceBodyChecker(fn, qual, rel, findings)
                for stmt in fn.body:
                    checker.visit(stmt)
            _check_set_iteration(fn, qual, rel, findings)
        # a capture body inside an untraced function: checked against that
        # function's taint (a traced owner's checker has covered it)
        for block in index.captures:
            owners = [(fn, path) for fn, path in index.defs
                      if fn.lineno <= block.lineno <= (fn.end_lineno or fn.lineno)]
            if not owners:
                continue
            fn, path = max(owners, key=lambda fp: fp[0].lineno)
            if fn in index.traced:
                continue
            checker = _TraceBodyChecker(fn, ".".join(path), rel, findings)
            for stmt in block.body:
                checker.visit(stmt)
    # one symbol can only anchor one finding per line (dedupe repeated walks)
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in findings:
        k = (f.code, f.path, f.line, f.symbol)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
