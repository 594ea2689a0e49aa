"""Device-contract lint (DC6xx): the device disciplines the wave path
lives by — live device pointers at every launch, the host-sync budget,
one kernel library for every shape, and clone-on-write snapshot hygiene —
enforced structurally instead of by comments and memory.

The pass scans ``ops/`` plus ``models/snapshot.py`` (the device seam) and
``parallel/``, with the shapes of the reference package's pass: lexical
annotations with mandatory reasons, name-level summaries propagated to a
fixed point, and over-approximation toward SILENCE — anything the
analysis cannot prove is dropped, never flagged.  The rules keep the
reference's codes; each is retargeted from JAX's device model (donated
buffers, ``jax.device_get``, compiled executables keyed by shape) to
torch's and to the ctypes launches of this package's CUDA kernels.

Rules
-----
- **DC600** — a file in scope does not parse.
- **DC601** — *dead device pointer*, the counterpart of use-after-donate:
  the launches hand ``.data_ptr()`` values to ``ctypes`` structures, and
  the pointer is dead when no live name holds its tensor up to the launch
  call.  Flagged: a ``.data_ptr()`` of a temporary (a call's result, as
  ``t.clone().data_ptr()`` or ``x.to(...).data_ptr()``; a same-module
  function or method that returns a tensor its arguments or ``self``
  keep is not a temporary), and a ``.data_ptr()`` of a local name that
  is rebound or deleted before the launch call (a ``launch`` or
  ``*_launch`` call) in the same function, or in the one-hop callee that
  builds the structure (``params(...)`` → ``fused_scan_launch``).
  Pointers of a parameter (the caller's ``bufs``) are held by the caller
  and are clean.
- **DC602** — *host-sync budget*, on the wave hot path (tracecov's
  ``HOT_PATH_MODULES``): a sync site must carry ``# device: sync —
  <reason>`` on its line or the line above.  A sync site is ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")`` or
  ``.to(torch.device("cpu"))`` on a device-tainted tensor,
  ``float()``/``int()``/``bool()`` of one, ``torch.cuda.synchronize()``,
  and ``.synchronize()`` on a stream or an event.  Device taint starts at
  a tensor made with ``device=`` a non-CPU device, at ``.to(device)`` and
  ``.cuda()``, and at the packed buffers of the launch wrappers
  (``bufs``, ``ctl``, ``alive``, ``_chosen`` and the like), and follows
  assignments, tensor methods and ``torch.`` calls; a ``.cpu()`` result is
  host, so ``int(ctl[CTL_CURSOR])`` after ``ctl = self._ctl.cpu()`` is
  not a second site.  :func:`sanctioned_sync_sites` counts the sanctioned
  sites per function, and a runtime test holds the frontier's
  ``host_syncs`` stat to that count.
- **DC603** — *the build identity*: the port compiles no program per
  shape — ``_build.library_path`` hashes only the sources and
  ``NVCC_FLAGS`` — so one library serves every shape.  No value derived
  from a tensor's shape (``.shape``, ``.ndim``, ``.size()``,
  ``.numel()``, ``len()``), a planner field (``Plan``/``plan(...)``) or a
  segment-static dimension (``ScanStatic``) may flow into
  ``_build.build``, ``_build.load``, ``library_path``, ``NVCC_FLAGS`` or
  a ``-D`` define, directly or through a same-module helper whose
  parameter reaches one of them.  ``# device: static`` sanctions a site.
  The reference's sub-rules on ``_pad_to``, ``_pow2_width`` and
  ``lru_cache`` jit factories guard the identity of compiled executables,
  which the port does not have (its kernels take every shape as a
  runtime argument), so they are not carried over.
- **DC604** — *CoW snapshot writes*: in any scanned function that
  receives the scheduler snapshot (a ``node_info_map`` parameter, or a
  ``dict(node_info_map)`` working copy), mutating a ``NodeInfo``
  obtained from that map without flowing through ``mutable_info``.
- **DC605** — a stale or reasonless device annotation: a ``# device:
  sync`` with no materialization-shaped call on its line or the next
  (lexical, so an annotation stays valid where the taint
  under-approximates), a sync annotation with no reason, or a ``# device:
  static`` sanctioning no build-identity site and with no call on its
  line or the next (lexical for the same reason).

Deliberately NOT modeled (over-approximating toward silence): pointers
held through containers or across modules (a pointer built in another
module's helper is trusted); taint through functions defined outside the
scanned module; CoW aliasing through collaborator objects.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .core import Finding, iter_py_files
from .trace_safety import _ModuleTraceIndex
from .tracecov import HOT_PATH_MODULES

DEFAULT_PATHS = [
    "kubernetes_tpu_torch/ops",
    "kubernetes_tpu_torch/models/snapshot.py",
    "kubernetes_tpu_torch/parallel",
]

#: NodeInfo's mutating surface (scheduler/nodeinfo.py); ``clone()`` is
#: deliberately absent — cloning IS the sanctioned CoW step.
NODEINFO_MUTATORS = {
    "add_pod", "add_pod_counted", "remove_pod", "replace_pod",
    "set_node", "remove_node",
}

#: tensor metadata — reading these never materializes device memory
_METADATA_ATTRS = {"shape", "ndim", "size", "dtype", "nbytes", "device",
                   "is_cuda", "layout", "requires_grad"}
#: attributes of a tensor that are tensors (any other attribute of a
#: value is a field of a record — ``s.use_terms`` of a ScanStatic — and
#: is not followed)
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}
#: tensor methods whose result lives on the host
_HOST_METHODS = {"cpu", "numpy", "tolist", "item"}
#: methods that read metadata or drive streams and events, not values
_META_METHODS = {"size", "numel", "dim", "element_size", "data_ptr",
                 "is_contiguous", "stride", "storage_offset", "nelement",
                 "get_device", "query", "elapsed_time", "record",
                 "synchronize", "wait_event", "wait_stream", "record_event"}
#: names under which the launch wrappers keep their packed device
#: buffers (leading underscores ignored): a parameter, attribute or free
#: name so called is device-resident
DEVICE_BUFFER_NAMES = {"bufs", "ctl", "alive", "chosen", "shard_bufs"}
#: module roots whose calls are library functions, not tensor methods
_MODULE_ROOTS = {"torch", "np", "numpy", "F", "math", "ctypes"}
#: torch dtypes: ``.to(torch.int32)`` converts in place, it moves nothing
_DTYPES = {"bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "half", "float", "double",
           "long", "int", "short"}

_SYNC_ANN_RE = re.compile(
    r"#\s*device:\s*sync\s*(?:—|–|-{1,2})?\s*(.*)$")
_STATIC_ANN_RE = re.compile(r"#\s*device:\s*static\b")
#: lexical materialization shapes for the DC605 stale-sync check — kept
#: looser than the AST forms so a sanctioned site the taint misses does
#: not round-trip into a stale-annotation finding
_SYNC_LEXEME_RE = re.compile(
    r"\.item\(|\.tolist\(|\.cpu\(|\.numpy\(|\.to\(\s*(?:device\s*=\s*)?"
    r"(?:[\"']cpu[\"']|torch\.device\(\s*[\"']cpu)|\bint\(|\bfloat\(|"
    r"\bbool\(|synchronize\(|np\.asarray\(|np\.array\(")

#: a call: what a ``# device: static`` must have on its line or the next
_CALL_LEXEME_RE = re.compile(r"\w\s*\(")
#: the calls that make or name a kernel library
_BUILD_SINKS = {"build", "load", "library_path"}
#: conversions a label looks through to the shape-bearing value inside
_LABEL_THROUGH = {"int", "str", "float", "bool", "round", "abs", "max",
                  "min", "hex", "format"}
#: methods whose result is a shape
_SHAPE_METHODS = {"size", "numel", "dim"}


class _Func:
    __slots__ = ("node", "qualname", "name", "parent")

    def __init__(self, node, qualname: str, parent: "Optional[_Func]"):
        self.node = node
        self.qualname = qualname
        self.name = node.name
        self.parent = parent  # enclosing _Func, None at module/class level


def _collect_funcs(tree: ast.Module) -> list[_Func]:
    out: list[_Func] = []

    def visit(node, prefix: str, parent: Optional[_Func]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                f = _Func(child, qual, parent)
                out.append(f)
                visit(child, qual, f)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix
                      else child.name, parent)
            else:
                visit(child, prefix, parent)

    visit(tree, "", None)
    return out


def _enclosing(funcs: list[_Func], line: int) -> Optional[_Func]:
    best: Optional[_Func] = None
    for f in funcs:
        if f.node.lineno <= line <= (f.node.end_lineno or f.node.lineno):
            if best is None or f.node.lineno > best.node.lineno:
                best = f
    return best


def _attr_root(node: ast.expr) -> Optional[str]:
    """``torch.sum`` / ``torch.cuda.synchronize`` -> the base Name
    ("torch")."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _callee_attr_name(call: ast.Call) -> Optional[str]:
    """The method name of ``X.m(...)``; None for bare calls."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _own_returns(fn: ast.FunctionDef) -> list[ast.Return]:
    """Return statements owned by ``fn`` itself, nested defs excluded."""
    out: list[ast.Return] = []

    def walk(node) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Return):
                out.append(child)
            walk(child)

    walk(fn)
    return out


def _own_statements(fn: ast.FunctionDef):
    """Statement-level nodes owned by ``fn``, nested def bodies excluded."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield child
            yield from walk(child)

    yield from walk(fn)


def _is_cpu(expr: Optional[ast.expr]) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` / ``None`` (the default)."""
    if expr is None:
        return True
    if isinstance(expr, ast.Constant):
        return expr.value is None or expr.value == "cpu"
    if (isinstance(expr, ast.Call) and _attr_root(expr.func) == "torch"
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "device" and expr.args):
        return _is_cpu(expr.args[0])
    return False


def _device_kw(call: ast.Call) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _is_dtype(expr: ast.expr) -> bool:
    return (isinstance(expr, ast.Attribute) and expr.attr in _DTYPES
            and isinstance(expr.value, ast.Name) and expr.value.id == "torch")


def _to_target(call: ast.Call) -> Optional[ast.expr]:
    """The device a ``.to(...)`` call moves to; None for a dtype-only
    conversion (``.to(torch.int32)``)."""
    dev = _device_kw(call)
    if dev is not None:
        return dev
    if call.args and not _is_dtype(call.args[0]):
        return call.args[0]
    return None


def _buffer_named(name: str) -> bool:
    return name.lstrip("_") in DEVICE_BUFFER_NAMES


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


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _stored_names(fn) -> set[str]:
    """Names ``fn`` itself binds (nested defs excluded)."""
    out: set[str] = set()
    for stmt in _own_statements(fn):
        if isinstance(stmt, ast.Name) and isinstance(stmt.ctx, (ast.Store, ast.Del)):
            out.add(stmt.id)
    return out


class _ModuleIndex:
    """Per-module summaries: device-returning module functions, class
    attribute taint, and per-function local environments."""

    def __init__(self, tree: ast.Module, funcs: list[_Func]):
        self.tree = tree
        self.funcs = funcs
        self.top_fns: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        for child in ast.iter_child_nodes(tree):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.top_fns[child.name] = child
            elif isinstance(child, ast.ClassDef):
                self.classes[child.name] = child
        self.device_fns: set[str] = set()
        self.cls_attrs: dict[str, set[str]] = {}
        self._build_device_summaries()

    # -- device-value summaries --------------------------------------------

    def _build_device_summaries(self) -> None:
        for _round in range(3):  # module fns x class attrs to a fixed point
            before = (len(self.device_fns),
                      sum(len(s) for s in self.cls_attrs.values()))
            for name, fn in self.top_fns.items():
                if name in self.device_fns:
                    continue
                env = self.local_env(fn, cls=None)
                returns = _own_returns(fn)
                if returns and all(
                        r.value is not None
                        and self.expr_is_device(r.value, env)
                        for r in returns):
                    self.device_fns.add(name)
            for cname, cls in self.classes.items():
                attrs = self.cls_attrs.setdefault(cname, set())
                for item in ast.walk(cls):
                    if not isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                        continue
                    env = self.local_env(item, cls=cname)
                    for stmt in _own_statements(item):
                        self._class_taint_stmt(stmt, env, attrs)
            after = (len(self.device_fns),
                     sum(len(s) for s in self.cls_attrs.values()))
            if after == before:
                break

    def _class_taint_stmt(self, stmt, env, attrs: set[str]) -> None:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._class_taint_pair(t, stmt.value, env, attrs)
        elif isinstance(stmt, ast.AugAssign):
            a = _self_attr(stmt.target)
            if a is not None and self.expr_is_device(stmt.value, env):
                attrs.add(a)
        elif isinstance(stmt, ast.Call):
            # self.X.append(device-ish) taints the container attr
            if (isinstance(stmt.func, ast.Attribute)
                    and stmt.func.attr in ("append", "extend")
                    and stmt.args):
                a = _self_attr(stmt.func.value)
                if a is not None and self._any_device(stmt.args[0], env):
                    attrs.add(a)

    def _class_taint_pair(self, target, value, env, attrs) -> None:
        a = _self_attr(target)
        if a is not None:
            if self.expr_is_device(value, env):
                attrs.add(a)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            if (isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)):
                for t, v in zip(target.elts, value.elts):
                    self._class_taint_pair(t, v, env, attrs)
            elif self.expr_is_device(value, env):
                for t in target.elts:
                    at = _self_attr(t)
                    if at is not None:
                        attrs.add(at)

    # -- environments -------------------------------------------------------

    def local_env(self, fn, cls: Optional[str]):
        """(tainted locals, locals ``fn`` binds, class name, bindings) for
        ``fn``: two flow-insensitive sweeps for ordering independence,
        then each plain binding's taint in line order, so a use reads the
        binding before it (``out = out.cpu()`` makes the later ``out``
        host).  A name ``fn`` binds is device only by what it is bound
        to; a parameter or free name by its name (the launch wrappers'
        buffers)."""
        tainted: set[str] = {p for p in _params(fn) if _buffer_named(p)}
        assigned = _stored_names(fn)
        bindings: dict[str, list[tuple[int, bool]]] = {}
        env = (tainted, assigned, cls, bindings)
        for _sweep in range(2):
            for stmt in _own_statements(fn):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        self._env_pair(t, stmt.value, env)
                elif isinstance(stmt, ast.AugAssign):
                    if (isinstance(stmt.target, ast.Name)
                            and self.expr_is_device(stmt.value, env)):
                        tainted.add(stmt.target.id)
                elif isinstance(stmt, ast.For):
                    if self.expr_is_device(stmt.iter, env):
                        for n in ast.walk(stmt.target):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
                elif isinstance(stmt, ast.Call):
                    if (isinstance(stmt.func, ast.Attribute)
                            and stmt.func.attr in ("append", "extend")
                            and stmt.args
                            and isinstance(stmt.func.value, ast.Name)
                            and self._any_device(stmt.args[0], env)):
                        tainted.add(stmt.func.value.id)
        stmts = sorted((s for s in _own_statements(fn)
                        if isinstance(s, (ast.Assign, ast.AugAssign))),
                       key=lambda s: s.lineno)
        for stmt in stmts:
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    dev = self.expr_is_device(stmt.value, env)
                    if isinstance(stmt, ast.AugAssign):
                        dev = dev or self.expr_is_device(t, env)
                    bindings.setdefault(t.id, []).append((stmt.lineno, dev))
        return env

    def _env_pair(self, target, value, env) -> None:
        tainted = env[0]
        if isinstance(target, ast.Name):
            if self.expr_is_device(value, env):
                tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if (isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)):
                for t, v in zip(target.elts, value.elts):
                    self._env_pair(t, v, env)
            elif self.expr_is_device(value, env):
                for n in target.elts:
                    if isinstance(n, ast.Name):
                        tainted.add(n.id)

    # -- expression classification ------------------------------------------

    def _any_device(self, expr, env) -> bool:
        """ANY-part device — used for container taint, where a list
        holding one device tensor makes the container device-bearing."""
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._any_device(e, env) for e in expr.elts)
        return self.expr_is_device(expr, env)

    def _args_device(self, call: ast.Call, env) -> bool:
        return (any(self._any_device(a, env) for a in call.args)
                or any(kw.value is not None and self._any_device(kw.value, env)
                       for kw in call.keywords))

    def _comp_device(self, expr, env) -> bool:
        """A comprehension's elements: its targets are device when what
        they iterate is."""
        tainted, assigned, cls, bindings = env
        inner = set(tainted)
        bound = set(assigned)
        for gen in expr.generators:
            names = {n.id for n in ast.walk(gen.target) if isinstance(n, ast.Name)}
            bound |= names
            scope = {k: v for k, v in bindings.items() if k not in names}
            if self.expr_is_device(gen.iter, (inner, bound, cls, scope)):
                inner |= names
        return self.expr_is_device(expr.elt, (inner, bound, cls, scope))

    def expr_is_device(self, expr, env) -> bool:
        tainted, assigned, cls, bindings = env
        if isinstance(expr, ast.Name):
            before = [dev for ln, dev in bindings.get(expr.id, ())
                      if ln < expr.lineno]
            if before:
                return before[-1]
            return expr.id in tainted or (
                expr.id not in assigned and _buffer_named(expr.id))
        if isinstance(expr, ast.Attribute):
            if expr.attr in _METADATA_ATTRS:
                return False
            a = _self_attr(expr)
            if a is not None:
                return _buffer_named(a) or (
                    cls is not None and a in self.cls_attrs.get(cls, set()))
            return expr.attr in _TENSOR_ATTRS and self.expr_is_device(expr.value, env)
        if isinstance(expr, ast.Subscript):
            return self.expr_is_device(expr.value, env)
        if isinstance(expr, ast.Starred):
            return self.expr_is_device(expr.value, env)
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return self._comp_device(expr, env)
        if isinstance(expr, ast.Call):
            dev = _device_kw(expr)
            if dev is not None and not _is_cpu(dev):
                return True  # made on a device
            func = expr.func
            if isinstance(func, ast.Attribute):
                m = func.attr
                if m in _HOST_METHODS or m in _META_METHODS:
                    return False
                if m == "cuda":
                    return True
                if m == "to":
                    target = _to_target(expr)
                    if target is not None:
                        return not _is_cpu(target)
                    return self.expr_is_device(func.value, env)
                root = _attr_root(func)
                if root in _MODULE_ROOTS:
                    # a library function: device when what it takes is
                    return root == "torch" and self._args_device(expr, env)
                if _self_attr(func) is not None:
                    return False  # a method of this object: not modeled
                return self.expr_is_device(func.value, env)
            if isinstance(func, ast.Name):
                if func.id in self.device_fns:
                    return True
                if func.id[:1].isupper() and self._args_device(expr, env):
                    # a record (ScanState/ScanStatic) over device tensors
                    return True
            return False
        if isinstance(expr, (ast.Tuple, ast.List)):
            return bool(expr.elts) and all(
                self.expr_is_device(e, env) for e in expr.elts)
        if isinstance(expr, ast.BinOp):
            return (self.expr_is_device(expr.left, env)
                    or self.expr_is_device(expr.right, env))
        if isinstance(expr, ast.BoolOp):
            return any(self.expr_is_device(v, env) for v in expr.values)
        if isinstance(expr, ast.UnaryOp):
            return self.expr_is_device(expr.operand, env)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False  # identity is a Python bool
            return (self.expr_is_device(expr.left, env)
                    or any(self.expr_is_device(c, env)
                           for c in expr.comparators))
        if isinstance(expr, ast.IfExp):
            return (self.expr_is_device(expr.body, env)
                    and self.expr_is_device(expr.orelse, env))
        return False


# -- annotations ------------------------------------------------------------


def _scan_annotations(src_lines: list[str]):
    """(sync annotations: line -> reason-or-None, static annotation
    lines).  Lines are 1-based."""
    sync: dict[int, Optional[str]] = {}
    static: set[int] = set()
    for i, line in enumerate(src_lines, start=1):
        m = _SYNC_ANN_RE.search(line)
        if m:
            reason = (m.group(1) or "").strip()
            sync[i] = reason or None
        elif _STATIC_ANN_RE.search(line):
            static.add(i)
    return sync, static


def _sync_sanctioned(sync_ann: dict[int, Optional[str]], line: int) -> bool:
    """A site is sanctioned by a reasoned sync annotation on its own line
    or the line above."""
    return bool(sync_ann.get(line) or sync_ann.get(line - 1))


def _materialization(call: ast.Call):
    """(operand expr or None, form label) when ``call`` is a host-sync
    shape; None otherwise.  A ``synchronize()`` has no operand: it is a
    sync whatever it is called on."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in ("int", "float", "bool") and len(call.args) == 1:
            return call.args[0], func.id
        return None
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr in ("item", "tolist", "cpu", "numpy") and not call.args:
            return func.value, attr
        if attr == "to":
            target = _to_target(call)
            if target is not None and _is_cpu(target):
                return func.value, "to"
        if attr == "synchronize":
            return None, "synchronize"
    return None


def _expr_label(expr: ast.expr) -> Optional[str]:
    """A stable dotted label for a simple operand (``self._state.round_robin``
    -> ``_state.round_robin``); a tensor method chain labels by its
    receiver (``self._ctl.cpu()`` -> ``_ctl``) and a library call by its
    first operand (``torch.sum(x)`` -> ``x``); None for complex
    expressions."""
    parts: list[str] = []
    while True:
        if isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        elif isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            func = expr.func
            if (isinstance(func, ast.Attribute)
                    and _attr_root(func) not in _MODULE_ROOTS):
                expr = func.value
            elif expr.args:
                expr = expr.args[0]
            else:
                return None
        elif isinstance(expr, ast.Name):
            if expr.id != "self":
                parts.append(expr.id)
            return ".".join(reversed(parts)) if parts else None
        else:
            return None


# -- the pass ---------------------------------------------------------------


def _analyze_file(rel: str, tree: ast.Module, src_lines: list[str],
                  hot: set[str]) -> list[Finding]:
    findings: list[Finding] = []
    funcs = _collect_funcs(tree)
    idx = _ModuleIndex(tree, funcs)
    sync_ann, static_ann = _scan_annotations(src_lines)
    # functions whose bodies run under a torch tracer: host escapes there
    # are trace-safety's beat (TS101), not a sync-budget question
    traced = _ModuleTraceIndex(tree).traced

    def cls_of(f: _Func) -> Optional[str]:
        parts = f.qualname.split(".")
        return parts[0] if parts[0] in idx.classes else None

    env_cache: dict[int, tuple] = {}

    def env_of(f: _Func):
        got = env_cache.get(id(f))
        if got is None:
            got = idx.local_env(f.node, cls=cls_of(f))
            # closure visibility: merge the enclosing chain's environment
            # so a nested def reading an outer device local stays modeled
            p = f.parent
            while p is not None:
                pt, pa, _, pb = env_of(p)
                got[0].update(pt)
                got[1].update(pa)
                for name, bs in pb.items():
                    got[3].setdefault(name, bs)
                p = p.parent
            env_cache[id(f)] = got
        return got

    _dc601(rel, findings, funcs, cls_of)
    if rel in hot:
        _dc602(rel, findings, funcs, idx, env_of, traced, sync_ann)
    used_static = _dc603(rel, findings, funcs, idx, static_ann)
    _dc604(rel, findings, funcs, idx)
    _dc605(rel, findings, funcs, src_lines, sync_ann, static_ann, used_static)
    # one symbol anchors one finding per line
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in findings:
        key = (f.code, f.line, f.symbol)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -- DC601: dead device pointers ----------------------------------------------


def _is_launch(call: ast.Call) -> bool:
    func = call.func
    name = (func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else None)
    return name is not None and (name == "launch" or name.endswith("_launch"))


def _data_ptrs(fn) -> list[ast.Call]:
    """``X.data_ptr()`` calls ``fn`` itself makes (nested defs excluded)."""
    return [n for n in _own_statements(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "data_ptr" and not n.args]


def _name_label(fn, name: str) -> str:
    """What a local names: the label of the first value bound to it
    (``state = self._state.clone()`` -> ``_state``), else the name."""
    for stmt in _own_statements(fn):
        if isinstance(stmt, ast.Assign) and any(
                name in _assigned_names(t) for t in stmt.targets):
            got = _expr_label(stmt.value)
            if got:
                return got
    return name


def _kills(fn, name: str, lo: int, hi: int) -> list[int]:
    """Lines in (lo, hi) where ``fn`` rebinds or deletes ``name``."""
    return sorted(n.lineno for n in _own_statements(fn)
                  if isinstance(n, ast.Name) and n.id == name
                  and isinstance(n.ctx, (ast.Store, ast.Del))
                  and lo < n.lineno < hi)


def _dead_ptrs(fn, hi: int) -> list[tuple[int, str, int]]:
    """(pointer line, local name, kill line) for each ``x.data_ptr()`` of
    a local or parameter ``x`` that ``fn`` rebinds or deletes before line
    ``hi``."""
    out = []
    for call in _data_ptrs(fn):
        recv = call.func.value
        if not isinstance(recv, ast.Name) or call.lineno > hi:
            continue
        kills = _kills(fn, recv.id, call.lineno, hi)
        if kills:
            out.append((call.lineno, recv.id, kills[0]))
    return out


def _held_return(fn, cls: Optional[str]) -> bool:
    """Every value ``fn`` returns is a tensor something outlives the call
    with: its arguments' containers (``bufs["x"]``, ``bufs.get(...)``) or
    ``self`` — a cache getter, not a temporary."""
    params = set(_params(fn)) - {"self"}

    def rooted(expr) -> bool:
        while isinstance(expr, (ast.Subscript, ast.Attribute)):
            expr = expr.value
        return isinstance(expr, ast.Name) and (
            expr.id in params or (expr.id == "self" and cls is not None))

    def held(expr) -> bool:
        if isinstance(expr, (ast.Subscript, ast.Attribute)):
            return rooted(expr)
        if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                and expr.func.attr == "get"):
            return rooted(expr.func.value)
        if isinstance(expr, ast.Name):
            binds = [s for s in _own_statements(fn) if isinstance(s, ast.Assign)
                     and any(isinstance(t, ast.Name) and t.id == expr.id
                             for t in s.targets)]
            stored = any(isinstance(s, ast.Assign) and isinstance(s.value, ast.Name)
                         and s.value.id == expr.id
                         and any(isinstance(t, (ast.Subscript, ast.Attribute))
                                 and rooted(t) for t in s.targets)
                         for s in _own_statements(fn))
            return stored or (bool(binds) and all(
                held(s.value) or any(isinstance(t, (ast.Subscript, ast.Attribute))
                                     and rooted(t) for t in s.targets)
                for s in binds))
        return False

    returns = _own_returns(fn)
    return bool(returns) and all(r.value is not None and held(r.value)
                                 for r in returns)


def _dc601(rel, findings, funcs, cls_of) -> None:
    def callee_of(f: _Func, call: ast.Call) -> Optional[_Func]:
        """The same-module function a call reaches: a module function or
        a sibling nested def by bare name, a method by ``self.m``."""
        if isinstance(call.func, ast.Name):
            name = call.func.id
            for g in funcs:
                if g.name == name and (g.parent is None and "." not in g.qualname
                                       or g.parent is f.parent and g is not f):
                    return g
            return None
        m = _self_attr(call.func)
        cname = cls_of(f)
        if m is None or cname is None:
            return None
        for g in funcs:
            if g.qualname == f"{cname}.{m}":
                return g
        return None

    # a pointer of a temporary is dead wherever it is taken
    for f in funcs:
        for call in _data_ptrs(f.node):
            recv = call.func.value
            if not isinstance(recv, ast.Call):
                continue
            callee = callee_of(f, recv)
            if callee is not None and _held_return(callee.node, cls_of(callee)):
                continue
            label = _expr_label(recv) or "<temporary>"
            findings.append(Finding(
                code="DC601", path=rel, line=call.lineno,
                symbol=f"{f.qualname}.{label}",
                message=(
                    f"dead device pointer: `.data_ptr()` of a temporary "
                    f"(`{label}` through a call) — nothing holds the tensor, "
                    f"so it is freed when the expression ends and the launch "
                    f"reads freed (or reused) device memory; bind it to a "
                    f"name that lives past the launch"
                ),
            ))
    # a local rebound or deleted between its pointer and the launch: in
    # the launching function, or in the one-hop callee building the block
    for f in funcs:
        launches = [n for n in _own_statements(f.node)
                    if isinstance(n, ast.Call) and _is_launch(n)]
        for launch in launches:
            for ln, name, kill in _dead_ptrs(f.node, launch.lineno):
                label = _name_label(f.node, name)
                findings.append(Finding(
                    code="DC601", path=rel, line=ln,
                    symbol=f"{f.qualname}.{label}",
                    message=(
                        f"dead device pointer: `{name}.data_ptr()` is handed "
                        f"to the launch at line {launch.lineno}, but `{name}` "
                        f"is rebound or deleted at line {kill} — nothing may "
                        f"hold the tensor when the kernel reads it"
                    ),
                ))
            end = launch.end_lineno or launch.lineno
            for call in _own_statements(f.node):
                if (not isinstance(call, ast.Call) or call is launch
                        or call.lineno > end):
                    continue
                callee = callee_of(f, call)
                if callee is None or callee.node is f.node:
                    continue
                hi = callee.node.end_lineno or callee.node.lineno
                for _ln, name, kill in _dead_ptrs(callee.node, hi + 1):
                    label = _name_label(callee.node, name)
                    findings.append(Finding(
                        code="DC601", path=rel, line=call.lineno,
                        symbol=f"{f.qualname}.{label}.{callee.name}",
                        message=(
                            f"dead device pointer: `{callee.qualname}` (called "
                            f"here, before the launch at line {launch.lineno}) "
                            f"takes `{name}.data_ptr()` and rebinds or deletes "
                            f"`{name}` at line {kill} — the launch gets the "
                            f"pointer of a tensor nothing holds"
                        ),
                    ))


# -- DC602: the host-sync budget ----------------------------------------------


def _dc602(rel, findings, funcs, idx, env_of, traced, sync_ann) -> None:
    for f in funcs:
        if f.node in traced:
            continue
        env = env_of(f)
        for node in ast.walk(f.node):
            if not isinstance(node, ast.Call):
                continue
            enc = _enclosing(funcs, node.lineno)
            if enc is None or enc.node is not f.node:
                continue
            got = _materialization(node)
            if got is None:
                continue
            operand, form = got
            if operand is not None and not idx.expr_is_device(operand, env):
                continue
            if _sync_sanctioned(sync_ann, node.lineno):
                continue
            if operand is None:
                label = f"{_expr_label(node.func.value) or 'stream'}.synchronize"
            else:
                label = _expr_label(operand) or form
            findings.append(Finding(
                code="DC602", path=rel, line=node.lineno,
                symbol=f"{f.qualname}.{label}",
                message=(
                    f"host sync outside the budget: `{form}` waits for the "
                    f"device in wave-hot-path function `{f.qualname}` with no "
                    f"`# device: sync — <reason>` annotation — every blocking "
                    f"device→host round-trip on this path must be a "
                    f"declared, counted site"
                ),
            ))


# -- DC603: the build identity ------------------------------------------------


def _holder_name(name: str) -> bool:
    """A planner or segment-static object by its name: every field it
    has is a shape."""
    low = name.lstrip("_").lower()
    return "plan" in low or "static" in low


def _holder_annotation(ann: Optional[ast.expr]) -> bool:
    while isinstance(ann, ast.Subscript):
        ann = ann.value
    name = (ann.attr if isinstance(ann, ast.Attribute)
            else ann.id if isinstance(ann, ast.Name)
            else ann.value if isinstance(ann, ast.Constant) and isinstance(ann.value, str)
            else "")
    return name.endswith("Plan") or name.endswith("Static")


class _ShapeEnv:
    """Which names of one function hold shapes, and which hold planner or
    segment-static objects (whose fields are shapes).  Flow-insensitive,
    to a fixed point over the function's own assignments."""

    def __init__(self, fn):
        a = fn.args
        self.holders: set[str] = {
            x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if _holder_name(x.arg) or _holder_annotation(x.annotation)}
        self.shapes: set[str] = set()
        assigns = [s for s in _own_statements(fn)
                   if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign))
                   and s.value is not None]
        changed = True
        while changed:
            changed = False
            for s in assigns:
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                names = [n for t in targets for n in _assigned_names(t)]
                if self.is_holder(s.value):
                    new = set(names) - self.holders
                    self.holders |= new
                elif self.is_shape(s.value):
                    new = set(names) - self.shapes
                    self.shapes |= new
                else:
                    new = set()
                changed = changed or bool(new)

    def is_holder(self, expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.holders or _holder_name(expr.id)
        if isinstance(expr, ast.Attribute):
            return _holder_name(expr.attr) and _self_attr(expr) is not None
        if isinstance(expr, ast.Subscript):
            return self.is_holder(expr.value)
        if isinstance(expr, ast.BoolOp):
            return any(self.is_holder(v) for v in expr.values)
        if isinstance(expr, ast.Call):
            func = expr.func
            name = (func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else "")
            return "plan" in name.lower()
        return False

    def is_shape(self, expr) -> bool:
        if isinstance(expr, ast.Constant):
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.shapes or self.is_holder(expr)
        if isinstance(expr, ast.Attribute):
            if expr.attr in ("shape", "ndim"):
                return True
            if self.is_holder(expr.value):
                return True  # a planner field / a segment dimension
            return self.is_holder(expr) or self.is_shape(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.is_shape(expr.value) or self.is_shape(expr.slice)
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name) and func.id == "len":
                return True
            if isinstance(func, ast.Attribute) and func.attr in _SHAPE_METHODS:
                return True
            if self.is_holder(expr):
                return True
            return (any(self.is_shape(a) for a in expr.args)
                    or any(self.is_shape(kw.value) for kw in expr.keywords))
        if isinstance(expr, ast.JoinedStr):
            return any(isinstance(v, ast.FormattedValue) and self.is_shape(v.value)
                       for v in expr.values)
        if isinstance(expr, ast.FormattedValue):
            return self.is_shape(expr.value)
        if isinstance(expr, ast.Starred):
            return self.is_shape(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_shape(e) for e in expr.elts)
        if isinstance(expr, ast.BinOp):
            return self.is_shape(expr.left) or self.is_shape(expr.right)
        if isinstance(expr, ast.BoolOp):
            return any(self.is_shape(v) for v in expr.values)
        if isinstance(expr, ast.UnaryOp):
            return self.is_shape(expr.operand)
        if isinstance(expr, ast.IfExp):
            return self.is_shape(expr.body) or self.is_shape(expr.orelse)
        if isinstance(expr, ast.Compare):
            return self.is_shape(expr.left) or any(self.is_shape(c)
                                                   for c in expr.comparators)
        return False

    def label(self, expr) -> Optional[str]:
        """The shape-bearing value's name: the helper that made it
        (``_pad_to``), else its dotted path (``static.chunk``)."""
        if isinstance(expr, ast.JoinedStr):
            for v in expr.values:
                if isinstance(v, ast.FormattedValue) and self.is_shape(v.value):
                    return self.label(v.value)
            return None
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name) and func.id not in _LABEL_THROUGH:
                return func.id
            if isinstance(func, ast.Attribute) and func.attr in _SHAPE_METHODS:
                base = _expr_label(func.value)
                return f"{base}.{func.attr}" if base else func.attr
            for a in list(expr.args) + [kw.value for kw in expr.keywords]:
                if self.is_shape(a):
                    return self.label(a)
            return None
        if isinstance(expr, (ast.BinOp, ast.BoolOp, ast.UnaryOp, ast.IfExp,
                             ast.Tuple, ast.List, ast.Set, ast.Compare,
                             ast.Starred)):
            for sub in ast.iter_child_nodes(expr):
                if isinstance(sub, ast.expr) and self.is_shape(sub):
                    return self.label(sub)
            return None
        return _expr_label(expr)


def _build_modules(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(names bound to the build module, sink functions bound by name)."""
    mods, fns = {"_build"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            from_build = (node.module or "").split(".")[-1] == "_build"
            for alias in node.names:
                if alias.name == "_build":
                    mods.add(alias.asname or alias.name)
                elif from_build and alias.name in _BUILD_SINKS:
                    fns.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[-1] == "_build" and alias.asname:
                    mods.add(alias.asname)
    return mods, fns


def _flags_target(expr) -> bool:
    return ((isinstance(expr, ast.Name) and expr.id == "NVCC_FLAGS")
            or (isinstance(expr, ast.Attribute) and expr.attr == "NVCC_FLAGS"))


def _is_define(expr) -> bool:
    """A ``-D`` define: ``f"-DX={v}"`` or ``"-DX=" + v``."""
    if isinstance(expr, ast.JoinedStr):
        head = expr.values[0] if expr.values else None
        return (isinstance(head, ast.Constant) and isinstance(head.value, str)
                and head.value.startswith("-D"))
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = expr.left
        return ((isinstance(left, ast.Constant) and isinstance(left.value, str)
                 and left.value.startswith("-D")) or _is_define(left))
    return False


def _sink_values(fn, mods: set[str], fns: set[str], module_sinks: set[str]):
    """(expr, sink call or None) for every value ``fn`` hands to the build
    identity: a sink call's arguments, what it puts in ``NVCC_FLAGS``,
    and its ``-D`` defines."""
    for node in _own_statements(fn):
        if isinstance(node, ast.Call):
            func = node.func
            sink = ((isinstance(func, ast.Attribute) and func.attr in _BUILD_SINKS
                     and isinstance(func.value, ast.Name) and func.value.id in mods)
                    or (isinstance(func, ast.Name)
                        and (func.id in fns or func.id in module_sinks)))
            if sink:
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    yield a, node
            elif (isinstance(func, ast.Attribute) and _flags_target(func.value)
                  and func.attr in ("append", "extend", "insert")):
                for a in node.args:
                    yield a, None
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(_flags_target(t) for t in targets):
                yield node.value, None
        if isinstance(node, (ast.JoinedStr, ast.BinOp)) and _is_define(node):
            yield node, None


def _build_keyed(idx: _ModuleIndex, mods, fns, module_sinks) -> dict[str, set[int]]:
    """Module functions a parameter of which reaches the build identity:
    name -> the positions of those parameters (to a fixed point through
    calls of one such function by another)."""
    keyed: dict[str, set[int]] = {}
    changed = True
    while changed:
        changed = False
        for name, fn in idx.top_fns.items():
            params = [x.arg for x in fn.args.posonlyargs + fn.args.args]
            derived = _derived_from(fn, set(params))
            hits: set[int] = set()
            values = [v for v, _ in _sink_values(fn, mods, fns, module_sinks)]
            for node in _own_statements(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id in keyed and node.func.id != name):
                    for i in keyed[node.func.id]:
                        if i < len(node.args):
                            values.append(node.args[i])
            for v in values:
                used = {n.id for n in ast.walk(v) if isinstance(n, ast.Name)}
                for i, p in enumerate(params):
                    if derived.get(p, set()) & used:
                        hits.add(i)
            if hits - keyed.get(name, set()):
                keyed[name] = keyed.get(name, set()) | hits
                changed = True
    return keyed


def _derived_from(fn, params: set[str]) -> dict[str, set[str]]:
    """parameter -> the names holding a value derived from it."""
    out = {p: {p} for p in params}
    assigns = [s for s in _own_statements(fn)
               if isinstance(s, (ast.Assign, ast.AugAssign)) and s.value is not None]
    changed = True
    while changed:
        changed = False
        for s in assigns:
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            names = {n for t in targets for n in _assigned_names(t)}
            used = {n.id for n in ast.walk(s.value) if isinstance(n, ast.Name)}
            for p, ds in out.items():
                if ds & used and not names <= ds:
                    ds |= names
                    changed = True
    return out


def _dc603(rel, findings, funcs, idx, static_ann) -> set[int]:
    """Returns the annotation lines actually consumed (for DC605)."""
    used: set[int] = set()

    def consume(*lines: int) -> bool:
        hit = False
        for line in lines:
            for ln in (line, line - 1):
                if ln in static_ann:
                    used.add(ln)
                    hit = True
        return hit

    mods, fns = _build_modules(idx.tree)
    module_sinks = (set(idx.top_fns) & _BUILD_SINKS
                    if rel.rsplit("/", 1)[-1] == "_build.py" else set())
    keyed = _build_keyed(idx, mods, fns, module_sinks)
    for f in funcs:
        env = _ShapeEnv(f.node)
        for value, call in _sink_values(f.node, mods, fns, module_sinks):
            if not env.is_shape(value):
                continue
            if consume(value.lineno, call.lineno if call is not None else value.lineno):
                continue
            label = env.label(value) or "<shape>"
            findings.append(Finding(
                code="DC603", path=rel, line=value.lineno,
                symbol=f"{f.qualname}.{label}",
                message=(
                    f"shape-bearing value in the build identity: `{label}` "
                    f"reaches the kernel library's build (its name, its "
                    f"`NVCC_FLAGS` or a `-D` define) — one library must serve "
                    f"every shape, so pass it to the launch as an argument, "
                    f"or annotate the site `# device: static` with why it "
                    f"cannot vary"
                ),
            ))
        for node in _own_statements(f.node):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in keyed):
                continue
            name = node.func.id
            for i in sorted(keyed[name]):
                if i >= len(node.args) or not env.is_shape(node.args[i]):
                    continue
                arg = node.args[i]
                if consume(arg.lineno, node.lineno):
                    continue
                desc = env.label(arg) or f"arg{i}"
                findings.append(Finding(
                    code="DC603", path=rel, line=arg.lineno,
                    symbol=f"{f.qualname}.{name}.{desc}",
                    message=(
                        f"shape-bearing value in the build identity: argument "
                        f"`{desc}` of `{name}(...)` reaches the kernel "
                        f"library's build — every distinct value would build "
                        f"and load a library of its own; pass it to the launch "
                        f"instead, or annotate the call `# device: static`"
                    ),
                ))
    return used


def _dc604(rel, findings, funcs, idx) -> None:
    for f in funcs:
        if f.parent is not None:
            continue  # analyze each outermost function's whole subtree
        roots: set[str] = set()
        for g in funcs:
            if g is not f and not g.qualname.startswith(f.qualname + "."):
                continue
            for a in (g.node.args.args + g.node.args.kwonlyargs
                      + g.node.args.posonlyargs):
                if a.arg == "node_info_map":
                    roots.add(a.arg)
        # working copies: w = dict(root) / w = root
        changed = True
        while changed:
            changed = False
            for node in ast.walk(f.node):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                src = None
                if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                        and v.func.id == "dict" and len(v.args) == 1
                        and isinstance(v.args[0], ast.Name)):
                    src = v.args[0].id
                elif isinstance(v, ast.Name):
                    src = v.id
                if src in roots:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in roots:
                            roots.add(t.id)
                            changed = True
        if not roots:
            continue

        def from_root(expr) -> bool:
            """``root[k]`` / ``root.get(k)`` — a NodeInfo straight off the
            snapshot map."""
            if isinstance(expr, ast.Subscript):
                return (isinstance(expr.value, ast.Name)
                        and expr.value.id in roots)
            if (isinstance(expr, ast.Call)
                    and isinstance(expr.func, ast.Attribute)
                    and expr.func.attr == "get"
                    and isinstance(expr.func.value, ast.Name)):
                return expr.func.value.id in roots
            return False

        snapshot_names: set[str] = set()
        sanctioned_names: set[str] = set()
        for node in ast.walk(f.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    v = node.value
                    if from_root(v):
                        snapshot_names.add(t.id)
                    elif (isinstance(v, ast.Call)
                          and ((isinstance(v.func, ast.Name)
                                and v.func.id == "mutable_info")
                               or _callee_attr_name(v) == "mutable_info")):
                        sanctioned_names.add(t.id)
            elif isinstance(node, ast.For):
                # for name, info in root.items() / for info in root.values()
                it = node.iter
                if (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Attribute)
                        and isinstance(it.func.value, ast.Name)
                        and it.func.value.id in roots):
                    if (it.func.attr == "items"
                            and isinstance(node.target, ast.Tuple)
                            and len(node.target.elts) == 2
                            and isinstance(node.target.elts[1], ast.Name)):
                        snapshot_names.add(node.target.elts[1].id)
                    elif (it.func.attr == "values"
                          and isinstance(node.target, ast.Name)):
                        snapshot_names.add(node.target.id)
        # a name ever sanctioned wins (over-approximate toward silence)
        snapshot_only = snapshot_names - sanctioned_names

        for node in ast.walk(f.node):
            enc = _enclosing(funcs, getattr(node, "lineno", 0)) if hasattr(
                node, "lineno") else None
            qual = enc.qualname if enc is not None else f.qualname
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr in NODEINFO_MUTATORS:
                recv = node.func.value
                label = None
                if isinstance(recv, ast.Name) and recv.id in snapshot_only:
                    label = recv.id
                elif from_root(recv):
                    label = _expr_label(recv) or "<snapshot>"
                if label is not None:
                    findings.append(Finding(
                        code="DC604", path=rel, line=node.lineno,
                        symbol=f"{qual}.{label}.{node.func.attr}",
                        message=(
                            f"snapshot write bypasses clone-on-write: "
                            f"`.{node.func.attr}(...)` mutates a NodeInfo "
                            f"taken straight from the snapshot map — it "
                            f"corrupts the scheduler cache's CoW snapshot; "
                            f"obtain the target via `mutable_info(...)` "
                            f"so the first write clones"
                        ),
                    ))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in snapshot_only):
                        findings.append(Finding(
                            code="DC604", path=rel, line=node.lineno,
                            symbol=f"{qual}.{t.value.id}.{t.attr}",
                            message=(
                                f"snapshot write bypasses clone-on-write: "
                                f"attribute store `{t.value.id}.{t.attr} ="
                                f" ...` on a NodeInfo taken straight from "
                                f"the snapshot map — route the mutation "
                                f"through `mutable_info(...)`"
                            ),
                        ))


def _dc605(rel, findings, funcs, src_lines, sync_ann, static_ann,
           used_static) -> None:
    n = len(src_lines)
    for ln, reason in sorted(sync_ann.items()):
        enc = _enclosing(funcs, ln)
        qual = enc.qualname if enc is not None else "<module>"
        if reason is None:
            findings.append(Finding(
                code="DC605", path=rel, line=ln, symbol=f"{qual}.L{ln}",
                message=(
                    "sync annotation without a reason: `# device: sync` "
                    "must carry `— <why this round-trip is in the budget>` "
                    "— a reasonless sanction is a silent waiver"
                ),
            ))
            continue
        here = src_lines[ln - 1]
        below = src_lines[ln] if ln < n else ""
        if not (_SYNC_LEXEME_RE.search(here)
                or _SYNC_LEXEME_RE.search(below)):
            findings.append(Finding(
                code="DC605", path=rel, line=ln, symbol=f"{qual}.L{ln}",
                message=(
                    "stale sync annotation: neither this line nor the next "
                    "contains a host-materialization call — the sanctioned "
                    "site moved or was removed; delete or move the "
                    "annotation so the sync budget stays honest"
                ),
            ))
    for ln in sorted(static_ann - used_static):
        # a call on the annotated line or the next keeps it (lexical, as
        # for sync annotations): the shape taint may under-approximate
        here = src_lines[ln - 1].split("#", 1)[0]
        below = src_lines[ln].split("#", 1)[0] if ln < n else ""
        if _CALL_LEXEME_RE.search(here) or _CALL_LEXEME_RE.search(below):
            continue
        enc = _enclosing(funcs, ln)
        qual = enc.qualname if enc is not None else "<module>"
        findings.append(Finding(
            code="DC605", path=rel, line=ln, symbol=f"{qual}.L{ln}",
            message=(
                "stale static annotation: `# device: static` sanctions no "
                "pad/width/compile-key site on this line or the next — "
                "delete or move it"
            ),
        ))


def run(
    root: str,
    paths: Optional[list[str]] = None,
    hot_modules: Optional[list[str]] = None,
) -> list[Finding]:
    """``hot_modules`` (default: tracecov's HOT_PATH_MODULES) bounds the
    DC602 sync-budget rule; it is intersected with the scanned set, so
    hot entries outside this pass's scope (store/, client/, …) are
    simply not DC602-checked here — tracecov's own fail-loud covers
    typos in the shared list."""
    files = iter_py_files(root, paths or DEFAULT_PATHS)
    hot = set(hot_modules if hot_modules is not None else HOT_PATH_MODULES)
    findings: list[Finding] = []
    for abs_path, rel in files:
        try:
            with open(abs_path, "r", encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                code="DC600", path=rel, line=e.lineno or 1,
                symbol="<parse>",
                message=f"file does not parse: {e.msg}"))
            continue
        findings.extend(
            _analyze_file(rel, tree, src.splitlines(), hot))
    return findings


def sanctioned_sync_sites(
    root: str,
    paths: Optional[list[str]] = None,
) -> dict[str, dict[str, int]]:
    """Per-file, per-function count of VALID ``# device: sync`` sites —
    the static sync budget.  Lexical (annotation + materialization
    lexeme on the annotated or following line), matching DC605's
    validity rule, so the count equals what the pass sanctions.  The
    runtime cross-check holds ``FrontierRun.stats['host_syncs']`` to
    this bound."""
    out: dict[str, dict[str, int]] = {}
    for abs_path, rel in iter_py_files(root, paths or DEFAULT_PATHS):
        try:
            with open(abs_path, "r", encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src)
        except SyntaxError:
            continue
        lines = src.splitlines()
        funcs = _collect_funcs(tree)
        sync_ann, _static = _scan_annotations(lines)
        per_fn: dict[str, int] = {}
        for ln, reason in sync_ann.items():
            if reason is None:
                continue
            here = lines[ln - 1]
            below = lines[ln] if ln < len(lines) else ""
            site = ln if _SYNC_LEXEME_RE.search(here) else (
                ln + 1 if _SYNC_LEXEME_RE.search(below) else None)
            if site is None:
                continue
            enc = _enclosing(funcs, site)
            qual = enc.qualname if enc is not None else "<module>"
            per_fn[qual] = per_fn.get(qual, 0) + 1
        if per_fn:
            out[rel] = per_fn
    return out
