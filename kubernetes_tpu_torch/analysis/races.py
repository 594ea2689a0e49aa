"""Pass 3 — controller/kubelet race lint (RL3xx).

The controller runtime's production shape is threaded (``run_workers``,
``controllers/base.py:110``): informer handlers enqueue on the event
thread, N workers pop keys and run ``sync``.  The reference survives this
because every mutable map it touches is lock-guarded; a Python port loses
that discipline one convenience attribute at a time.  This pass walks the
``threading.Thread`` target call graph and reports:

- RL301: an instance attribute *assigned* (``self.x = …`` / ``self.x += …``)
  inside a worker-thread-reachable method without holding one of the
  object's own locks.  Lock attributes are those assigned
  ``threading.Lock()/RLock()/Condition()`` anywhere in the class (MRO
  included); a write is "held" when lexically inside ``with self.<lock>:``.
- RL302: a lock-acquisition-order cycle — method A acquires lock1 then
  (directly or via one self-call) lock2, while method B acquires them in
  the opposite order.
- RL303: a *plain-container* instance attribute (one assigned a
  dict/list/set/deque literal or constructor in this class) mutated from
  a worker-reachable method without a lock — subscript writes/deletes,
  mutator method calls (``.append``/``.pop``/``.update``/…), and
  ``heapq.heappush/heappop`` on the attribute.  Restricting to
  known-plain containers is what keeps internally-locked objects
  (``WorkQueue``, informer stores) from false-positiving.

Resolution is name-based MRO over the scanned packages: thread entry
points found in a base class (``Controller._worker_loop``) make the
*subclass* ``sync`` overrides worker-reachable, which is exactly where
convenience writes accumulate.  Informer-handler callbacks
(``Handler(on_add=self.m)``, ``watch(kind, key_fn=self.m)``) count as
thread entries too — they fire on the informer's ``_run_loop`` thread in
the production shape; lambdas in those slots are unwrapped
(``on_update=lambda old, new: self._move(old, new)`` marks ``_move``).
HTTP handler ``do_*`` methods are deliberately NOT entry points — there
is no special-case code, they simply match none of the entry heuristics
— because the stdlib server builds a NEW handler instance per
connection, so ``self`` is thread-confined and per-request attribute
writes are not races.  (A handler class that ALSO spawns a thread over
shared state is analyzed through that thread entry like any other
class.)  Lock-order cycles are checked for every class that defines
locks, entries or not.

The points-to-lite layer tracks how shared
containers travel before they are mutated:

- **local aliases**: a local name assigned exactly ONCE in
  the method, from a plain ``self.<container>`` read, is treated as that
  container; chains (``q = p; q[k] = v``) resolve by fixed point.  A
  name reassigned anywhere in the method or shadowing a parameter breaks
  the chain at that link and everything downstream is dropped:
  flow-insensitive alias tracking must over-approximate toward SILENCE,
  never invent findings on a rebound local.
- **aliases through calls and returns**: per-function return
  summaries — "returns ``self.<attr>``" / "returns argument ``p``" /
  "returns ``self``" — are computed for every method in the class table
  and every module-level function in the class's file, iterated to fixed
  point through the call graph, so ``q = self._get_pending()`` and
  ``q = self._identity(p)`` (and chains of such calls) resolve to the
  container.  A function whose return statements disagree, or return
  anything else (a copy, a literal), has no summary and its callers stay
  silent.
- **cross-object lock identity**: lock names are attribute
  *paths*.  ``self.queue = WorkQueue()`` plus ``WorkQueue.__init__``
  assigning ``self._cond = Condition()`` makes ``queue._cond`` a lock
  token of this class, so ``with self.queue._cond:`` guards writes
  exactly like an own lock, and RL302 cycles are tracked across the two
  objects' locks.  Attribute types resolve only through direct
  constructor calls (``self.x = ClassName(...)``) — a lock path on an
  attribute of unknown type is NOT a guard (status quo), and cannot
  silence anything it could not already.
- **caller-held locks**: a helper method reachable ONLY
  through call sites that hold a lock (``def _slot(self): …`` called
  from three ``with self._mu:`` blocks — the PodOwnerIndex shape) is
  analyzed with that lock held at entry.  The held-at-entry set is the
  INTERSECTION over every worker-reachable call edge, iterated to fixed
  point, so one unlocked call site strips the guarantee.
- **nested-def captures**: closures and lambdas no longer
  terminate the walk — a nested def that mutates ``self.<container>`` or
  a captured alias reports at the enclosing worker-reachable method
  (where the thread entry is), tagged with the closure's name.  Locks
  held at the def site count as held (the closure may run later without
  them, but flagging would invent findings on every callback built under
  a lock — over-approximate toward silence); names the closure rebinds
  or takes as parameters shadow the enclosing aliases.
- **one-hop container extraction**: ``x = self._items[k]``
  (or ``x = p[k]`` through a container alias) makes ``x`` an *element*
  alias — mutator calls, subscript writes/deletes, and heap functions on
  it report RL303 against the container attribute.  One hop only:
  ``x = self._items[k][j]`` and aliases flowing through tuples/lists
  (``pair = (p,); pair[0][k] = v``) remain out of scope (documented in
  ROADMAP).
- **cross-object reachability**: a worker-reachable method
  calling ``self.<attr>.<m>(...)`` — or a *bound-method alias*
  (``self.metrics = self.metrics_client.utilization`` then
  ``self.metrics(p)``) — on an attribute typed by a constructor call
  makes ``<m>`` an external thread entry of the collaborator class: its
  unguarded writes are analyzed exactly as if it spawned the thread
  itself.  This is the dual of cross-object lock identity, and the shape
  that found the MetricsClient race (no threads of its own; every mutation
  reached from HPA controller workers).  One hop only: externally-entered
  classes do not propagate entries onward to THEIR collaborators
  (documented in ROADMAP).
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, iter_py_files

DEFAULT_PATHS = [
    "kubernetes_tpu_torch/controllers",
    "kubernetes_tpu_torch/kubelet",
    "kubernetes_tpu_torch/client",
    "kubernetes_tpu_torch/scheduler",
    "kubernetes_tpu_torch/apiserver",
    "kubernetes_tpu_torch/auth",
    "kubernetes_tpu_torch/dns",
    "kubernetes_tpu_torch/proxy",
    "kubernetes_tpu_torch/store",
    # scope extension: the federation/cloud/
    # admission layers, the CLI, and the daemon supervisor run informer
    # callbacks and timer loops too — triaged clean on extension (these
    # trees are almost thread-free; daemon.py's single Thread only
    # supervises subprocesses it owns)
    "kubernetes_tpu_torch/federation",
    "kubernetes_tpu_torch/cloud",
    "kubernetes_tpu_torch/admission",
    "kubernetes_tpu_torch/cli",
    "kubernetes_tpu_torch/daemon.py",
    # the port's cluster lifecycle runner sits beside the daemon
    # supervisor and starts the same kind of threads
    "kubernetes_tpu_torch/cluster.py",
    # the fault framework itself: armed/disarmed from test threads while
    # hit() runs on any thread — keep it under the race lint
    "kubernetes_tpu_torch/faults",
]

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
CONTAINER_FACTORIES = {
    "dict",
    "list",
    "set",
    "deque",
    "defaultdict",
    "OrderedDict",
    "Counter",
}
MUTATOR_METHODS = {
    "append",
    "appendleft",
    "extend",
    "add",
    "remove",
    "discard",
    "pop",
    "popleft",
    "popitem",
    "update",
    "setdefault",
    "clear",
    "insert",
}
HEAP_FUNCS = {"heappush", "heappop", "heappushpop", "heapreplace", "heapify"}


class ClassInfo:
    def __init__(self, name: str, node: ast.ClassDef, path: str):
        self.name = name
        self.node = node
        self.path = path
        self.bases = [_base_name(b) for b in node.bases]
        self.methods: dict[str, ast.FunctionDef] = {
            item.name: item
            for item in node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }


def _base_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


def _is_self_attr(expr: ast.expr) -> Optional[str]:
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


def _self_attr_path(expr: ast.expr) -> Optional[str]:
    """``self.a`` -> "a"; ``self.a._cond`` -> "a._cond" (any depth)."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if parts and isinstance(expr, ast.Name) and expr.id == "self":
        return ".".join(reversed(parts))
    return None


def _callee_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


class _ClassIndex:
    def __init__(self, files: list[tuple[str, str]]):
        self.classes: dict[str, ClassInfo] = {}
        self.module_funcs: dict[str, dict[str, ast.FunctionDef]] = {}
        self.parse_errors: list[Finding] = []
        for abs_path, rel in files:
            with open(abs_path, "r", encoding="utf-8") as f:
                src = f.read()
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError as e:
                self.parse_errors.append(
                    Finding("RL300", rel, e.lineno or 1, "syntax", f"unparseable file: {e.msg}")
                )
                continue
            # top-level functions, for return-summary resolution of
            # `q = f(p)` calls (aliases through module-level helpers)
            self.module_funcs[rel] = {
                node.name: node
                for node in tree.body
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    # same-named classes across modules: last wins is wrong;
                    # key by (module, name) and by bare name for base lookup
                    info = ClassInfo(node.name, node, rel)
                    self.classes.setdefault(node.name, info)
                    self.classes[f"{rel}::{node.name}"] = info

    def mro(self, info: ClassInfo) -> list[ClassInfo]:
        """Name-based linearization (left-to-right DFS, dedup)."""
        out: list[ClassInfo] = []
        seen: set[int] = set()

        def visit(ci: ClassInfo) -> None:
            if id(ci) in seen:
                return
            seen.add(id(ci))
            out.append(ci)
            for b in ci.bases:
                base = self.classes.get(b)
                if base is not None:
                    visit(base)

        visit(info)
        return out


def _method_table(index: _ClassIndex, info: ClassInfo) -> dict[str, tuple[ClassInfo, ast.FunctionDef]]:
    table: dict[str, tuple[ClassInfo, ast.FunctionDef]] = {}
    for ci in reversed(index.mro(info)):
        for name, fn in ci.methods.items():
            table[name] = (ci, fn)
    return table


def _lock_attrs(index: _ClassIndex, info: ClassInfo) -> set[str]:
    locks: set[str] = set()
    for ci in index.mro(info):
        for fn in ci.methods.values():
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    factory = _callee_name(node.value.func)
                    if factory in LOCK_FACTORIES:
                        for t in node.targets:
                            attr = _is_self_attr(t)
                            if attr:
                                locks.add(attr)
    return locks


def _attr_types(index: _ClassIndex, info: ClassInfo) -> dict[str, ClassInfo]:
    """``self.x = ClassName(...)`` anywhere in the class (MRO) resolves
    the attribute's type when ``ClassName`` is a scanned class — the
    cross-object half of lock-path identity.  The dependency-injection
    default ``self.x = injected or ClassName(...)`` types from the
    constructor operand (the production shape; an injected substitute is
    a test concern).  Attributes assigned from parameters or other call
    results stay untyped (no guess, no silence)."""
    out: dict[str, ClassInfo] = {}
    for ci in index.mro(info):
        for fn in ci.methods.values():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                values = [node.value]
                if isinstance(node.value, ast.BoolOp) and isinstance(
                        node.value.op, ast.Or):
                    values = list(node.value.values)
                target_cls = None
                for value in values:
                    if isinstance(value, ast.Call):
                        target_cls = index.classes.get(
                            _callee_name(value.func))
                        if target_cls is not None:
                            break
                if target_cls is None:
                    continue
                for t in node.targets:
                    attr = _is_self_attr(t)
                    if attr:
                        out.setdefault(attr, target_cls)
    return out


def _lock_tokens(index: _ClassIndex, info: ClassInfo) -> set[str]:
    """Every lock identity this class can hold via ``with self.<path>:`` —
    its own lock attributes plus one-hop cross-object paths
    (``queue._cond`` when ``self.queue`` resolves to a class whose
    ``_cond`` is a lock)."""
    tokens = set(_lock_attrs(index, info))
    for attr, cls in _attr_types(index, info).items():
        for lock in _lock_attrs(index, cls):
            tokens.add(f"{attr}.{lock}")
    return tokens


def _with_lock_token(item_ctx: ast.expr, tokens: set[str]) -> Optional[str]:
    """The lock token a ``with`` item acquires, or None."""
    path = _self_attr_path(item_ctx)
    if path is None and isinstance(item_ctx, ast.Call):
        path = _self_attr_path(item_ctx.func)  # with self._mu: vs self._cond:
    if path is not None and path in tokens:
        return path
    return None


def _container_attrs(index: _ClassIndex, info: ClassInfo) -> set[str]:
    """Attributes assigned a plain dict/list/set/deque (literal or
    constructor) anywhere in the class — the objects with no interior
    locking of their own."""
    out: set[str] = set()
    for ci in index.mro(info):
        for fn in ci.methods.values():
            for node in ast.walk(fn):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                value = node.value
                if value is None:
                    continue
                is_container = isinstance(
                    value, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)
                )
                if not is_container and isinstance(value, ast.Call):
                    is_container = _callee_name(value.func) in CONTAINER_FACTORIES
                if not is_container:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    attr = _is_self_attr(t)
                    if attr:
                        out.add(attr)
    return out


def _thread_entries(index: _ClassIndex, info: ClassInfo) -> list[str]:
    """Method names of ``info`` (via its table) that run on worker threads
    against a SHARED instance (HTTP handler ``do_*`` methods are excluded:
    one instance per connection means no cross-thread instance state)."""
    entries: set[str] = set()
    table = _method_table(index, info)
    for _ci, fn in table.values():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = _callee_name(node.func)
            if cname not in ("Thread", "Timer"):
                continue
            for kw in node.keywords:
                if kw.arg == "target":
                    attr = _is_self_attr(kw.value)
                    if attr and attr in table:
                        entries.add(attr)
            # Timer(interval, self.m)
            if cname == "Timer" and len(node.args) >= 2:
                attr = _is_self_attr(node.args[1])
                if attr and attr in table:
                    entries.add(attr)
    # informer-handler convention: callbacks registered via
    # Handler(on_add=self.m, …) or watch(kind, key_fn=self.m) run on the
    # informer's _run_loop thread in the production shape
    for _ci, fn in table.values():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg in ("on_add", "on_update", "on_delete", "key_fn"):
                    attr = _is_self_attr(kw.value)
                    if attr and attr in table:
                        entries.add(attr)
                    elif isinstance(kw.value, ast.Lambda):
                        # on_update=lambda old, new: self._move(old, new)
                        for n in ast.walk(kw.value.body):
                            attr = _is_self_attr(n) if isinstance(n, ast.Attribute) else None
                            if attr and attr in table:
                                entries.add(attr)
    return sorted(entries)


def _reachable(table: dict, entries: list[str]) -> set[str]:
    seen: set[str] = set()
    stack = list(entries)
    while stack:
        m = stack.pop()
        if m in seen or m not in table:
            continue
        seen.add(m)
        _ci, fn = table[m]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                attr = _is_self_attr(node.func)
                if attr and attr in table and attr not in seen:
                    stack.append(attr)
    return seen


class _HeldCallScanner(ast.NodeVisitor):
    """Per-method scan shared by the lock-order pass and caller-held-lock
    propagation: records top-level lock acquisitions, (held → acquired)
    edges, and every self-call with the lock set lexically held at the
    call site.  Nested defs are skipped here — a closure's calls run at
    an unknown time, so they can neither prove a caller-held lock nor
    order an acquisition."""

    def __init__(self, tokens: set[str]):
        self._tokens = tokens
        self.held: list[str] = []
        self.top_acquires: list[tuple[str, int]] = []
        self.edges: list[tuple[str, str, int]] = []  # (held, acquired, line)
        self.calls: list[tuple[str, frozenset, int]] = []  # (callee, held, line)

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            tok = _with_lock_token(item.context_expr, self._tokens)
            if tok is not None:
                acquired.append(tok)
                if not self.held:
                    self.top_acquires.append((tok, node.lineno))
                for h in self.held:
                    if h != tok:
                        self.edges.append((h, tok, node.lineno))
        self.held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    def visit_Call(self, node: ast.Call) -> None:
        attr = _is_self_attr(node.func)
        if attr:
            self.calls.append((attr, frozenset(self.held), node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _scan_methods(table: dict, tokens: set[str]) -> dict[str, _HeldCallScanner]:
    scans: dict[str, _HeldCallScanner] = {}
    for meth, (_ci, fn) in table.items():
        sc = _HeldCallScanner(tokens)
        for stmt in fn.body:
            sc.visit(stmt)
        scans[meth] = sc
    return scans


def _entry_held(
    scans: dict[str, _HeldCallScanner],
    entries: list[str],
    reachable: set[str],
) -> dict[str, frozenset]:
    """Locks provably held at ENTRY of each worker-reachable method: the
    intersection over every worker-reachable call edge, to fixed point
    (the PodOwnerIndex shape — a private helper whose every caller is
    inside ``with self._mu:``).  Thread entries run bare by definition;
    a method reachable through even one unlocked edge loses the guard."""
    UNKNOWN = None  # lattice top: no edge seen yet
    state: dict[str, Optional[frozenset]] = {m: UNKNOWN for m in reachable}
    for e in entries:
        state[e] = frozenset()
    changed = True
    while changed:
        changed = False
        for m in sorted(reachable):
            held_in = state.get(m)
            if held_in is None or m not in scans:
                continue
            for callee, held, _line in scans[m].calls:
                if callee not in reachable or callee in entries:
                    continue
                eff = held_in | held
                cur = state.get(callee)
                new = eff if cur is None else frozenset(cur & eff)
                if new != cur:
                    state[callee] = new
                    changed = True
    return {m: (s if s is not None else frozenset()) for m, s in state.items()}


# -- return summaries (aliases through calls/returns) -----------------------


def _own_returns(fn: ast.FunctionDef) -> list[ast.Return]:
    """Return statements of ``fn`` itself (nested defs excluded — their
    returns are not this function's)."""
    out: list[ast.Return] = []

    class V(ast.NodeVisitor):
        def visit_Return(self, node: ast.Return) -> None:
            out.append(node)

        def visit_FunctionDef(self, node) -> None:
            return

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    for stmt in fn.body:
        V().visit(stmt)
    return out


def _param_names(fn: ast.FunctionDef) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _call_arg_for_param(call: ast.Call, fn: ast.FunctionDef,
                        pname: str, *, is_method: bool) -> Optional[ast.expr]:
    """The argument expression a call binds to parameter ``pname`` of
    ``fn`` (positional or keyword; starred/ambiguous forms resolve to
    None — silence)."""
    if any(isinstance(a, ast.Starred) for a in call.args):
        return None
    params = _param_names(fn)
    if is_method and params and params[0] == "self":
        params = params[1:]
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    try:
        i = params.index(pname)
    except ValueError:
        return None
    if i < len(call.args):
        return call.args[i]
    return None


def _return_summaries(
    table: dict, module_funcs: dict[str, ast.FunctionDef]
) -> dict[tuple, tuple]:
    """Fixed-point per-function return summaries over the class's method
    table plus its module's top-level functions.  Values:
    ``("attr", name)`` — every return is ``self.<name>`` (possibly
    through further summarized calls); ``("arg", pname)`` — every return
    is the same parameter; ``("self",)`` — returns self;
    ``("tuple", (elem, ...))`` — every return is a same-arity tuple
    LITERAL, each element summarized positionally (an element whose
    returns disagree or resolve to nothing is ``None`` — that position
    simply aliases nothing).  A function whose returns disagree or
    return anything else has no summary."""
    fns: dict[tuple, tuple[ast.FunctionDef, bool]] = {}
    for meth, (_ci, fn) in table.items():
        fns[("m", meth)] = (fn, True)
    for name, fn in module_funcs.items():
        fns[("f", name)] = (fn, False)
    summaries: dict[tuple, Optional[tuple]] = {k: None for k in fns}

    def resolve(expr: ast.expr, params: set[str], depth: int) -> Optional[tuple]:
        if depth > 8:
            return None
        attr = _is_self_attr(expr)
        if attr is not None:
            return ("attr", attr)
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return ("self",)
            if expr.id in params:
                return ("arg", expr.id)
            return None
        if isinstance(expr, ast.Call):
            callee_key = None
            meth = _is_self_attr(expr.func)
            if meth is not None and ("m", meth) in fns:
                callee_key = ("m", meth)
            elif (isinstance(expr.func, ast.Name)
                    and ("f", expr.func.id) in fns):
                callee_key = ("f", expr.func.id)
            if callee_key is None:
                return None
            summary = summaries[callee_key]
            if summary is None:
                return None
            if summary[0] in ("attr", "self"):
                return summary
            if summary[0] == "arg":
                callee_fn, is_method = fns[callee_key]
                arg = _call_arg_for_param(expr, callee_fn, summary[1],
                                          is_method=is_method)
                if arg is None:
                    return None
                return resolve(arg, params, depth + 1)
        return None

    # summaries only move bottom→value as callee summaries fill in, so
    # recomputation is monotone and terminates
    changed = True
    while changed:
        changed = False
        for key, (fn, is_method) in fns.items():
            if summaries[key] is not None:
                continue
            returns = _own_returns(fn)
            if not returns or any(r.value is None for r in returns):
                continue
            params = set(_param_names(fn))
            if is_method:
                params.discard("self")
            # tuple-literal returns summarize positionally:
            # `return self._q, self._mu` feeds `a, b = self._pair()`
            if all(isinstance(r.value, ast.Tuple) for r in returns):
                arities = {len(r.value.elts) for r in returns}
                has_star = any(isinstance(el, ast.Starred)
                               for r in returns for el in r.value.elts)
                if len(arities) == 1 and not has_star:
                    elems = []
                    for i in range(arities.pop()):
                        vals = {resolve(r.value.elts[i], params, 0)
                                for r in returns}
                        elems.append(vals.pop() if len(vals) == 1 else None)
                    if any(e is not None for e in elems):
                        summaries[key] = ("tuple", tuple(elems))
                        changed = True
                continue
            resolved = {resolve(r.value, params, 0) for r in returns}
            if len(resolved) == 1:
                val = resolved.pop()
                if val is not None:
                    summaries[key] = val
                    changed = True
    return {k: v for k, v in summaries.items() if v is not None}


def _subscript_self_attr(target: ast.expr) -> Optional[str]:
    """`self.x[k]` (possibly nested subscripts) -> "x"."""
    while isinstance(target, ast.Subscript):
        target = target.value
    return _is_self_attr(target)


def _subscript_name(target: ast.expr) -> Optional[str]:
    """`p[k]` (possibly nested subscripts) -> "p"."""
    while isinstance(target, ast.Subscript):
        target = target.value
    if isinstance(target, ast.Name):
        return target.id
    return None


def _local_aliases(
    fn: ast.FunctionDef,
    containers: set[str],
    summaries: Optional[dict[tuple, tuple]] = None,
    fns: Optional[dict] = None,
) -> tuple[dict[str, str], dict[str, str]]:
    """(container aliases, element aliases): local name -> container
    attribute, for names assigned exactly once in ``fn`` (nested defs
    excluded, mirroring _WriteVisitor's scope).  A container alias's one
    assignment is a plain ``self.<container>`` read, a chain of such
    names (``p = self._pending; q = p``) resolved by fixed point, or
    a call whose return summary resolves to the
    container (``q = self._get_pending()``, ``q = self._identity(p)``,
    ``q = ident(p)`` for a module-level helper).  Tuple unpacking with
    matching arity and no starred target (``a, b = self._x, self._y``)
    aliases pairwise — each (target, value) pair is handled exactly as
    its standalone assignment would be.  An element alias is a
    ONE-HOP extraction ``x = self._items[k]`` (directly or through a
    container alias).  Any other binding of ANY name in a chain — a
    second assignment, a for/with target, a parameter — breaks the chain
    at that link and every name past it is dropped (flow-insensitive
    tracking must never flag a rebound local)."""
    summaries = summaries or {}
    fns = fns or {}
    counts: dict[str, int] = {}
    cand: dict[str, str] = {}
    links: dict[str, str] = {}  # q -> p for single-candidate `q = p`
    # q -> (container-name-or-attr, via) for one-hop subscript reads;
    # resolved after the container aliases are known
    elem_reads: dict[str, ast.expr] = {}
    params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs
                              + fn.args.posonlyargs)}
    if fn.args.vararg is not None:
        params.add(fn.args.vararg.arg)
    if fn.args.kwarg is not None:
        params.add(fn.args.kwarg.arg)

    def bind(name: str) -> None:
        counts[name] = counts.get(name, 0) + 1

    def bind_target(t: ast.expr) -> None:
        # only NAME bindings count: a subscript/attribute store
        # (``p[k] = v``) mutates the referent, it does not rebind ``p``
        if isinstance(t, ast.Name):
            bind(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                bind_target(el)
        elif isinstance(t, ast.Starred):
            bind_target(t.value)

    def resolve_call(value: ast.Call, depth: int = 0) -> Optional[tuple]:
        """What a call returns, through the summaries: ("attr", a) or
        ("name", local) — the latter feeds the chain links."""
        if depth > 8:
            return None
        callee_key = None
        meth = _is_self_attr(value.func)
        if meth is not None and ("m", meth) in fns:
            callee_key = ("m", meth)
        elif isinstance(value.func, ast.Name) and ("f", value.func.id) in fns:
            callee_key = ("f", value.func.id)
        if callee_key is None:
            return None
        summary = summaries.get(callee_key)
        if summary is None or summary[0] == "self":
            return None
        if summary[0] == "attr":
            return summary
        # ("arg", pname): the alias IS whatever was passed
        callee_fn, is_method = fns[callee_key]
        arg = _call_arg_for_param(value, callee_fn, summary[1],
                                  is_method=is_method)
        if arg is None:
            return None
        attr = _is_self_attr(arg)
        if attr is not None:
            return ("attr", attr)
        if isinstance(arg, ast.Name):
            return ("name", arg.id)
        if isinstance(arg, ast.Call):
            return resolve_call(arg, depth + 1)
        return None

    def resolve_call_tuple(value: ast.Call) -> Optional[list]:
        """Per-position aliases for a call with a ``("tuple", ...)``
        summary: each element becomes ("attr", a) / ("name", local) /
        None (that position aliases nothing)."""
        callee_key = None
        meth = _is_self_attr(value.func)
        if meth is not None and ("m", meth) in fns:
            callee_key = ("m", meth)
        elif isinstance(value.func, ast.Name) and ("f", value.func.id) in fns:
            callee_key = ("f", value.func.id)
        if callee_key is None:
            return None
        summary = summaries.get(callee_key)
        if summary is None or summary[0] != "tuple":
            return None
        callee_fn, is_method = fns[callee_key]
        out: list = []
        for elem in summary[1]:
            if elem is None or elem[0] == "self":
                out.append(None)
            elif elem[0] == "attr":
                out.append(elem)
            else:  # ("arg", pname): the alias IS whatever was passed
                arg = _call_arg_for_param(value, callee_fn, elem[1],
                                          is_method=is_method)
                attr = _is_self_attr(arg) if arg is not None else None
                if attr is not None:
                    out.append(("attr", attr))
                elif isinstance(arg, ast.Name):
                    out.append(("name", arg.id))
                else:
                    out.append(None)
        return out

    def handle_pair(t: ast.expr, value: ast.expr) -> None:
        if isinstance(t, ast.Name):
            attr = _is_self_attr(value)
            if attr is not None and attr in containers:
                cand[t.id] = attr
            elif isinstance(value, ast.Name):
                # `q = p`: a name-to-name link — resolved to a
                # container only if the whole chain survives the
                # single-assignment filter below
                links[t.id] = value.id
            elif isinstance(value, ast.Call):
                got = resolve_call(value)
                if got is not None:
                    if got[0] == "attr" and got[1] in containers:
                        cand[t.id] = got[1]
                    elif got[0] == "name":
                        links[t.id] = got[1]
            elif (isinstance(value, ast.Subscript)
                    and not isinstance(value.value, ast.Subscript)):
                # one-hop element extraction: x = self._items[k]
                # or x = p[k]; resolved below once container
                # aliases are known
                elem_reads[t.id] = value.value
        elif isinstance(t, (ast.Tuple, ast.List)):
            starred = [i for i, el in enumerate(t.elts)
                       if isinstance(el, ast.Starred)]
            if (isinstance(value, (ast.Tuple, ast.List))
                    and not any(isinstance(el, ast.Starred)
                                for el in value.elts)):
                if not starred and len(value.elts) == len(t.elts):
                    # matching arity, no stars: each (target, value) pair
                    # aliases exactly as the standalone assignment would
                    for sub_t, sub_v in zip(t.elts, value.elts):
                        handle_pair(sub_t, sub_v)
                elif len(starred) == 1 and len(value.elts) >= len(t.elts) - 1:
                    # one starred TARGET against a literal value:
                    # positions before the star align with the value
                    # prefix, positions after with the value suffix; the
                    # starred name binds a FRESH list and aliases nothing
                    s = starred[0]
                    n_suffix = len(t.elts) - s - 1
                    for sub_t, sub_v in zip(t.elts[:s], value.elts[:s]):
                        handle_pair(sub_t, sub_v)
                    if n_suffix:
                        for sub_t, sub_v in zip(
                                t.elts[s + 1:],
                                value.elts[len(value.elts) - n_suffix:]):
                            handle_pair(sub_t, sub_v)
            elif isinstance(value, ast.Call) and not starred:
                # call-returned tuple unpacking: a callee
                # whose every return is a same-arity tuple literal
                # aliases positionally; arity mismatch, starred targets,
                # or an unsummarized callee stay unmodeled (silence)
                got = resolve_call_tuple(value)
                if got is not None and len(got) == len(t.elts):
                    for sub_t, elem in zip(t.elts, got):
                        if elem is None or not isinstance(sub_t, ast.Name):
                            continue
                        if elem[0] == "attr" and elem[1] in containers:
                            cand[sub_t.id] = elem[1]
                        elif elem[0] == "name":
                            links[sub_t.id] = elem[1]
            # any other unpacking shape stays unmodeled (silence)

    class V(ast.NodeVisitor):
        def visit_Assign(self, node: ast.Assign) -> None:
            for t in node.targets:
                bind_target(t)
                handle_pair(t, node.value)
            self.generic_visit(node)

        def visit_AugAssign(self, node: ast.AugAssign) -> None:
            bind_target(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
            if node.value is not None:
                bind_target(node.target)
            self.generic_visit(node)

        def visit_NamedExpr(self, node) -> None:
            bind_target(node.target)
            self.generic_visit(node)

        def visit_For(self, node: ast.For) -> None:
            bind_target(node.target)
            self.generic_visit(node)

        def visit_With(self, node: ast.With) -> None:
            for item in node.items:
                if item.optional_vars is not None:
                    bind_target(item.optional_vars)
            self.generic_visit(node)

        def visit_FunctionDef(self, node) -> None:
            return  # nested defs execute elsewhere (same as _WriteVisitor)

        visit_AsyncFunctionDef = visit_FunctionDef

    v = V()
    for stmt in fn.body:
        v.visit(stmt)

    def valid(name: str) -> bool:
        return counts.get(name) == 1 and name not in params

    resolved = {name: attr for name, attr in cand.items() if valid(name)}
    # fixed point over the name→name links: `q = p` resolves to p's
    # container only when BOTH names are single-assignment non-params —
    # a rebound or shadowed link anywhere in the chain drops everything
    # downstream of it (over-approximate toward silence)
    chain_links = {q: p for q, p in links.items()
                   if valid(q) and q not in resolved}
    changed = True
    while changed:
        changed = False
        for q, p in chain_links.items():
            if q not in resolved and p in resolved:
                resolved[q] = resolved[p]
                changed = True
    elems: dict[str, str] = {}
    for name, base in elem_reads.items():
        if not valid(name) or name in resolved:
            continue
        attr = _is_self_attr(base)
        if attr is None and isinstance(base, ast.Name):
            attr = resolved.get(base.id)
        if attr is not None and attr in containers:
            elems[name] = attr
    return resolved, elems


class _WriteVisitor(ast.NodeVisitor):
    """Find self-attribute writes/mutations and the lock context they run
    under.  ``writes`` are rebinding assignments (RL301); ``mutations``
    are container-interior writes (RL303).  Nested defs/lambdas are
    walked too: their writes report at the enclosing method
    (tagged with the closure name), def-site locks count as held, and
    names they rebind or take as parameters shadow the enclosing
    aliases."""

    def __init__(self, locks: set[str], containers: set[str],
                 aliases: Optional[dict[str, str]] = None,
                 elem_aliases: Optional[dict[str, str]] = None):
        self.locks = locks
        self.containers = containers
        # single-assignment local aliases of container attributes
        # (``p = self._pending``): mutations through them count against
        # the aliased attribute (see _local_aliases)
        self.aliases = aliases or {}
        # one-hop element extractions (``x = self._items[k]``)
        self.elem_aliases = elem_aliases or {}
        self.held: list[str] = []
        self.nested: list[str] = []  # enclosing closure names, if any
        # (attr, line, held, context) / (attr, line, held, what)
        self.writes: list[tuple[str, int, frozenset, str]] = []
        self.mutations: list[tuple[str, int, frozenset, str]] = []

    def _ctx(self) -> str:
        if self.nested:
            return f" in nested def `{self.nested[-1]}`"
        return ""

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            tok = _with_lock_token(item.context_expr, self.locks)
            if tok is not None:
                acquired.append(tok)
        self.held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    def _record(self, target: ast.expr, line: int) -> None:
        attr = _is_self_attr(target)
        if attr is not None:
            self.writes.append((attr, line, frozenset(self.held), self._ctx()))
            return
        attr = _subscript_self_attr(target)
        if attr is not None and attr in self.containers:
            self.mutations.append((attr, line, frozenset(self.held),
                                   f"subscript write{self._ctx()}"))
            return
        if isinstance(target, ast.Subscript):
            name = _subscript_name(target)
            if name is not None and name in self.aliases:
                self.mutations.append((
                    self.aliases[name], line, frozenset(self.held),
                    f"subscript write via alias `{name}`{self._ctx()}"))
            elif name is not None and name in self.elem_aliases:
                self.mutations.append((
                    self.elem_aliases[name], line, frozenset(self.held),
                    f"subscript write via element `{name}` of "
                    f"self.{self.elem_aliases[name]}{self._ctx()}"))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            attr = _subscript_self_attr(t)
            if attr is not None and attr in self.containers:
                self.mutations.append((attr, node.lineno, frozenset(self.held),
                                       f"del{self._ctx()}"))
                continue
            if isinstance(t, ast.Subscript):
                name = _subscript_name(t)
                if name is not None and name in self.aliases:
                    self.mutations.append((
                        self.aliases[name], node.lineno, frozenset(self.held),
                        f"del via alias `{name}`{self._ctx()}"))
                elif name is not None and name in self.elem_aliases:
                    self.mutations.append((
                        self.elem_aliases[name], node.lineno,
                        frozenset(self.held),
                        f"del via element `{name}` of "
                        f"self.{self.elem_aliases[name]}{self._ctx()}"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
            attr = _is_self_attr(fn.value)
            if attr is not None and attr in self.containers:
                self.mutations.append(
                    (attr, node.lineno, frozenset(self.held),
                     f".{fn.attr}(){self._ctx()}")
                )
            elif (isinstance(fn.value, ast.Name)
                    and fn.value.id in self.aliases):
                self.mutations.append((
                    self.aliases[fn.value.id], node.lineno,
                    frozenset(self.held),
                    f".{fn.attr}() via alias `{fn.value.id}`{self._ctx()}"))
            elif (isinstance(fn.value, ast.Name)
                    and fn.value.id in self.elem_aliases):
                self.mutations.append((
                    self.elem_aliases[fn.value.id], node.lineno,
                    frozenset(self.held),
                    f".{fn.attr}() via element `{fn.value.id}` of "
                    f"self.{self.elem_aliases[fn.value.id]}{self._ctx()}"))
        else:
            hname = _callee_name(fn)
            if hname in HEAP_FUNCS and node.args:
                arg0 = node.args[0]
                attr = _is_self_attr(arg0)
                if attr is not None and attr in self.containers:
                    self.mutations.append(
                        (attr, node.lineno, frozenset(self.held),
                         f"{hname}(){self._ctx()}")
                    )
                elif (isinstance(arg0, ast.Name)
                        and arg0.id in self.aliases):
                    self.mutations.append((
                        self.aliases[arg0.id], node.lineno,
                        frozenset(self.held),
                        f"{hname}() via alias `{arg0.id}`{self._ctx()}"))
                elif (isinstance(arg0, ast.Name)
                        and arg0.id in self.elem_aliases):
                    self.mutations.append((
                        self.elem_aliases[arg0.id], node.lineno,
                        frozenset(self.held),
                        f"{hname}() via element `{arg0.id}` of "
                        f"self.{self.elem_aliases[arg0.id]}{self._ctx()}"))
        self.generic_visit(node)

    # nested defs (callbacks) mutate the SAME captured object — walk them,
    # reporting at the enclosing method, with the closure's own bindings
    # shadowing the enclosing aliases
    def _visit_nested(self, node, name: str, params: set[str],
                      body) -> None:
        shadowed = params | _bound_names(node)
        saved = (self.aliases, self.elem_aliases)
        self.aliases = {k: v for k, v in self.aliases.items()
                        if k not in shadowed}
        self.elem_aliases = {k: v for k, v in self.elem_aliases.items()
                             if k not in shadowed}
        self.nested.append(name)
        try:
            if isinstance(body, list):
                for stmt in body:
                    self.visit(stmt)
            else:
                self.visit(body)
        finally:
            self.nested.pop()
            self.aliases, self.elem_aliases = saved

    def visit_FunctionDef(self, node) -> None:
        params = {a.arg for a in (node.args.args + node.args.kwonlyargs
                                  + node.args.posonlyargs)}
        if node.args.vararg is not None:
            params.add(node.args.vararg.arg)
        if node.args.kwarg is not None:
            params.add(node.args.kwarg.arg)
        self._visit_nested(node, node.name, params, node.body)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        params = {a.arg for a in (node.args.args + node.args.kwonlyargs
                                  + node.args.posonlyargs)}
        self._visit_nested(node, "<lambda>", params, node.body)


def _bound_names(fn) -> set[str]:
    """Every name a nested def (re)binds anywhere inside — used to shadow
    enclosing aliases conservatively (a rebound capture is not provably
    the container any more)."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _lock_order_edges(
    table: dict, scans: dict[str, _HeldCallScanner]
) -> dict[tuple[str, str], tuple[str, str, int]]:
    """(lockA, lockB) -> (class, method, line) where A is held when B is
    acquired, expanding one level of self-calls.  Lock identities are
    TOKENS (own attrs or cross-object paths), so an inversion between
    ``self._mu`` and ``self.queue._cond`` is a cycle too."""
    method_acquires: dict[str, list[str]] = {}
    edges: dict[tuple[str, str], tuple[str, str, int]] = {}
    for meth, sc in scans.items():
        ci, _fn = table[meth]
        for tok, _line in sc.top_acquires:
            method_acquires.setdefault(meth, []).append(tok)
        for h, a, line in sc.edges:
            edges.setdefault((h, a), (ci.name, meth, line))
    # one level of call expansion: caller holds H, callee acquires A at top
    for meth, sc in scans.items():
        ci, _fn = table[meth]
        for callee, held, line in sc.calls:
            if not held:
                continue
            for a in method_acquires.get(callee, ()):
                for h in held:
                    if h != a:
                        edges.setdefault(
                            (h, a), (ci.name, f"{meth}->{callee}", line))
    return edges


def _find_cycles(edges: dict) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: list[list[str]] = []
    seen_cycles: set[frozenset] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(path + [start])
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return cycles


def _bound_method_aliases(
    table: dict, attr_types: dict[str, ClassInfo]
) -> dict[str, tuple[ClassInfo, str]]:
    """``self.f = self.<attr>.<m>`` where ``attr`` is attr-typed: ``f`` is
    a bound-method alias — a later ``self.f(...)`` call IS a call of the
    collaborator's ``m`` (the HPA shape:
    ``self.metrics = self.metrics_client.utilization``)."""
    out: dict[str, tuple[ClassInfo, str]] = {}
    for _meth, (_ci, fn) in table.items():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            path = _self_attr_path(node.value)
            if path is None or path.count(".") != 1:
                continue
            base, m = path.split(".")
            cls = attr_types.get(base)
            if cls is None:
                continue
            for t in node.targets:
                f = _is_self_attr(t)
                if f:
                    out.setdefault(f, (cls, m))
    return out


def _cross_object_entries(
    index: _ClassIndex, class_infos: list[ClassInfo]
) -> dict[int, dict[str, str]]:
    """One-hop cross-object reachability: for every class with its OWN
    thread entries, any worker-reachable call ``self.<attr>.<m>(...)`` —
    or a call through a bound-method alias of such a path — on an
    attr-typed collaborator marks ``m`` as an external thread entry of
    the collaborator class.  Returns ``id(collaborator ClassInfo) ->
    {method: "Caller.method"}`` (the via-label for messages).  One hop
    only: externally-entered classes do not themselves propagate."""
    out: dict[int, dict[str, str]] = {}
    method_tables: dict[int, dict] = {}
    for info in class_infos:
        entries = _thread_entries(index, info)
        if not entries:
            continue
        attr_types = _attr_types(index, info)
        if not attr_types:
            continue
        table = _method_table(index, info)
        bound = _bound_method_aliases(table, attr_types)
        for meth in sorted(_reachable(table, entries)):
            if meth == "__init__":
                continue
            _ci, fn = table[meth]
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                target: Optional[tuple[ClassInfo, str]] = None
                path = _self_attr_path(node.func)
                if path is not None and path.count(".") == 1:
                    base, m = path.split(".")
                    cls = attr_types.get(base)
                    if cls is not None:
                        target = (cls, m)
                else:
                    f = _is_self_attr(node.func)
                    if f is not None and f in bound:
                        target = bound[f]
                if target is None:
                    continue
                cls, m = target
                tbl = method_tables.get(id(cls))
                if tbl is None:
                    tbl = method_tables[id(cls)] = _method_table(index, cls)
                if m not in tbl or m == "__init__":
                    continue
                out.setdefault(id(cls), {}).setdefault(
                    m, f"{info.name}.{meth}")
    return out


def run(root: str, paths: Optional[list[str]] = None) -> list[Finding]:
    files = iter_py_files(root, paths or DEFAULT_PATHS)
    index = _ClassIndex(files)
    findings: list[Finding] = list(index.parse_errors)
    reported: set[str] = set()

    class_infos = [
        info for key, info in sorted(index.classes.items()) if "::" in key
    ]
    ext_entries = _cross_object_entries(index, class_infos)
    for info in class_infos:
        table = _method_table(index, info)
        entries = _thread_entries(index, info)
        locks = _lock_attrs(index, info)
        tokens = _lock_tokens(index, info)
        ext = ext_entries.get(id(info), {})
        all_entries = sorted(set(entries) | set(ext))
        if not all_entries:
            if tokens:
                scans = _scan_methods(table, tokens)
                _report_lock_cycles(info, table, scans, findings, reported)
            continue
        # messages show where an external entry comes FROM: utilization
        # reached from HorizontalPodAutoscalerController.sync reads
        # `utilization<-HorizontalPodAutoscalerController.sync`
        entry_desc = "/".join(
            entries
            + [f"{m}<-{via}" for m, via in sorted(ext.items())
               if m not in entries]
        )
        containers = _container_attrs(index, info)
        reachable = _reachable(table, all_entries)
        scans = _scan_methods(table, tokens)
        entry_held = _entry_held(scans, all_entries, reachable)
        summaries = _return_summaries(
            table, index.module_funcs.get(info.path, {}))
        fns: dict[tuple, tuple] = {}
        for meth, (_ci, fn) in table.items():
            fns[("m", meth)] = (fn, True)
        for name, fn in index.module_funcs.get(info.path, {}).items():
            fns[("f", name)] = (fn, False)
        for meth in sorted(reachable):
            ci, fn = table[meth]
            if meth == "__init__":
                continue  # runs on the constructing (main) thread
            aliases, elem_aliases = _local_aliases(
                fn, containers, summaries=summaries, fns=fns)
            visitor = _WriteVisitor(tokens, containers, aliases=aliases,
                                    elem_aliases=elem_aliases)
            for stmt in fn.body:
                visitor.visit(stmt)
            at_entry = entry_held.get(meth, frozenset())
            for attr, line, held, ctx in visitor.writes:
                if attr in locks or held or at_entry:
                    continue
                # report at the DEFINING class so subclasses don't duplicate
                symbol = f"{ci.name}.{meth}.{attr}"
                key = f"RL301:{ci.path}:{symbol}"
                if key in reported:
                    continue
                reported.add(key)
                findings.append(
                    Finding(
                        code="RL301",
                        path=ci.path,
                        line=line,
                        symbol=symbol,
                        message=(
                            f"`self.{attr}` assigned{ctx} in worker-thread-"
                            f"reachable method `{meth}` (entry: "
                            f"{entry_desc}) without holding any of "
                            f"the object's locks "
                            f"({', '.join(sorted(tokens)) or 'none defined'})"
                        ),
                    )
                )
            for attr, line, held, what in visitor.mutations:
                if held or at_entry:
                    continue
                symbol = f"{ci.name}.{meth}.{attr}"
                key = f"RL303:{ci.path}:{symbol}"
                if key in reported:
                    continue
                reported.add(key)
                findings.append(
                    Finding(
                        code="RL303",
                        path=ci.path,
                        line=line,
                        symbol=symbol,
                        message=(
                            f"container `self.{attr}` mutated ({what}) in "
                            f"worker-thread-reachable method `{meth}` (entry: "
                            f"{entry_desc}) without holding any of the "
                            f"object's locks "
                            f"({', '.join(sorted(tokens)) or 'none defined'})"
                        ),
                    )
                )
        # lock-order cycles (per concrete class; report at defining site)
        _report_lock_cycles(info, table, scans, findings, reported)
    return findings


def _report_lock_cycles(
    info: ClassInfo,
    table: dict,
    scans: dict[str, _HeldCallScanner],
    findings: list[Finding],
    reported: set[str],
) -> None:
    edges = _lock_order_edges(table, scans)
    for cycle in _find_cycles(edges):
        a, b = cycle[0], cycle[1]
        cls, meth, line = edges[(a, b)]
        symbol = f"{cls}.lockcycle.{'-'.join(cycle[:-1])}"
        key = f"RL302:{info.path}:{symbol}"
        if key in reported:
            continue
        reported.add(key)
        findings.append(
            Finding(
                code="RL302",
                path=info.path,
                line=line,
                symbol=symbol,
                message=(
                    f"lock-acquisition-order cycle {' -> '.join(cycle)} "
                    f"(first edge in {cls}.{meth}): two threads taking these "
                    f"locks in opposite orders deadlock"
                ),
            )
        )
