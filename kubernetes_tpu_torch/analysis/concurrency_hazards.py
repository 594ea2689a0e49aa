"""Pass 7 — concurrency-hazard & resource-lifecycle lint (CH7xx).

The runtime-robustness contracts keep the daemons alive at overload:
classified exception handling instead of silent swallows,
``_never_crash``-style observer isolation, bounded queues with counted
drops, resources closed in ``finally``, and no blocking work under a
lock that a wave or fan-out thread contends.  So that they are commit
gates and not review conventions, this pass turns each one into a rule
over the race-lint scope plus the ctypes shim and ``utils/`` (the
telemetry/tracing daemon plumbing):

- **CH701** — a known-blocking call lexically under a held lock token,
  or in a method the caller-held-lock fixed point proves always runs
  with a lock held: socket/HTTP work (``urlopen``/``getresponse``/
  ``recv``/``accept``/``connect``/``sendall``), ``sleep``, thread
  ``join``, subprocess spawn/wait, ``fsync`` (the WAL durability
  point), event/future ``wait`` (a ``Condition`` in the class's lock
  tokens releases the lock — exempt), and device materialization per
  DC602's taint shapes (``.item()``/``.tolist()``/``device_get``/
  ``block_until_ready``).  Deliberate designs carry
  ``# blocking-ok — <reason>`` on the call's line or the line above;
  a reasonless annotation sanctions nothing.
- **CH702** — a swallowed exception: a bare ``except:`` /
  ``except Exception:`` / ``except BaseException:`` handler whose body
  neither re-raises, classifies, logs, nor counts — concretely, a body
  made ONLY of ``pass``/``continue``/``break``/valueless ``return``/
  constant expressions.  Any call (a logger, a counter ``.inc()``), any
  augmented assignment (``stats[...] += 1``), any state-recording
  assignment, or any ``raise`` is handling — over-approximate toward
  silence.  Handlers naming a narrower exception type are
  classification by construction and stay silent.
- **CH703** — resource lifecycle: a non-daemon ``Thread`` started with
  no reachable ``join`` (function-local threads join in the same
  function; ``self.<attr>`` threads join anywhere in the class),
  an ``open``/``urlopen``/``socket``/``create_connection`` result
  bound to a local that is never closed and never escapes (no
  ``with``, no ``.close()``, not returned/yielded/stored/passed on —
  any escape transfers ownership and silences), and a manually entered
  context manager (``x.__enter__()`` — the armed-``FaultPlan`` shape)
  with no matching ``.__exit__`` (function-wide for locals, class-wide
  for attributes).
- **CH704** — third-party callback invoked under a held lock: calling
  a handler/observer/callback-named loop variable or parameter (or one
  of its bound methods, including passing ``h.on_add`` into a
  dispatcher call) while a lock token is held.  Handler fan-out must
  follow the informer ``_deliver`` contract: snapshot the handler list
  under the lock, call outside it — foreign code under your lock can
  deadlock you or stall every peer.  Snapshotting itself
  (``list(self._handlers)``) and registration (``.append(handler)``)
  pass a container or a bare object, not a bound method, and stay
  silent.
- **CH705** — unbounded growth on daemon paths (classes with thread
  entries): a ``queue.Queue()`` constructed with no ``maxsize`` (or
  ``maxsize=0``) on an instance attribute, or a plain container
  attribute that worker-reachable code grows (``append``/``add``/
  ``setdefault``/variable-key subscript store/``heappush``) while NO
  method in the class ever shrinks or resets it.  Constant-string
  subscript stores (``stats["relists"] += 1``) are a fixed vocabulary,
  not growth.  Deliberate designs carry ``# bounded: <reason>`` on the
  construction or growth line (or the line above).

Deliberately NOT modeled, over-approximating toward silence: blocking
calls and callback invocations inside nested defs (they run at an
unknown time, possibly without the lock); threads stored in containers
(``self._threads.append(Thread(...))``); close-on-all-paths flow
analysis (CH703 is lexical: any ``.close()``/escape silences); growth
through aliases or collaborator objects; ``queue.get``/``put`` as
blocking shapes (indistinguishable from dict access by name).

The class machinery — MRO method tables, thread entries, attr-typed
collaborator lock tokens, and the caller-held-lock fixed point — is
the races pass's, imported rather than re-derived, so the two passes
can never disagree about what "under a lock" means.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .core import Finding, iter_py_files
from .races import (
    DEFAULT_PATHS as _RACES_PATHS,
    _ClassIndex,
    _callee_name,
    _container_attrs,
    _entry_held,
    _is_self_attr,
    _method_table,
    _reachable,
    _scan_methods,
    _self_attr_path,
    _thread_entries,
    _lock_tokens,
    _with_lock_token,
)

DEFAULT_PATHS = _RACES_PATHS + [
    # the ctypes shim: finalizer close paths (the first CH702 triage hit)
    "kubernetes_tpu_torch/native.py",
    # telemetry/timeseries/tracing/health: the daemon plumbing this
    # pass exists to keep honest (bounded queues, shipper threads)
    "kubernetes_tpu_torch/utils",
]

_BLOCKING_OK_RE = re.compile(r"#\s*blocking-ok\s*(?:—|–|-{1,2})?\s*(.*)$")
_BOUNDED_RE = re.compile(r"#\s*bounded:\s*(.*)$")

#: bare-name calls that block (``from time import sleep``-style imports,
#: module-level helpers)
_BLOCKING_NAME_CALLS = {
    "sleep", "urlopen", "fsync", "check_output", "check_call", "Popen",
    "create_connection", "device_get",
}
#: attribute calls that block regardless of receiver (``time.sleep``,
#: ``self._sleep``, ``sock.recv`` …)
_BLOCKING_ATTR_CALLS = {
    "sleep", "urlopen", "getresponse", "fsync", "create_connection",
    "check_output", "check_call", "Popen", "communicate", "sendall",
    "recv", "accept", "connect", "device_get", "block_until_ready",
}
_CALLBACKISH = re.compile(
    r"(handler|observer|callback|listener|subscriber|hook)", re.I)
_OPEN_FACTORIES = {"open", "urlopen", "socket", "create_connection"}


def _annotated(ann: dict[int, Optional[str]], line: int) -> bool:
    """Sanctioned by a REASONED annotation on its own line or the line
    above (the ``# device: sync`` grammar, same placement rule)."""
    return bool(ann.get(line) or ann.get(line - 1))


def _scan_annotations(src: str) -> tuple[dict[int, Optional[str]], dict[int, Optional[str]]]:
    """(blocking-ok line -> reason-or-None, bounded line -> reason-or-None)."""
    blocking: dict[int, Optional[str]] = {}
    bounded: dict[int, Optional[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _BLOCKING_OK_RE.search(line)
        if m:
            blocking[i] = (m.group(1) or "").strip() or None
        m = _BOUNDED_RE.search(line)
        if m:
            bounded[i] = (m.group(1) or "").strip() or None
    return blocking, bounded


def _call_label(func: ast.expr) -> str:
    try:
        return ast.unparse(func)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return _callee_name(func) or "<call>"


def _blocking_call(call: ast.Call, tokens: set[str]) -> Optional[str]:
    """A human label when ``call`` is a known-blocking shape, else None."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in _BLOCKING_NAME_CALLS:
            return func.id
        return None
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    if attr in _BLOCKING_ATTR_CALLS:
        return _call_label(func)
    if attr == "run" and isinstance(func.value, ast.Name) and func.value.id == "subprocess":
        return "subprocess.run"
    if attr == "join":
        # Thread.join() takes no args or a numeric timeout; str.join takes
        # exactly one iterable — an ambiguous single non-numeric arg stays
        # silent (over-approximate toward silence)
        if not call.args and not call.keywords:
            return _call_label(func)
        if any(kw.arg == "timeout" for kw in call.keywords):
            return _call_label(func)
        if (len(call.args) == 1 and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, (int, float))):
            return _call_label(func)
        return None
    if attr == "wait":
        # Condition.wait RELEASES the held lock — a receiver in the
        # class's lock tokens is the sanctioned sleep-under-lock shape.
        # An Event/Future/process wait on a self attribute does not.
        path = _self_attr_path(func.value)
        if path is not None and path not in tokens:
            return _call_label(func)
        return None
    if attr in ("item", "tolist") and not call.args and not call.keywords:
        # DC602's device-materialization shapes: a blocking device→host
        # round-trip is blocking work like any other
        return _call_label(func)
    return None


# -- CH701 / CH704: lock-context walk per method ----------------------------


class _LockSiteVisitor(ast.NodeVisitor):
    """Record blocking calls and callback invocations with the lock
    tokens lexically held at each site.  Nested defs are skipped — a
    closure runs at an unknown time, possibly without the lock."""

    def __init__(self, tokens: set[str], cb_aliases: dict[str, str],
                 cb_params: set[str]):
        self._tokens = tokens
        self._cb_aliases = cb_aliases  # local name -> callbackish attr
        self._cb_params = cb_params
        self._cb_loop_vars: dict[str, str] = {}  # loop var -> via-label
        self.held: list[str] = []
        self.blocking: list[tuple[str, int, frozenset]] = []
        self.callbacks: list[tuple[str, str, int, frozenset]] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            tok = _with_lock_token(item.context_expr, self._tokens)
            if tok is not None:
                acquired.append(tok)
        self.held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    def _callback_source(self, expr: ast.expr) -> Optional[str]:
        """The via-label when ``expr`` names a third-party callable: a
        loop var over a callbackish container, a callbackish local
        alias, or a callbackish parameter."""
        if not isinstance(expr, ast.Name):
            return None
        if expr.id in self._cb_loop_vars:
            return self._cb_loop_vars[expr.id]
        if expr.id in self._cb_params:
            return f"parameter `{expr.id}`"
        return None

    def visit_For(self, node: ast.For) -> None:
        bound = None
        it = node.iter
        # unwrap one snapshot wrapper: for h in list(self._handlers)
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("list", "tuple", "sorted", "reversed")
                and it.args):
            it = it.args[0]
        attr = _is_self_attr(it)
        if attr is None and isinstance(it, ast.Name):
            attr = self._cb_aliases.get(it.id)
        if attr is not None and _CALLBACKISH.search(attr):
            if isinstance(node.target, ast.Name):
                bound = node.target.id
                self._cb_loop_vars[bound] = f"self.{attr}"
        self.generic_visit(node)
        if bound is not None:
            self._cb_loop_vars.pop(bound, None)

    def visit_Call(self, node: ast.Call) -> None:
        # record sites even when lexically bare: the caller-held fixed
        # point may prove this whole method runs under a lock (held0);
        # the reporter drops sites whose effective held set is empty
        label = _blocking_call(node, self._tokens)
        if label is not None:
            self.blocking.append((label, node.lineno, frozenset(self.held)))
        via = self._callback_source(node.func)
        if via is not None:
            self.callbacks.append(
                (_call_label(node.func), via, node.lineno,
                 frozenset(self.held)))
        elif isinstance(node.func, ast.Attribute):
            via = self._callback_source(node.func.value)
            if via is not None:
                self.callbacks.append(
                    (_call_label(node.func), via, node.lineno,
                     frozenset(self.held)))
        # passing a BOUND METHOD of a callback source into a call
        # hands foreign code to a dispatcher that will run it here,
        # under the lock (`self._deliver(handler.on_add, obj)`);
        # passing the bare object (registration) stays silent
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Attribute):
                via = self._callback_source(arg.value)
                if via is not None:
                    self.callbacks.append(
                        (_call_label(arg), via, node.lineno,
                         frozenset(self.held)))
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _cb_local_aliases(fn: ast.FunctionDef) -> dict[str, str]:
    """Local names assigned (once is not required — any binding from a
    callbackish container makes later iteration suspect… but a REBOUND
    name is no longer provably the container, so require exactly one
    binding, mirroring the races alias rule)."""
    counts: dict[str, int] = {}
    cand: dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    counts[t.id] = counts.get(t.id, 0) + 1
                    value = node.value
                    if (isinstance(value, ast.Call)
                            and isinstance(value.func, ast.Name)
                            and value.func.id in ("list", "tuple", "sorted")
                            and value.args):
                        value = value.args[0]
                    attr = _is_self_attr(value)
                    if attr is not None and _CALLBACKISH.search(attr):
                        cand.setdefault(t.id, attr)
    return {n: a for n, a in cand.items() if counts.get(n) == 1}


# -- CH702: swallowed exceptions --------------------------------------------


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Attribute):
        names = [t.attr]
    elif isinstance(t, ast.Tuple):
        for el in t.elts:
            if isinstance(el, ast.Name):
                names.append(el.id)
            elif isinstance(el, ast.Attribute):
                names.append(el.attr)
    return any(n in ("Exception", "BaseException") for n in names)


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the body does NOTHING with the exception: only pass/
    continue/break/valueless return/constant expressions.  Any call,
    raise, assignment, or control structure counts as handling
    (over-approximate toward silence)."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return):
            v = stmt.value
            if v is None or (isinstance(v, ast.Constant) and v.value is None):
                continue
            return False
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


# -- CH703: resource lifecycle ----------------------------------------------


def _thread_ctor(value: ast.expr) -> Optional[ast.Call]:
    if isinstance(value, ast.Call) and _callee_name(value.func) == "Thread":
        return value
    return None


def _is_daemon_ctor(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return bool(isinstance(kw.value, ast.Constant) and kw.value.value)
    return False


def _name_used_as(fn: ast.FunctionDef, name: str) -> dict[str, bool]:
    """How a local resource name is consumed in ``fn``: closed, entered
    as a with-context, or escaping (returned / yielded / stored onto an
    attribute or subscript / passed as a call argument)."""
    out = {"closed": False, "with": False, "escapes": False}
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Name) and ctx.id == name:
                    out["with"] = True
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "close"
                    and isinstance(f.value, ast.Name) and f.value.id == name):
                out["closed"] = True
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Starred):
                    arg = arg.value
                # a name inside a tuple/list argument still escapes —
                # `Thread(target=pump, args=(client, upstream))` hands the
                # socket to the pump threads, which own its close
                elts = (arg.elts if isinstance(arg, (ast.Tuple, ast.List))
                        else [arg])
                if any(isinstance(el, ast.Name) and el.id == name
                       for el in elts):
                    out["escapes"] = True
        elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            v = node.value
            if isinstance(v, ast.Name) and v.id == name:
                out["escapes"] = True
            elif isinstance(v, (ast.Tuple, ast.List)):
                if any(isinstance(el, ast.Name) and el.id == name
                       for el in v.elts):
                    out["escapes"] = True
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    v = node.value
                    if isinstance(v, ast.Name) and v.id == name:
                        out["escapes"] = True
    return out


class _FuncScope:
    __slots__ = ("node", "qualname")

    def __init__(self, node, qualname: str):
        self.node = node
        self.qualname = qualname


def _collect_funcs(tree: ast.Module) -> list[_FuncScope]:
    out: list[_FuncScope] = []

    def walk(node, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append(_FuncScope(child, q))
                walk(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def _enclosing_qualname(tree: ast.Module, funcs: list[_FuncScope],
                        lineno: int) -> str:
    best = "<module>"
    best_span = None
    for f in funcs:
        end = getattr(f.node, "end_lineno", f.node.lineno)
        if f.node.lineno <= lineno <= end:
            span = end - f.node.lineno
            if best_span is None or span <= best_span:
                best, best_span = f.qualname, span
    return best


# -- the pass ---------------------------------------------------------------


def run(root: str, paths: Optional[list[str]] = None) -> list[Finding]:
    files = iter_py_files(root, paths or DEFAULT_PATHS)
    index = _ClassIndex(files)
    findings: list[Finding] = []
    reported: set[str] = set()

    def add(code: str, path: str, line: int, symbol: str, message: str) -> None:
        key = f"{code}:{path}:{symbol}"
        if key in reported:
            return
        reported.add(key)
        findings.append(Finding(code, path, line, symbol, message))

    for f in index.parse_errors:
        add("CH700", f.path, f.line, f.symbol, f.message)

    trees: dict[str, ast.Module] = {}
    blocking_ann: dict[str, dict[int, Optional[str]]] = {}
    bounded_ann: dict[str, dict[int, Optional[str]]] = {}
    for abs_path, rel in files:
        with open(abs_path, "r", encoding="utf-8") as fh:
            src = fh.read()
        try:
            trees[rel] = ast.parse(src, filename=rel)
        except SyntaxError:
            continue  # already a CH700 via the index
        blocking_ann[rel], bounded_ann[rel] = _scan_annotations(src)

    # ---- per-file rules: CH702 swallows, CH703 local lifecycles ----------
    for rel in sorted(trees):
        tree = trees[rel]
        funcs = _collect_funcs(tree)
        swallow_ord: dict[str, int] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad_handler(node) and _swallows(node)):
                continue
            q = _enclosing_qualname(tree, funcs, node.lineno)
            n = swallow_ord[q] = swallow_ord.get(q, 0) + 1
            label = ("except:" if node.type is None
                     else f"except {_call_label(node.type)}:")
            add("CH702", rel, node.lineno, f"{q}.swallow{n}",
                f"`{label}` swallows the exception silently — the body "
                f"neither re-raises, classifies, logs, nor increments a "
                f"counter.  An invisible failure is unfixable in "
                f"production; at minimum count it (`….inc()` / "
                f"`stats[…] += 1`) and log at debug")
        for fs in funcs:
            _scan_function_lifecycle(fs, rel, add)

    # ---- per-class rules: CH701, CH703 attr-threads/CMs, CH704, CH705 ----
    class_infos = [
        info for key, info in sorted(index.classes.items()) if "::" in key
    ]
    for info in class_infos:
        table = _method_table(index, info)
        tokens = _lock_tokens(index, info)
        entries = _thread_entries(index, info)
        b_ann = blocking_ann.get(info.path, {})
        q_ann = bounded_ann.get(info.path, {})
        if tokens:
            _scan_lock_hazards(info, table, tokens, entries, b_ann, add)
        _scan_attr_lifecycle(info, table, add)
        if entries:
            _scan_unbounded(index, info, table, entries, q_ann, add)
    return findings


def _scan_lock_hazards(info, table, tokens, entries, b_ann, add) -> None:
    """CH701 + CH704 over every method of a lock-owning class.  'Under a
    lock' is lexical OR proven by the caller-held fixed point — roots
    (which hold nothing at entry) are the thread entries plus every
    public/dunder method; a private helper whose every caller holds the
    lock inherits the held set."""
    scans = _scan_methods(table, tokens)
    roots = sorted(set(entries)
                   | {m for m in table if not m.startswith("_")}
                   | {m for m in table
                      if m.startswith("__") and m.endswith("__")})
    at_entry = _entry_held(scans, roots, set(table))
    for meth in sorted(table):
        ci, fn = table[meth]
        cb_aliases = _cb_local_aliases(fn)
        cb_params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs
                                     + fn.args.posonlyargs)
                     if _CALLBACKISH.search(a.arg)}
        v = _LockSiteVisitor(tokens, cb_aliases, cb_params)
        held0 = at_entry.get(meth, frozenset())
        for stmt in fn.body:
            v.visit(stmt)
        for label, line, held in v.blocking:
            eff = held | held0
            if not eff:
                continue
            ann = b_ann if ci.path == info.path else {}
            if _annotated(ann, line):
                continue
            add("CH701", ci.path, line, f"{ci.name}.{meth}.{label}",
                f"blocking call `{label}(…)` under held lock "
                f"{'/'.join(sorted(eff))} — every thread contending this "
                f"lock stalls behind the I/O.  Move it outside the lock, "
                f"or annotate the line `# blocking-ok — <reason>` if the "
                f"blocking IS the contract (e.g. WAL fsync at the commit "
                f"point)")
        for label, via, line, held in v.callbacks:
            eff = held | held0
            if not eff:
                continue
            ann = b_ann if ci.path == info.path else {}
            if _annotated(ann, line):
                continue
            add("CH704", ci.path, line, f"{ci.name}.{meth}.{label}",
                f"third-party callback `{label}` (from {via}) invoked "
                f"under held lock {'/'.join(sorted(eff))} — foreign code "
                f"under your lock can deadlock you or stall every peer.  "
                f"Follow the informer `_deliver` contract: snapshot the "
                f"handler list under the lock, call outside it")
    # blocking/callback sites in methods the fixed point proves are
    # ALWAYS under a lock are reported above via held0; a lexically-bare
    # method reachable both ways stays silent (intersection semantics)


def _scan_function_lifecycle(fs: _FuncScope, rel: str, add) -> None:
    """CH703 over one function: local threads, local open-without-close,
    local manual ``__enter__``.  Nested defs have their own _FuncScope
    and report there."""
    fn = fs.node
    own: list[ast.stmt] = list(fn.body)

    def own_nodes():
        class V(ast.NodeVisitor):
            def __init__(self):
                self.nodes = []

            def generic_visit(self, node):
                self.nodes.append(node)
                super().generic_visit(node)

            def visit_FunctionDef(self, node):
                return

            visit_AsyncFunctionDef = visit_FunctionDef
            visit_Lambda = visit_FunctionDef

        v = V()
        for stmt in own:
            v.visit(stmt)
        return v.nodes

    nodes = own_nodes()
    # local threads: t = Thread(...); t.start() with no t.join()
    threads: dict[str, tuple[ast.Call, int]] = {}
    daemonized: set[str] = set()
    started: set[str] = set()
    joined: set[str] = set()
    entered: dict[str, int] = {}
    exited: set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Assign):
            ctor = _thread_ctor(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if ctor is not None:
                        threads[t.id] = (ctor, node.lineno)
                        if _is_daemon_ctor(ctor):
                            daemonized.add(t.id)
                elif (isinstance(t, ast.Attribute) and t.attr == "daemon"
                        and isinstance(t.value, ast.Name)):
                    if isinstance(node.value, ast.Constant) and node.value.value:
                        daemonized.add(t.value.id)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name):
                if node.func.attr == "start":
                    started.add(recv.id)
                elif node.func.attr == "join":
                    joined.add(recv.id)
                elif node.func.attr == "__enter__":
                    entered.setdefault(recv.id, node.lineno)
                elif node.func.attr == "__exit__":
                    exited.add(recv.id)
            # Thread(...).start() — fire-and-forget, never joinable
            elif (node.func.attr == "start"
                    and isinstance(recv, ast.Call)
                    and _callee_name(recv.func) == "Thread"
                    and not _is_daemon_ctor(recv)):
                add("CH703", rel, node.lineno,
                    f"{fs.qualname}.thread.anonymous",
                    "non-daemon Thread started fire-and-forget — it can "
                    "never be joined, so process shutdown blocks on it "
                    "forever if its loop doesn't exit.  Keep a handle and "
                    "join it, or pass daemon=True")
    for name, (ctor, line) in threads.items():
        if name in started and name not in daemonized and name not in joined:
            add("CH703", rel, line, f"{fs.qualname}.thread.{name}",
                f"non-daemon Thread `{name}` started with no reachable "
                f"join in this function — a crashed owner leaks the "
                f"thread past shutdown.  join it (a `finally` is the "
                f"honest place) or pass daemon=True")
    for name, line in entered.items():
        if name not in exited:
            add("CH703", rel, line, f"{fs.qualname}.enter.{name}",
                f"`{name}.__enter__()` with no matching `{name}."
                f"__exit__` in this function — a manually entered "
                f"context manager (an armed FaultPlan, a held lock) "
                f"must be released in a `finally`, or the failure path "
                f"leaves it armed forever")
    # local open-without-close
    for node in nodes:
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        cname = _callee_name(node.value.func)
        if cname not in _OPEN_FACTORIES:
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            use = _name_used_as(fn, t.id)
            if use["closed"] or use["with"] or use["escapes"]:
                continue
            add("CH703", rel, node.lineno, f"{fs.qualname}.open.{t.id}",
                f"`{t.id} = {cname}(…)` is never closed and never "
                f"escapes this function — the handle leaks on every "
                f"call.  Use `with`, close it in a `finally`, or hand "
                f"it to an owner that closes it")


def _scan_attr_lifecycle(info, table, add) -> None:
    """CH703 for ``self.<attr>`` threads and manually entered CMs: the
    join / ``__exit__`` may live in any method of the class."""
    attr_threads: dict[str, tuple[int, str, str]] = {}  # attr -> (line, path, meth)
    attr_daemon: set[str] = set()
    attr_started: set[str] = set()
    attr_joined: set[str] = set()
    attr_entered: dict[str, tuple[int, str, str]] = {}
    attr_exited: set[str] = set()
    for meth in sorted(table):
        ci, fn = table[meth]
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                ctor = _thread_ctor(node.value)
                for t in node.targets:
                    attr = _is_self_attr(t)
                    if attr is not None and ctor is not None:
                        attr_threads.setdefault(
                            attr, (node.lineno, ci.path, f"{ci.name}.{meth}"))
                        if _is_daemon_ctor(ctor):
                            attr_daemon.add(attr)
                    elif (isinstance(t, ast.Attribute) and t.attr == "daemon"):
                        base = _is_self_attr(t.value)
                        if (base is not None
                                and isinstance(node.value, ast.Constant)
                                and node.value.value):
                            attr_daemon.add(base)
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                path = _self_attr_path(node.func.value)
                if path is None:
                    continue
                if node.func.attr == "start":
                    attr_started.add(path)
                elif node.func.attr == "join":
                    attr_joined.add(path)
                elif node.func.attr == "__enter__":
                    attr_entered.setdefault(
                        path, (node.lineno, ci.path, f"{ci.name}.{meth}"))
                elif node.func.attr == "__exit__":
                    attr_exited.add(path)
    for attr, (line, path, where) in sorted(attr_threads.items()):
        if (attr in attr_started and attr not in attr_daemon
                and attr not in attr_joined):
            add("CH703", path, line, f"{where}.thread.{attr}",
                f"non-daemon Thread `self.{attr}` started with no "
                f"`self.{attr}.join(…)` anywhere in the class — shutdown "
                f"can never reclaim it.  join it in stop()/close(), or "
                f"pass daemon=True")
    for attr, (line, path, where) in sorted(attr_entered.items()):
        if attr not in attr_exited:
            add("CH703", path, line, f"{where}.enter.{attr}",
                f"`self.{attr}.__enter__()` with no matching "
                f"`self.{attr}.__exit__` anywhere in the class — the "
                f"armed state leaks if no method ever releases it")


_GROW_MUTATORS = {"append", "appendleft", "add", "setdefault", "insert",
                  "extend"}
_SHRINK_MUTATORS = {"pop", "popleft", "popitem", "remove", "discard",
                    "clear"}
_QUEUE_FACTORIES = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}


def _scan_unbounded(index, info, table, entries, q_ann, add) -> None:
    """CH705 over a thread-entry class: unbounded stdlib queues on
    attributes, and plain containers that worker-reachable code grows
    while nothing in the class ever shrinks or resets them."""
    containers = _container_attrs(index, info)
    reachable = _reachable(table, entries)

    def _assign_targets(node):
        if isinstance(node, ast.Assign) and node.value is not None:
            return node.targets, node.value
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            return [node.target], node.value
        return [], None

    # attrs constructed as bounded deques (`deque(maxlen=N)` / second
    # positional arg): maxlen evicts on append — growth there is bounded
    # by construction and must stay silent
    bounded_attrs: set[str] = set()
    for meth in sorted(table):
        _, fn = table[meth]
        for node in ast.walk(fn):
            targets, value = _assign_targets(node)
            if not isinstance(value, ast.Call):
                continue
            if _callee_name(value.func) != "deque":
                continue
            has_bound = len(value.args) >= 2 or any(
                kw.arg == "maxlen" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value in (None, 0))
                for kw in value.keywords)
            if not has_bound:
                continue
            for t in targets:
                attr = _is_self_attr(t)
                if attr is not None:
                    bounded_attrs.add(attr)
    containers = {a for a in containers if a not in bounded_attrs}

    # queue constructions
    for meth in sorted(table):
        ci, fn = table[meth]
        for node in ast.walk(fn):
            targets, value = _assign_targets(node)
            if not isinstance(value, ast.Call):
                continue
            cname = _callee_name(value.func)
            if cname not in _QUEUE_FACTORIES:
                continue
            call = value
            bounded = bool(call.args) or any(
                kw.arg == "maxsize" and not (
                    isinstance(kw.value, ast.Constant) and kw.value.value == 0)
                for kw in call.keywords)
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and call.args[0].value == 0:
                bounded = False
            if cname == "SimpleQueue":
                bounded = False  # SimpleQueue has no bound at all
            if bounded:
                continue
            for t in targets:
                attr = _is_self_attr(t)
                if attr is None:
                    continue
                ann = q_ann if ci.path == info.path else {}
                if _annotated(ann, node.lineno):
                    continue
                add("CH705", ci.path, node.lineno,
                    f"{ci.name}.{meth}.{attr}",
                    f"`self.{attr} = {cname}()` with no maxsize on a "
                    f"daemon path (thread entries: {'/'.join(entries)}) — "
                    f"a stalled consumer grows it without limit.  Bound "
                    f"it and count drops, or annotate "
                    f"`# bounded: <reason>` naming the real backpressure")
    # grow-without-shrink containers
    grows: dict[str, tuple[int, str, str, str]] = {}
    shrinks: set[str] = set()
    for meth in sorted(table):
        ci, fn = table[meth]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                attr = _is_self_attr(node.func.value)
                if attr in containers:
                    if node.func.attr in _SHRINK_MUTATORS:
                        shrinks.add(attr)
                    elif (node.func.attr in _GROW_MUTATORS
                            and meth in reachable and meth != "__init__"):
                        grows.setdefault(attr, (
                            node.lineno, ci.path, f"{ci.name}.{meth}",
                            f".{node.func.attr}()"))
                name = _callee_name(node.func)
                if name in ("heappush", "heappop") and node.args:
                    attr = _is_self_attr(node.args[0])
                    if attr in containers:
                        if name == "heappop":
                            shrinks.add(attr)
                        elif meth in reachable and meth != "__init__":
                            grows.setdefault(attr, (
                                node.lineno, ci.path,
                                f"{ci.name}.{meth}", "heappush()"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        base = t.value
                        attr = _is_self_attr(base)
                        if attr in containers:
                            # constant-string keys are a fixed vocabulary
                            # (stats counters), not unbounded growth
                            if (isinstance(t.slice, ast.Constant)
                                    and isinstance(t.slice.value, str)):
                                continue
                            if isinstance(node, ast.Assign) and \
                                    meth in reachable and meth != "__init__":
                                grows.setdefault(attr, (
                                    node.lineno, ci.path,
                                    f"{ci.name}.{meth}", "subscript store"))
                    else:
                        attr = _is_self_attr(t)
                        if (attr in containers and meth != "__init__"
                                and isinstance(node, ast.Assign)):
                            shrinks.add(attr)  # wholesale rebind = reset
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _is_self_attr(t.value)
                        if attr in containers:
                            shrinks.add(attr)
    for attr, (line, path, where, what) in sorted(grows.items()):
        if attr in shrinks:
            continue
        ann = q_ann if path == info.path else {}
        if _annotated(ann, line):
            continue
        add("CH705", path, line, f"{where}.{attr}",
            f"container `self.{attr}` grows ({what}) on a worker-"
            f"reachable path (thread entries: {'/'.join(entries)}) and "
            f"NO method of {info.name} ever shrinks or resets it — "
            f"unbounded growth on a daemon path.  Evict somewhere, or "
            f"annotate the growth line `# bounded: <reason>`")
