"""Run a test module of the JAX package through both packages.

``twin(name, test, tmp_root)`` loads ``tests/<name>.py`` twice: as
written (the JAX package) and with every ``kubernetes_tpu`` import
renamed to ``kubernetes_tpu_torch`` (the port).  It runs the one test
function in each, on the same seeded inputs and the same fake clocks the
test makes, with every ``Store`` the test builds recorded.  Both runs
must pass the test's own assertions, and the two packages' stores must
then hold the same objects: a canonical dump of each store, in the order
the test built them, with uids, revisions (resource and creation),
timestamps and Events dropped and the ports of URLs masked (names,
owners, statuses, taints and podCIDRs stay).

The pod and job name counters of the controllers (``_suffix``) restart at
1 before each run, so controller-made names compare too.  ``lazy`` sets
both packages' ``api.lazy.ENABLED`` for the run (lazy informer decode on
or off).  ``echo`` names command-line entry points (``"cli.kubectl:main"``)
whose every call the test makes is recorded, its arguments, exit code and
output, with the ports of URLs and the names of temporary files masked:
the two packages' records must be equal too."""

from __future__ import annotations

import ast
import contextlib
import importlib
import inspect
import io
import itertools
import re
import sys
import tempfile
import types
from pathlib import Path
from typing import Iterable, Optional

import pytest

TESTS = Path(__file__).resolve().parent
ROOTS = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
_PKG_RE = re.compile(r"\bkubernetes_tpu\b")
_MODULES: dict[tuple[str, str], types.ModuleType] = {}
# the port of a URL a test server bound (an ephemeral port) differs by run
_URL_PORT_RE = re.compile(r"(://[\w.\-]+):\d+")

# a temporary file or directory's name (``tempfile``'s "tmp" + 8 characters)
_TMP_NAME_RE = re.compile(r"\btmp\w{8}\b")
# a loopback address with the port a test server bound, outside a URL
_LOOPBACK_PORT_RE = re.compile(r"\b(127\.0\.0\.1|localhost):\d+")

# keys dropped at any depth of a dump: identities and clocks that differ
# between two runs of one scenario
VOLATILE_KEYS = frozenset({"uid", "resourceVersion", "creationRevision",
                           "creationTimestamp", "deletionTimestamp"})
# kinds left out of a dump: Events carry counts and times of their own
SKIPPED_KINDS = frozenset({"Event"})


def cases(name: str, exclude: Iterable[str] = ()) -> list[str]:
    """The module's top-level test functions, read without importing it."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    skip = set(exclude)
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and n.name not in skip]


def load(name: str, which: str) -> types.ModuleType:
    key = (name, which)
    mod = _MODULES.get(key)
    if mod is None:
        path = TESTS / f"{name}.py"
        src = path.read_text()
        if which == "port":
            src = _PKG_RE.sub(ROOTS["port"], src)
        mod = types.ModuleType(f"tests._twin_{which}_{name}")
        mod.__file__ = str(path)
        sys.modules[mod.__name__] = mod
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _MODULES[key] = mod
    return mod


def _timey(key: str) -> bool:
    k = key.lower()
    return "timestamp" in k or k.endswith("time") or k.endswith("at")


def scrub(x, extra: frozenset = frozenset()):
    if isinstance(x, dict):
        return {k: scrub(v, extra) for k, v in x.items()
                if k not in VOLATILE_KEYS and k not in extra and not _timey(k)}
    if isinstance(x, (list, tuple)):
        return [scrub(v, extra) for v in x]
    if isinstance(x, str):
        return _URL_PORT_RE.sub(r"\1:<port>", x)
    return x


def dump(store, extra: frozenset = frozenset()) -> dict:
    with store._mu if hasattr(store, "_mu") else contextlib.nullcontext():
        objects = {kind: dict(bucket) for kind, bucket in store._objects.items()}
    return {kind: {key: scrub(item.data, extra) for key, item in sorted(bucket.items())}
            for kind, bucket in sorted(objects.items())
            if kind not in SKIPPED_KINDS and bucket}


@contextlib.contextmanager
def _recording(which: str, stores: list):
    cls = importlib.import_module(f"{ROOTS[which]}.store.store").Store
    init = cls.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        stores.append(self)

    cls.__init__ = recorded
    try:
        yield
    finally:
        cls.__init__ = init


@contextlib.contextmanager
def _lazy(flag: Optional[bool]):
    mods = [importlib.import_module(f"{r}.api.lazy") for r in ROOTS.values()]
    old = [m.ENABLED for m in mods]
    if flag is not None:
        for m in mods:
            m.ENABLED = flag
    try:
        yield
    finally:
        for m, o in zip(mods, old):
            m.ENABLED = o


def _reset_counters(which: str) -> None:
    for mod in ("replicaset", "job"):
        m = importlib.import_module(f"{ROOTS[which]}.controllers.{mod}")
        m._suffix = itertools.count(1)


def _call(mod, fn, stack: contextlib.ExitStack, tmp_root: Path):
    """Call ``fn`` with its fixtures resolved: the module's own (plain or
    generator fixtures), ``tmp_path`` and ``monkeypatch``."""
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p == "tmp_path":
            kwargs[p] = Path(tempfile.mkdtemp(dir=tmp_root))
        elif p == "monkeypatch":
            mp = pytest.MonkeyPatch()
            stack.callback(mp.undo)
            kwargs[p] = mp
        else:
            fx = getattr(mod, p)
            kwargs[p] = _fixture(mod, fx, stack, tmp_root)
    return fn(**kwargs)


def _fixture(mod, fx, stack, tmp_root):
    fn = fx._get_wrapped_function() if hasattr(fx, "_get_wrapped_function") else fx
    value = _call(mod, fn, stack, tmp_root)
    if inspect.isgenerator(value):
        gen = value
        value = next(gen)
        stack.callback(lambda: next(gen, None))
    return value


@contextlib.contextmanager
def _echoing(which: str, mod: types.ModuleType, entries: Iterable[str], calls: list):
    """Wrap each entry point ``"module:attr"`` (a ``main(argv, clientset,
    out)``) in the package and in the test module's names, recording
    ``[entry, argv, exit code, output]`` for every call."""
    undo = []
    for entry in entries:
        path, attr = entry.split(":")
        owner = importlib.import_module(f"{ROOTS[which]}.{path}")
        fn = getattr(owner, attr)

        def recorded(argv=None, clientset=None, out=None, _fn=fn, _entry=entry):
            buf = io.StringIO()
            rc = _fn(argv, clientset, buf)
            text = buf.getvalue()
            (out or sys.stdout).write(text)
            calls.append([_entry, list(argv or []), rc, text])
            return rc

        for ns in (owner.__dict__, mod.__dict__):
            for key, value in list(ns.items()):
                if value is fn:
                    ns[key] = recorded
                    undo.append((ns, key, fn))
    try:
        yield
    finally:
        for ns, key, fn in reversed(undo):
            ns[key] = fn


def _mask_text(text: str) -> str:
    text = _LOOPBACK_PORT_RE.sub(r"\1:<port>", scrub(text))
    return _TMP_NAME_RE.sub("tmp<name>", text)


def _mask(calls: list) -> list:
    return [[entry, [_mask_text(a) for a in argv], rc, _mask_text(text)]
            for entry, argv, rc, text in calls]


def run(name: str, test: str, which: str, tmp_root: Path, lazy: Optional[bool] = None,
        extra: frozenset = frozenset(), echo: Iterable[str] = (),
        calls: Optional[list] = None) -> list:
    mod = load(name, which)
    stores: list = []
    _reset_counters(which)
    with _lazy(lazy), contextlib.ExitStack() as stack:
        with _recording(which, stores), _echoing(which, mod, echo,
                                                  calls if calls is not None else []):
            _call(mod, getattr(mod, test), stack, tmp_root)
        dumps = [dump(s, extra) for s in stores]
    return dumps


def twin(name: str, test: str, tmp_root: Path, lazy: Optional[bool] = None,
         extra_volatile: Iterable[str] = (), echo: Iterable[str] = ()) -> list:
    """Run ``test`` of ``tests/<name>.py`` on the JAX package, then on the
    port; both must pass and leave equal store dumps (and equal records
    of the ``echo`` entry points' calls).  Returns the port's dumps."""
    extra = frozenset(extra_volatile)
    calls = {"jax": [], "port": []}
    jax_dumps = run(name, test, "jax", tmp_root, lazy, extra, echo, calls["jax"])
    port_dumps = run(name, test, "port", tmp_root, lazy, extra, echo, calls["port"])
    assert len(port_dumps) == len(jax_dumps)
    for i, (p, j) in enumerate(zip(port_dumps, jax_dumps)):
        assert p == j, f"store {i} differs: {_first_difference(p, j)}"
    port_calls, jax_calls = _mask(calls["port"]), _mask(calls["jax"])
    assert len(port_calls) == len(jax_calls), (len(port_calls), len(jax_calls))
    for p, j in zip(port_calls, jax_calls):
        assert p == j, f"call differs: {_first_difference(p, j)}"
    return port_dumps


def _first_difference(a, b, path="") -> str:
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}/{k}: port {a.get(k, '<absent>')!r} jax {b.get(k, '<absent>')!r}"
            if a[k] != b[k]:
                return _first_difference(a[k], b[k], f"{path}/{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return f"{path}: port {a!r} jax {b!r}"
