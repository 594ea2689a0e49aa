"""The port stands alone: no module of ``kubernetes_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package or names one
of its modules (as a process to start, say), and importing every module
of the port leaves both out of ``sys.modules``."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "kubernetes_tpu_torch")


def _sources():
    for dirpath, _dirs, files in os.walk(PORT_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu")


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and re.fullmatch(r"(jax|jaxlib|kubernetes_tpu)(\.\w+)*", node.value)):
            # a module name as a string: import_module("..."), or
            # "python -m kubernetes_tpu.scheduler" as a process to start
            bad.append(node.value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports or starts {bad}"


def _module_names():
    for path in _sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_import_leaves_jax_and_reference_unloaded():
    """Every module of the port (store, client, utils, the scheduler, the
    apiserver and the daemon entry points included) imports without
    pulling JAX or the reference package in."""
    mods = sorted(_module_names())
    assert {"kubernetes_tpu_torch.store.store", "kubernetes_tpu_torch.client.informer",
            "kubernetes_tpu_torch.client.record", "kubernetes_tpu_torch.utils.metrics",
            "kubernetes_tpu_torch.scheduler.scheduler", "kubernetes_tpu_torch.apiserver.server",
            "kubernetes_tpu_torch.apiserver.__main__", "kubernetes_tpu_torch.daemon",
            "kubernetes_tpu_torch.client.remote", "kubernetes_tpu_torch.client.leaderelection",
            "kubernetes_tpu_torch.utils.features", "kubernetes_tpu_torch.utils.health",
            "kubernetes_tpu_torch.scheduler.__main__",
            "kubernetes_tpu_torch.__main__"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'kubernetes_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
