"""The port stands alone: no module of ``kubernetes_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package or names one
of its modules (as a process to start, say), and importing every module
of the port leaves both out of ``sys.modules``.  Neither needs
``cryptography``: only the functions that mint certificates or verify a
PEM header or an RS256 token import it, inside the call, as the JAX
package's do."""

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


def _top_level_imports(tree) -> set:
    """Modules imported outside any function: what importing the file needs."""
    names = set()
    for node in tree.body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            if isinstance(sub, ast.Import):
                names |= {a.name.split(".")[0] for a in sub.names}
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
                names.add(sub.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_level_cryptography_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    assert "cryptography" not in _top_level_imports(tree), os.path.relpath(path, ROOT)


def _module_names():
    for path in _sources():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


# the JAX package's controllers/, every module ported
_CONTROLLER_MODULES = (
    "__main__", "base", "certificates", "crdregistrar", "cronjob", "daemonset", "deployment",
    "disruption", "endpoint", "garbagecollector", "horizontal", "ipam", "job", "manager",
    "metrics_client", "namespace", "node_lifecycle", "podgc", "replicaset", "resourcequota",
    "serviceaccounts", "statefulset", "taint", "ttl", "volume")
# the JAX package's dns/, proxy/ and cloud/, every module ported
_LIFECYCLE_MODULES = (
    "dns", "dns.__main__", "dns.records", "dns.server",
    "proxy", "proxy.proxier", "proxy.healthcheck", "proxy.userspace", "proxy.hollow",
    "cloud", "cloud.__main__", "cloud.controllers", "cloud.manager", "cloud.provider")
# the JAX package's cli/ and federation/, every module ported
_CLI_MODULES = (
    "cli", "cli.kubectl", "federation", "federation.__main__", "federation.controllers",
    "federation.kubefed", "federation.manager", "federation.types")


def test_import_leaves_jax_and_reference_unloaded():
    """Every module of the port (store, client, utils, the scheduler, the
    apiserver, the daemon entry points, the fault registry and the testing
    helpers included) imports without pulling JAX or the reference package
    in."""
    mods = sorted(_module_names())
    assert {"kubernetes_tpu_torch.store.store", "kubernetes_tpu_torch.client.informer",
            "kubernetes_tpu_torch.client.record", "kubernetes_tpu_torch.utils.metrics",
            "kubernetes_tpu_torch.scheduler.scheduler", "kubernetes_tpu_torch.apiserver.server",
            "kubernetes_tpu_torch.apiserver.__main__", "kubernetes_tpu_torch.daemon",
            "kubernetes_tpu_torch.client.remote", "kubernetes_tpu_torch.client.leaderelection",
            "kubernetes_tpu_torch.utils.features", "kubernetes_tpu_torch.utils.health",
            "kubernetes_tpu_torch.scheduler.__main__",
            "kubernetes_tpu_torch.__main__", "kubernetes_tpu_torch.native",
            "kubernetes_tpu_torch.api.lazy", "kubernetes_tpu_torch.store.frames",
            "kubernetes_tpu_torch.store.columns", "kubernetes_tpu_torch.scheduler.preemption",
            "kubernetes_tpu_torch.ops.preemption_kernel", "kubernetes_tpu_torch.scheduler.policy",
            "kubernetes_tpu_torch.scheduler.extender",
            # tracing, the fault registry, telemetry and overload control
            "kubernetes_tpu_torch.faults", "kubernetes_tpu_torch.faults.core",
            "kubernetes_tpu_torch.testing", "kubernetes_tpu_torch.testing.chaos",
            "kubernetes_tpu_torch.testing.slo", "kubernetes_tpu_torch.utils.tracing",
            "kubernetes_tpu_torch.utils.timeseries", "kubernetes_tpu_torch.utils.slo",
            "kubernetes_tpu_torch.utils.fanout", "kubernetes_tpu_torch.utils.telemetry",
            "kubernetes_tpu_torch.utils.overload",
            # auth, PKI, TLS and the test PKI
            "kubernetes_tpu_torch.auth", "kubernetes_tpu_torch.auth.authn",
            "kubernetes_tpu_torch.auth.authz", "kubernetes_tpu_torch.auth.audit",
            "kubernetes_tpu_torch.api.rbac", "kubernetes_tpu_torch.pki",
            "kubernetes_tpu_torch.testing.pki", "kubernetes_tpu_torch.testing.pki.mint",
            # the kubelet and the hollow fleet
            "kubernetes_tpu_torch.kubelet", "kubernetes_tpu_torch.kubelet.__main__",
            "kubernetes_tpu_torch.kubelet.hollow", "kubernetes_tpu_torch.kubelet.cm",
            "kubernetes_tpu_torch.kubelet.cri", "kubernetes_tpu_torch.kubelet.containers",
            "kubernetes_tpu_torch.kubelet.network", "kubernetes_tpu_torch.kubelet.pleg",
            "kubernetes_tpu_torch.kubelet.runtime", "kubernetes_tpu_torch.kubelet.server",
            "kubernetes_tpu_torch.kubelet.volumehost",
            "kubernetes_tpu_torch.kubelet.volumemanager",
            # the kubelet proxies and the controller manager
            "kubernetes_tpu_torch.apiserver.tunneler", "kubernetes_tpu_torch.utils.cron",
            *(f"kubernetes_tpu_torch.controllers.{m}" for m in _CONTROLLER_MODULES),
            "kubernetes_tpu_torch.controllers",
            # cluster lifecycle, the DNS addon, the hollow proxy and the cloud
            "kubernetes_tpu_torch.cluster",
            *(f"kubernetes_tpu_torch.{m}" for m in _LIFECYCLE_MODULES),
            # kubectl and federation
            *(f"kubernetes_tpu_torch.{m}" for m in _CLI_MODULES)} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'kubernetes_tpu', 'cryptography')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _cli_sources():
    for sub in ("cli", "federation"):
        d = os.path.join(PORT_DIR, sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", list(_cli_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_cli_modules_import_neither_torch_nor_yaml_at_module_level(path):
    """kubectl and kubefed start as processes of their own a command:
    neither loads ``torch``, and PyYAML only where YAML is read or
    written."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    assert not _top_level_imports(tree) & {"torch", "yaml"}, os.path.relpath(path, ROOT)


def test_cli_import_leaves_torch_and_yaml_unloaded():
    mods = [f"kubernetes_tpu_torch.{m}" for m in _CLI_MODULES] + ["kubernetes_tpu_torch.__main__"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('torch', 'yaml') if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _inside_port(path: str) -> bool:
    return os.path.commonpath([os.path.abspath(path), PORT_DIR]) == PORT_DIR


def test_the_port_builds_only_from_its_own_sources():
    """The native helpers and the CUDA kernels build from sources under
    ``kubernetes_tpu_torch/`` into build directories under it: never from
    or into the repo's root ``csrc/``, which belongs to the reference."""
    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.ops import _build

    for d in (native.CSRC, native.BUILD_DIR, _build.CSRC, _build.BUILD_DIR):
        assert _inside_port(d), d
    assert {"labelmatch.cpp", "fastcopy.c"} <= set(os.listdir(native.CSRC))
    assert "fused_scan.cu" in os.listdir(_build.CSRC)
    assert all(_inside_port(p) for p in _build.sources("fused_scan"))
    root_csrc = os.path.join(ROOT, "csrc")
    before = sorted(os.listdir(root_csrc))
    assert native.get_lib() is not None and native.get_fastcopy() is not None
    assert _inside_port(native._lib._name)
    assert "pause.c" in os.listdir(native.CSRC)
    assert _inside_port(native.pause_binary())
    assert sorted(os.listdir(root_csrc)) == before


def test_controller_manager_refuses_a_bad_feature_gate():
    """``controller-manager --feature-gates Bogus=true`` leaves through
    ``ap.error`` (exit 2) before it dials any apiserver, as the port's
    scheduler and kubelet entries do."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch", "controller-manager",
         "--apiserver", "http://127.0.0.1:1", "--feature-gates", "Bogus=true"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "--feature-gates" in proc.stderr and "Bogus" in proc.stderr
