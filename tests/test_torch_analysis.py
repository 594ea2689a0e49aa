"""The port's analysis lints (``kubernetes_tpu_torch.analysis``) held
finding for finding to the JAX package's passes.

- The fixture tests of ``tests/test_static_analysis.py`` whose renamed
  module holds run through both packages (``tests/torch_twin``); the
  ones that hold only with the port's own files or the torch fixtures
  are written here.
- Group A (races, concurrency, metrics, tracecov, parity) and the rules
  group B keeps unchanged (TS100, TS103, DC600, DC604, DC605) give the
  JAX pass's exact ``(code, path, line, symbol, message)`` list on every
  file of ``tests/analysis_fixtures/``, read in place, with the same
  scopes.
- Group B's retargeted rules (TS101/TS102 under torch's tracers; DC601
  dead device pointers, DC602 the host-sync budget, DC603 the build
  identity) give the JAX test's expected ``(code, symbol)`` keys on the
  torch mirrors in ``tests/torch_analysis_fixtures/``; DC603's cases are
  the build-identity counterparts under the same symbols.
- Seeded bugs in copies of the port's own files are caught, and the
  untouched copies are clean; the frontier loop's runtime ``host_syncs``
  stays within the static budget the pass counts.

Tolerance: exact equality."""

from __future__ import annotations

import importlib
import os
import re

import pytest

from kubernetes_tpu_torch.analysis import core as pcore
from kubernetes_tpu_torch.analysis import device_contracts as pdc
from kubernetes_tpu_torch.analysis import trace_safety as pts
from kubernetes_tpu_torch.analysis.core import load_baseline, repo_root, run_analysis
from tests import torch_port_cases as cases
from tests.torch_twin import twin

ROOT = repo_root()
NAME = "test_static_analysis"
FIXTURES = "tests/analysis_fixtures"
TORCH_FIXTURES = "tests/torch_analysis_fixtures"
TS_PATH = f"{TORCH_FIXTURES}/fixture_trace_safety.py"
DC_PATH = f"{TORCH_FIXTURES}/fixture_device_contracts.py"
DC_SCOPE = {"paths": [DC_PATH], "hot_modules": [DC_PATH]}
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _fixture_line(rel_path: str, needle: str) -> int:
    """1-based line of the first source line containing ``needle``."""
    with open(os.path.join(ROOT, rel_path), encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            if needle in line:
                return i
    raise AssertionError(f"{needle!r} not found in {rel_path}")


def _pass_module(pkg: str, mod: str):
    return importlib.import_module(f"{pkg}.analysis.{mod}")


# -- 1. the reference's fixture tests, through both packages ------------------

TWINS = [
    "test_every_baseline_entry_has_justification",
    "test_prune_baseline_function_edge_cases",
    "test_parity_fixture_codes_and_locations",
    "test_parity_fixture_mapped_entities_stay_clean",
    "test_race_fixture_codes_and_locations",
    "test_race_fixture_exemptions_stay_clean",
    "test_metrics_fixture_codes_and_locations",
    "test_metrics_fixture_exemptions_stay_clean",
    "test_tracecov_fixture_codes_and_locations",
    "test_tracecov_fixture_exemptions_stay_clean",
    "test_baseline_requires_justification",
    "test_changed_files_unit",
    "test_concurrency_fixture_codes_and_locations",
    "test_concurrency_fixture_exemptions_stay_clean",
    # the seeded-bug copies of files both packages have, under their
    # renamed paths (the port's wal.py, scheduler.py, informer.py and
    # timeseries.py carry the same sites)
    "test_concurrency_pass_catches_seeded_blocking_under_lock",
    "test_concurrency_pass_catches_seeded_thread_leak",
    "test_concurrency_pass_catches_seeded_callback_under_lock",
    "test_concurrency_pass_catches_seeded_unbounded_growth",
    "test_concurrency_annotations_require_reasons",
]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("test", TWINS)
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)


def test_concurrency_pass_catches_seeded_swallow(tmp_path):
    """The port's counted close-failure handler lives in
    ``RemoteWatch._close`` (the JAX package's in ``_run``): replacing its
    counter with a bare ``pass`` is caught; the untouched copy has no
    CH702 findings."""
    from kubernetes_tpu_torch.analysis import concurrency_hazards as ch

    with open(os.path.join(ROOT, "kubernetes_tpu_torch/client/remote.py"),
              encoding="utf-8") as f:
        src = f.read()
    (tmp_path / "rw_clean.py").write_text(src)
    assert [f for f in ch.run(str(tmp_path), paths=["rw_clean.py"]) if f.code == "CH702"] == []
    counted = "self.metrics.watch_close_errors.inc()"
    assert src.count(counted) == 1
    (tmp_path / "rw_bug.py").write_text(src.replace(counted, "pass", 1))
    got = {(f.code, f.symbol) for f in ch.run(str(tmp_path), paths=["rw_bug.py"])}
    assert ("CH702", "RemoteWatch._close.swallow1") in got, got


# -- 2. fixture parity: the same findings, message for message ---------------

FIXTURE_FILES = sorted(f for f in os.listdir(os.path.join(ROOT, FIXTURES)) if f.endswith(".py"))
TC_SCOPE = {"paths": [f"{FIXTURES}/fixture_tracecov.py", f"{FIXTURES}/fixture_tracecov_hot.py",
                      f"{FIXTURES}/fixture_tracecov_phase.py"],
            "hot_modules": [f"{FIXTURES}/fixture_tracecov.py", f"{FIXTURES}/fixture_tracecov_hot.py"],
            "phase_files": [f"{FIXTURES}/fixture_tracecov.py"]}
PARITY_ORACLE = f"{FIXTURES}/fixture_parity_oracle.py"
#: the group-B rules the port keeps unchanged
UNCHANGED_B = {"trace": {"TS100", "TS103"}, "device": {"DC600", "DC604", "DC605"}}


def _scopes(pass_name: str, path: str) -> list[dict]:
    """The scopes one fixture file is read under: the file alone, and
    as hot module, phase file or kernel file where the pass has them."""
    if pass_name == "tracecov":
        return [{"paths": [path], "hot_modules": [], "phase_files": []},
                {"paths": [path], "hot_modules": [path], "phase_files": [path]}]
    if pass_name == "parity":
        return [{"oracle_paths": [PARITY_ORACLE], "kernel_paths": [path]},
                {"oracle_paths": [path], "kernel_paths": [path]}]
    if pass_name == "device":
        return [{"paths": [path], "hot_modules": [path]}]
    return [{"paths": [path]}]


def _normalized(findings, codes=None) -> list[tuple]:
    return [(f.code, f.path, f.line, f.symbol, f.message.replace("kubernetes_tpu_torch",
                                                                 "kubernetes_tpu"))
            for f in findings if codes is None or f.code in codes]


def _both(pass_name: str, scope: dict, root: str = ROOT) -> list[list[tuple]]:
    codes = UNCHANGED_B.get(pass_name)
    return [_normalized(run_analysis_of(pkg, root, pass_name, scope), codes) for pkg in PACKAGES]


def run_analysis_of(pkg: str, root: str, pass_name: str, scope: dict):
    return importlib.import_module(f"{pkg}.analysis.core").run_analysis(
        root=root, passes=[pass_name], scopes={pass_name: scope}).findings


@pytest.mark.parametrize("pass_name", ["races", "concurrency", "metrics", "tracecov", "parity",
                                       "trace", "device"])
@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_findings_equal_the_jax_pass(pass_name, fixture):
    for scope in _scopes(pass_name, f"{FIXTURES}/{fixture}"):
        jax, port = _both(pass_name, scope)
        assert port == jax, (scope, port, jax)


@pytest.mark.parametrize("scope", [TC_SCOPE, {"oracle_paths": [PARITY_ORACLE],
                                              "kernel_paths": [f"{FIXTURES}/fixture_parity_kernel.py"]}],
                         ids=["tracecov", "parity"])
def test_fixture_scopes_of_the_jax_tests_give_equal_findings(scope):
    pass_name = "tracecov" if "hot_modules" in scope else "parity"
    jax, port = _both(pass_name, scope)
    assert port == jax and port, (port, jax)


# -- 3. group B on the torch mirrors -------------------------------------------

@pytest.fixture(scope="module")
def trace_findings():
    return run_analysis(root=ROOT, passes=["trace"], scopes={"trace": {"paths": [TS_PATH]}}).findings


def test_trace_fixture_codes_and_locations(trace_findings):
    """The JAX test's expected keys, each at its torch counterpart: a
    ``torch.compile``d body for ``jax.jit``, ``torch.func.vmap``,
    ``torch.compile(partial(...))``, ``torch.jit.trace`` of a partial
    alias and ``torch.compile(self._step)`` for ``lax.scan``."""
    path = TS_PATH
    got = {(f.code, f.symbol): f.line for f in trace_findings}
    expected = {
        ("TS101", "bad_host_escape.float"): _fixture_line(path, "float(x[0])"),
        ("TS101", "bad_item_escape.item"): _fixture_line(path, "x.sum().item()"),
        ("TS101", "bad_np_call.np.argsort"): _fixture_line(path, "np.argsort(x)"),
        ("TS102", "bad_branch.if.total"): _fixture_line(path, "if total > 0:"),
        ("TS102", "bad_loop_body.if.state"): _fixture_line(path, "if state:"),
        ("TS103", "bad_set_feed.set-iter"): _fixture_line(path, "hash(k) for k in ids"),
        ("TS102", "bad_partial_step.if.state"): _fixture_line(
            path, "if state:  # TS102 through the partial reference"),
        ("TS102", "bad_alias_step.if.state"): _fixture_line(
            path, "if state:  # TS102 through a module-level partial alias"),
        ("TS102", "MethodStepper._bad_method_step.if.state"): _fixture_line(
            path, "if state:  # TS102 through a bound-method reference"),
        ("TS101", "MethodStepper._bad_helper.float"): _fixture_line(path, "n = float(x.sum())"),
    }
    assert got == expected, f"got {sorted(got)}"
    messages = {f.symbol: f.message for f in trace_findings}
    assert "torch.where" in messages["bad_branch.if.total"]


def test_trace_fixture_exemptions_stay_clean(trace_findings):
    flagged = {f.symbol for f in trace_findings}
    for clean_fn in ("clean_static_flag", "clean_is_none", "clean_sorted_feed", "drive"):
        assert not any(s.startswith(clean_fn) for s in flagged), sorted(flagged)


def test_trace_mirror_has_the_jax_fixtures_functions():
    """One function (and class) for each of the JAX fixture's, by name."""
    import ast

    def names(path):
        tree = ast.parse(open(os.path.join(ROOT, path), encoding="utf-8").read())
        return [n.name for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))]

    assert names(TS_PATH) == names(f"{FIXTURES}/fixture_trace_safety.py")
    assert names(DC_PATH) == names(f"{FIXTURES}/fixture_device_contracts.py")


@pytest.fixture(scope="module")
def device_findings():
    return run_analysis(root=ROOT, passes=["device"], scopes={"device": DC_SCOPE}).findings


def test_device_fixture_codes_and_locations(device_findings):
    """The JAX test's expected keys.  DC601 is a dead device pointer (a
    temporary's, and one a callee drops before the caller launches) in
    place of use-after-donate; DC603's three cases are the build-identity
    counterparts under the reference's symbols: a padded shape in the
    library's name (``pad_bad._pad_to``), a width in a ``-D`` define
    (``width_bad._pow2_width``), a segment dimension handed to a helper
    whose parameter keys a build (``factory_call_bad._fixture_runner``)."""
    got = {(f.code, f.symbol): f.line for f in device_findings}
    ann_stale = _fixture_line(DC_PATH, "# device: sync — nothing materializes")
    ann_reasonless = _fixture_line(DC_PATH, "# device: sync\n")
    ann_static = _fixture_line(DC_PATH, "# device: static\n")
    expected = {
        ("DC601", "FixtureLoop.dispatch_bad._state"): _fixture_line(
            DC_PATH, "self._state.clone().data_ptr()"),
        ("DC601", "FixtureLoop.dispatch_callee_bad._state._peek"): _fixture_line(
            DC_PATH, "ptrs = self._peek()"),
        ("DC602", "FixtureLoop.sync_bad._state"): _fixture_line(
            DC_PATH, "n = int(torch.sum(self._state))"),
        ("DC602", "reasonless_sync.dev"): _fixture_line(DC_PATH, "n = int(dev.cuda().sum())"),
        ("DC603", "pad_bad._pad_to"): _fixture_line(
            DC_PATH, 'return _build.load(f"fixture_{_pad_to(x.shape[0], 8)}")\n'),
        ("DC603", "width_bad._pow2_width"): _fixture_line(
            DC_PATH, 'f"-DWIDTH={_pow2_width(x.shape[1], 8)}"]\n'),
        ("DC603", "factory_call_bad._fixture_runner.static.chunk"): _fixture_line(
            DC_PATH, "run = _fixture_runner(static.chunk)"),
        ("DC604", "fixture_schedule.apply_bad.raw.add_pod"): _fixture_line(
            DC_PATH, "raw.add_pod(pod)"),
        ("DC604", "fixture_schedule.apply_bad.work_map.remove_pod"): _fixture_line(
            DC_PATH, "work_map[name].remove_pod(pod)"),
        ("DC604", "fixture_schedule.apply_bad.raw.node"): _fixture_line(DC_PATH, "raw.node = None"),
        ("DC605", f"stale_sync_annotation.L{ann_stale}"): ann_stale,
        ("DC605", f"reasonless_sync.L{ann_reasonless}"): ann_reasonless,
        ("DC605", f"stale_static_annotation.L{ann_static}"): ann_static,
    }
    assert got == expected, f"got {sorted(got)}"
    messages = {f.symbol: f.message for f in device_findings}
    assert "temporary" in messages["FixtureLoop.dispatch_bad._state"]
    assert "FixtureLoop._peek" in messages["FixtureLoop.dispatch_callee_bad._state._peek"]
    assert "# device: sync — <reason>" in messages["FixtureLoop.sync_bad._state"]
    assert "build" in messages["pad_bad._pad_to"]
    assert "mutable_info" in messages["fixture_schedule.apply_bad.raw.add_pod"]


def test_device_expected_keys_are_the_jax_tests():
    """The (code, symbol) keys the port's device test expects are the JAX
    test's, rule for rule."""
    jax = run_analysis_of("kubernetes_tpu", ROOT, "device",
                          {"paths": [f"{FIXTURES}/fixture_device_contracts.py"],
                           "hot_modules": [f"{FIXTURES}/fixture_device_contracts.py"]})
    port = run_analysis(root=ROOT, passes=["device"], scopes={"device": DC_SCOPE}).findings
    key = {"DC605": lambda s: s.rsplit(".L", 1)[0]}
    assert ({(f.code, key.get(f.code, str)(f.symbol)) for f in port}
            == {(f.code, key.get(f.code, str)(f.symbol)) for f in jax})


def test_device_fixture_exemptions_stay_clean(device_findings):
    symbols = {f.symbol for f in device_findings}
    for clean in ("FixtureLoop.dispatch_ok", "FixtureLoop.sync_ok", "FixtureLoop.__init__",
                  "FixtureLoop._peek", "pad_ok_sticky",
                  "pad_ok_annotated", "width_ok", "factory_call_ok",
                  "fixture_schedule.apply_ok", "_fixture_runner"):
        assert not any(s.startswith(clean) for s in symbols), sorted(symbols)


def test_baseline_suppresses_and_reports_stale():
    baseline = {
        f"TS101:{TS_PATH}:bad_host_escape.float": "seeded",
        "TS999:nowhere.py:ghost.symbol": "points at nothing",
    }
    report = run_analysis(root=ROOT, passes=["trace"], baseline=baseline,
                          scopes={"trace": {"paths": [TS_PATH]}})
    assert "bad_host_escape.float" in {f.symbol for f in report.suppressed}
    live = {f.symbol for f in report.findings}
    assert "bad_host_escape.float" not in live
    assert "bad_item_escape.item" in live
    assert report.stale_suppressions == ["TS999:nowhere.py:ghost.symbol"]


def test_finding_keys_are_line_independent(trace_findings, device_findings):
    for f in trace_findings + device_findings:
        if f.code == "DC605":
            continue  # an annotation's key is its line: it has no other anchor
        assert str(f.line) not in f.key.split(":")[-1], f.key


# -- 4. the retargeted rules, one shape each -----------------------------------

def _run_src(tmp_path, src: str, pass_name: str) -> set:
    (tmp_path / "m.py").write_text(src)
    mod = pts if pass_name == "trace" else pdc
    kw = {"hot_modules": ["m.py"]} if pass_name == "device" else {}
    return {(f.code, f.symbol) for f in mod.run(str(tmp_path), paths=["m.py"], **kw)}


@pytest.mark.parametrize("src, expected", [
    # a CUDA-graph capture body, checked against its function's taint,
    # and what it calls traced
    ("import torch\n"
     "def helper(y):\n    return y.tolist()\n"
     "def capture(g, x):\n"
     "    with torch.cuda.graph(g):\n"
     "        y = x * 2\n"
     "        if y.sum() > 0:\n            y = y + 1\n"
     "        helper(y)\n",
     {("TS102", "capture.if.y"), ("TS101", "helper.tolist")}),
    # torch.jit.script decorator, .cpu() and .numpy() escapes
    ("import torch\n"
     "@torch.jit.script\n"
     "def f(x):\n    a = x.cpu()\n    return x.numpy()\n",
     {("TS101", "f.cpu"), ("TS101", "f.numpy")}),
    # make_graphed_callables and a bare vmap import; a plain function
    # with the same body stays clean
    ("import torch\nfrom torch.func import vmap\n"
     "def g(x):\n    return int(x)\n"
     "def h(x):\n    return bool(x)\n"
     "def plain(x):\n    return int(x)\n"
     "graphed = torch.cuda.make_graphed_callables(g, (torch.ones(1),))\n"
     "batched = vmap(h)\n",
     {("TS101", "g.int"), ("TS101", "h.bool")}),
    # the builtin compile is no tracer
    ("def f(x):\n    return float(x)\nc = compile(f, 'x', 'exec')\n", set()),
])
def test_trace_retargeting(tmp_path, src, expected):
    assert _run_src(tmp_path, src, "trace") == expected


@pytest.mark.parametrize("src, expected", [
    # every sync form on a device tensor; the .cpu() result is host
    ("import torch\n"
     "def f(dev, ev, stream):\n"
     "    x = torch.zeros(4, device=dev)\n"
     "    a = x.item()\n"
     "    b = x.to('cpu')\n"
     "    c = x.to(torch.device('cpu'))\n"
     "    h = x.cpu()\n"
     "    d = int(h[0]) + float(h.sum())\n"
     "    torch.cuda.synchronize()\n"
     "    ev.synchronize()\n"
     "    stream.synchronize()\n"
     "    y = x.to(torch.int32)\n"
     "    z = y.tolist()\n",
     {("DC602", "f.x"), ("DC602", "f.torch.cuda.synchronize"), ("DC602", "f.ev.synchronize"),
      ("DC602", "f.stream.synchronize"), ("DC602", "f.y")}),
    # a host tensor, a record's field, and an identity test are not syncs
    ("import torch\n"
     "def f(bufs, ctl):\n"
     "    x = torch.zeros(4)\n"
     "    s = bufs['statics'][0]\n"
     "    return int(x.sum()), int(s.use_terms), int(ctl is not None)\n", set()),
    # the launch wrappers' buffers are device by name; a rebinding to a
    # .cpu() result makes the later reads host
    ("def finalize(bufs):\n"
     "    out = bufs['chosen'].cuda()\n"
     "    out = out.cpu().numpy()\n"
     "    return int(out[-1])\n", {("DC602", "finalize.out")}),
    # a sanctioned site
    ("def f(ctl):\n"
     "    # device: sync — the one control read\n"
     "    return ctl.cpu()\n", set()),
])
def test_sync_budget_retargeting(tmp_path, src, expected):
    assert {k for k in _run_src(tmp_path, src, "device") if k[0] == "DC602"} == expected


@pytest.mark.parametrize("src, expected", [
    # a temporary's pointer, wherever taken
    ("def f(x, lib):\n    lib.k_launch(x.to('cuda').data_ptr())\n", {("DC601", "f.x")}),
    # a local rebound before the launch in the same function
    ("def f(x, lib):\n"
     "    t = x.contiguous()\n"
     "    p = t.data_ptr()\n"
     "    t = None\n"
     "    lib.k_launch(p)\n", {("DC601", "f.x")}),
    # a parameter's pointer is the caller's; a local held to the launch,
    # a cache getter's tensor and a pointer taken after a rebinding are live
    ("def scratch(bufs, n):\n"
     "    s = bufs.get('s')\n"
     "    if s is None:\n        s = bufs['s'] = torch.zeros(n)\n"
     "    return s\n"
     "def f(bufs, x, lib):\n"
     "    t = x.contiguous()\n"
     "    t = t.clone()\n"
     "    lib.k_launch(bufs['a'].data_ptr(), t.data_ptr(), scratch(bufs, 4).data_ptr(),\n"
     "                 x.data_ptr())\n", set()),
])
def test_dead_pointer_retargeting(tmp_path, src, expected):
    assert {k for k in _run_src(tmp_path, src, "device") if k[0] == "DC601"} == expected


@pytest.mark.parametrize("src, expected", [
    # NVCC_FLAGS, library_path and a -D define built by concatenation
    ("from kubernetes_tpu_torch.ops import _build\n"
     "def f(x, static, pl: 'Plan'):\n"
     "    _build.NVCC_FLAGS.append('-DN=' + str(len(x)))\n"
     "    _build.library_path(f'k{static.n_pad}')\n"
     "    flags = ['-DCOLS=' + str(pl.cols)]\n"
     "    rp = plan_for(x)\n"
     "    flags += [f'-DTW={rp.tw}']\n",
     {("DC603", "f.len"), ("DC603", "f.static.n_pad"), ("DC603", "f.pl.cols"),
      ("DC603", "f.rp.tw")}),
    # constants, a sanctioned site, and a shape passed to the launch
    ("from kubernetes_tpu_torch.ops import _build\n"
     "def f(x):\n"
     "    lib = _build.load('fused_scan')\n"
     "    _build.build(f'k{x.size(0)}')  # device: static — a test build\n"
     "    return lib.k_launch(x.shape[0])\n", set()),
])
def test_build_identity_retargeting(tmp_path, src, expected):
    assert {k for k in _run_src(tmp_path, src, "device") if k[0] in ("DC603", "DC605")} == expected


# -- 5. seeded bugs in copies of the port's own files ------------------------

def _seeded(tmp_path, rel: str, old: str, new: str) -> tuple[list, set]:
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        src = f.read()
    assert src.count(old) == 1, old
    (tmp_path / "clean.py").write_text(src)
    (tmp_path / "bug.py").write_text(src.replace(old, new, 1))
    clean = pdc.run(str(tmp_path), paths=["clean.py"], hot_modules=["clean.py"])
    bug = pdc.run(str(tmp_path), paths=["bug.py"], hot_modules=["bug.py"])
    return clean, {(f.code, f.symbol) for f in bug}


def test_device_pass_catches_seeded_dead_pointer(tmp_path):
    """A pointer of a clone in the fused scan's argument block: the clone
    is freed before the launch reads it."""
    clean, got = _seeded(tmp_path, "kubernetes_tpu_torch/ops/fused_scan.py",
                         "bufs[f].data_ptr()", "bufs[f].clone().data_ptr()")
    assert clean == []
    assert ("DC601", "params.bufs") in got, got


def test_device_pass_catches_seeded_cow_bypass(tmp_path):
    """Replacing the backend's ``mutable_info(...)`` with a raw
    ``work_map.get(...)`` is caught at both mutation sites."""
    clean, got = _seeded(tmp_path, "kubernetes_tpu_torch/ops/backend.py",
                         "info = mutable_info(node_name)", "info = work_map.get(node_name)")
    assert clean == []
    symbols = {s for c, s in got if c == "DC604"}
    assert any(s.endswith("info.add_pod_counted") for s in symbols), got
    assert any(s.endswith("info.add_pod") for s in symbols), got


@pytest.mark.parametrize("needle", [
    "# device: sync — the one control read a loop run",
    "# device: sync — the per-shard alive counts",
    "# device: sync — the kept columns",
    "# device: sync — the segment's chosen buffer and counter",
    "# device: sync — the same one read of the result",
])
def test_device_pass_catches_a_removed_sync_annotation(tmp_path, needle):
    with open(os.path.join(ROOT, "kubernetes_tpu_torch/ops/frontier.py"), encoding="utf-8") as f:
        line = next(ln for ln in f if needle in ln)
    clean, got = _seeded(tmp_path, "kubernetes_tpu_torch/ops/frontier.py", line, "")
    assert clean == []
    assert [c for c, _ in got] == ["DC602"], got


def test_sanctioned_sync_sites_counts():
    """The static budget the runtime check leans on: every live
    annotation of the frontier loop is counted under its function; an
    invalid annotation never counts."""
    sites = pdc.sanctioned_sync_sites(ROOT)
    fr = sites["kubernetes_tpu_torch/ops/frontier.py"]
    assert fr == {"FrontierRun._sync_loop": 2, "FrontierRun._compact": 1,
                  "FrontierRun.finalize": 2, "FrontierRun._maybe_compact": 1,
                  "FrontierRun._finalize_chunks": 2}
    assert sites["kubernetes_tpu_torch/ops/fused_scan.py"] == {"finalize": 1}
    assert pdc.sanctioned_sync_sites(ROOT, paths=[DC_PATH])[DC_PATH] == {"FixtureLoop.sync_ok": 1}


def test_host_sync_budget_matches_static_sanction_count():
    """The CPU twin of ``tests/test_frontier.py``'s runtime cross-check,
    through the port's ``FrontierRun`` on ``device="cpu"``: the sites the
    pass sanctions bound the loop's ``host_syncs``."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.ops.frontier import FrontierRun

    M = cases.mods(cases.PORT)
    m = {}
    for i in range(16):
        node = M.tu.make_node(f"node-{i:03d}", cpu="64", memory="64Gi", pods=2 + i // 2,
                              labels={cases.HOST: f"node-{i:03d}", cases.ZONE: "zone-0"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi", labels={"app": "web"})
            for i in range(110)]
    pctx = M.PriorityContext(m)
    tz = M.snapshot.Tensorizer()
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods)
    M.snapshot.frontier_seed(static, init)
    run = FrontierRun(*from_reference(vars(static), vars(init), "cpu"), chunk_len=16, min_width=8)
    run.finalize()
    assert run.stats["compactions"] >= 1
    sites = pdc.sanctioned_sync_sites(ROOT)["kubernetes_tpu_torch/ops/frontier.py"]
    budget = (sites["FrontierRun._sync_loop"] * run.stats["loop_runs"]
              + sites["FrontierRun.finalize"])
    assert run.stats["host_syncs"] <= budget, (run.stats, sites)
    # the chunked host loop on the same segment: a read between chunks
    # and a result read a chunk, within the sites of its two functions
    host = FrontierRun(*from_reference(vars(static), vars(init), "cpu"), chunk_len=16,
                       min_width=8, device_loop=False)
    host.finalize()
    chunks = host.stats["chunks"]
    budget = (sites["FrontierRun._maybe_compact"] * (chunks - 1)
              + sites["FrontierRun._finalize_chunks"] * chunks)
    assert host.stats["compactions"] >= 1
    assert host.stats["host_syncs"] == 2 * chunks - 1 <= budget, (host.stats, sites)


def test_tracecov_scope_mismatch_fails_loud():
    report = run_analysis(root=ROOT, passes=["tracecov"], scopes={"tracecov": {
        "paths": [f"{FIXTURES}/fixture_tracecov.py"],
        "hot_modules": ["kubernetes_tpu_torch/ops/renamed_away.py"], "phase_files": []}})
    got = {(f.code, f.path, f.symbol) for f in report.findings}
    assert ("TC500", "kubernetes_tpu_torch/ops/renamed_away.py", "<scope>") in got, got


# -- 6. the scopes --------------------------------------------------------------

_SCOPE_LISTS = {
    "races": ["DEFAULT_PATHS"], "concurrency_hazards": ["DEFAULT_PATHS"],
    "metrics_lint": ["DEFAULT_PATHS"], "trace_safety": ["DEFAULT_PATHS"],
    "device_contracts": ["DEFAULT_PATHS"],
    "tracecov": ["DEFAULT_PATHS", "HOT_PATH_MODULES", "PHASE_FILES"],
    "parity": ["DEFAULT_ORACLE_PATHS", "DEFAULT_KERNEL_PATHS"],
}


def _table() -> dict[str, list[str]]:
    """The scope table of ``core.py``'s docstring: reference path ->
    the port's paths."""
    out = {}
    for line in pcore.__doc__.splitlines():
        m = re.match(r"^\s+kubernetes_tpu/(\S+)\s+->\s+(.+)$", line)
        if m:
            out[m.group(1)] = [t.strip() for t in m.group(2).split(",")]
    return out


def _covers(scope: list[str], path: str) -> bool:
    return any(path == s or path.startswith(s.rstrip("/") + "/") for s in scope)


@pytest.mark.parametrize("mod, name", [(m, n) for m, ns in _SCOPE_LISTS.items() for n in ns])
def test_every_jax_scope_path_has_its_counterpart_in_scope(mod, name):
    table = _table()
    assert table.pop("<path>") == ["<path>"]
    jax_scope = getattr(_pass_module("kubernetes_tpu", mod), name)
    port_scope = getattr(_pass_module("kubernetes_tpu_torch", mod), name)
    for path in jax_scope:
        rel = path.split("/", 1)[1] if "/" in path else ""
        targets = table.get(rel, [rel])
        for t in targets:
            counterpart = f"kubernetes_tpu_torch/{t}".rstrip("/")
            assert os.path.exists(os.path.join(ROOT, counterpart)), counterpart
            assert _covers(port_scope, counterpart), (path, counterpart, port_scope)
    for p in port_scope:
        assert os.path.exists(os.path.join(ROOT, p)), p


def test_port_only_modules_join_their_layers():
    from kubernetes_tpu_torch.analysis import parity, races, tracecov

    ops = [f"kubernetes_tpu_torch/ops/{m}.py" for m in
           ("mesh_scan", "frontier_refresh", "node_cache", "preemption_kernel", "_build")]
    for scope in (tracecov.HOT_PATH_MODULES, parity.DEFAULT_KERNEL_PATHS, pdc.DEFAULT_PATHS,
                  pts.DEFAULT_PATHS):
        assert all(_covers(scope, p) for p in ops), scope
    assert "kubernetes_tpu_torch/ops/fused_scan.py" in tracecov.HOT_PATH_MODULES
    from kubernetes_tpu_torch.analysis import concurrency_hazards

    for scope in (races.DEFAULT_PATHS, concurrency_hazards.DEFAULT_PATHS):
        assert "kubernetes_tpu_torch/cluster.py" in scope


def test_the_baseline_waives_no_trace_or_device_finding():
    baseline = load_baseline(pcore.default_baseline_path())
    assert not [k for k in baseline if k[:2] in ("TS", "DC")]
    assert all(k.split(":")[1].startswith("kubernetes_tpu_torch/") for k in baseline)
