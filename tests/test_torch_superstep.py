"""Twin of ``tests/test_pallas.py``: the fused scan's super-step loop.

With the ``PallasSuperSteps`` gate on, the JAX kernel runs K pods a loop
iteration (``k_unroll``, K from ``_superstep_k``) and the port runs the
build of ``ops/csrc/fused_scan.cu`` for that K (``fused_scan.superstep_k``,
``-DFUSED_SCAN_K=K``).  Held here:

- the port's K selection equals the JAX package's, gate off and on, for
  every ``KTPU_SUPERSTEP_K`` the JAX test reads and the clamped ends;
- on the CPU, ``test_superstep_k_parity``'s 60-pod case at K = 1, 4 and 8:
  the JAX kernel in Pallas interpret mode and the port's ``BatchBackend``
  with the gate on (``device="cpu"``: the plain scan, which is the same
  function at every K) bind the same nodes and end at the same
  round-robin counter, and the backend records the K it read;
- on a card (``cuda``-marked, skipped with a reason elsewhere): the K = 1,
  4 and 8 builds bit-identical on the same 60 pods, whole and as chunk
  launches of the frontier loop (chosen nodes, counter, cursor and the
  written-back state planes), and ``BatchBackend`` with the gate on
  launching the K build, counted in ``fused_scan.launches_k``.

``test_supports_pallas_budget_guard`` and the three fallback tests
(``test_pallas_dispatch_failure_falls_back_to_xla``,
``test_pallas_one_shot_failure_recovers_next_segment``,
``test_pallas_shape_blacklist_after_repeated_failures``) have no twin: the
port refuses no shape and has no kernel-to-plain-version ladder.  The two
XLA-scan parity tests are held by ``tests/test_torch_kernel.py`` and
``tests/test_torch_parity.py``.

JAX is imported inside the CPU tests only, so the card's tests run where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_superstep.py

Tolerance: exact equality of chosen nodes and counters."""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import fused_scan, scan_ref
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.utils.features import DEFAULT_FEATURE_GATES
from tests.torch_port_cases import JAX, PORT, ZONE, mods

ENV = "KTPU_SUPERSTEP_K"


def _mixed_problem(pkg: str, seed: int = 7, n_nodes: int = 8, n_pods: int = 60):
    """``tests/test_pallas.py``'s ``_mixed_problem`` built with package
    ``pkg``'s own API: (node_info_map, pods, pctx)."""
    M = mods(pkg)
    api, tu = M.api, M.tu
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = tu.make_node(f"n{i:02d}", cpu=rng.choice(["4", "8"]), memory="16Gi",
                            labels={"kubernetes.io/hostname": f"n{i:02d}", ZONE: f"z{i % 2}"})
        m[node.meta.name] = M.NodeInfo(node)
    sel = api.LabelSelector.from_match_labels
    soft = api.Affinity(pod_affinity_preferred=[api.WeightedPodAffinityTerm(
        weight=10, term=api.PodAffinityTerm(selector=sel({"app": "web"}), topology_key=ZONE))])
    anti = api.Affinity(pod_anti_affinity_required=[api.PodAffinityTerm(
        selector=sel({"app": "lone"}), topology_key="kubernetes.io/hostname")])
    pods = []
    for i in range(n_pods):
        r = rng.random()
        if r < 0.15:
            pods.append(tu.make_pod(f"a{i:03d}", cpu="100m", labels={"app": "web"}, affinity=soft))
        elif r < 0.3:
            pods.append(tu.make_pod(f"b{i:03d}", cpu="100m", labels={"app": "lone"},
                                    affinity=anti))
        elif r < 0.45:
            pods.append(tu.make_pod(f"c{i:03d}", cpu="100m", volumes=[api.Volume(
                name="v", disk_id=f"d{rng.randrange(10)}",
                disk_kind=rng.choice(["gce-pd", "aws-ebs"]), read_only=rng.random() < 0.3)]))
        else:
            pods.append(tu.make_pod(f"d{i:03d}", cpu="200m", memory="256Mi",
                                    labels={"app": "web"}))
    svcs = [api.Service(meta=api.ObjectMeta(name="web"), selector={"app": "web"})]
    return m, pods, M.PriorityContext(m, services=svcs)


def _set_env(monkeypatch, value) -> None:
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)


@pytest.mark.parametrize("value", [None, "1", "3", "4", "8", "200"])
@pytest.mark.parametrize("gate", [False, True])
def test_superstep_k_matches_the_jax_selection(gate, value, monkeypatch):
    pk = importlib.import_module(f"{JAX}.ops.pallas_kernel")
    jax_gates = importlib.import_module(f"{JAX}.utils.features").DEFAULT_FEATURE_GATES
    _set_env(monkeypatch, value)
    with jax_gates.override("PallasSuperSteps", gate), \
            DEFAULT_FEATURE_GATES.override("PallasSuperSteps", gate):
        want = pk._superstep_k()
        assert fused_scan.superstep_k() == want
    # on: the default 8, or the value clamped to 1..128 and rounded down to a power of two
    assert want == (1 if not gate else {None: 8, "1": 1, "3": 2, "4": 4, "8": 8, "200": 128}[value])


def test_gate_is_off_by_default():
    assert not DEFAULT_FEATURE_GATES.enabled("PallasSuperSteps")
    assert fused_scan.superstep_k() == 1
    assert fused_scan.defines(1) == () and fused_scan.defines(8) == ("FUSED_SCAN_K=8",)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The JAX kernel in Pallas interpret mode, as ``tests/test_pallas.py``
    runs it on the CPU."""
    from jax.experimental import pallas as pl

    pk = importlib.import_module(f"{JAX}.ops.pallas_kernel")
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    pk._pallas_runner.cache_clear()
    yield pk
    pk._pallas_runner.cache_clear()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("k", [1, 4, 8])
def test_superstep_parity_with_the_jax_kernel(k, interpret_pallas, monkeypatch):
    """``test_superstep_k_parity``'s case (60 pods: K = 8 leaves 4 inert
    tail sub-steps) at one K through both packages."""
    pk = interpret_pallas
    jax_gates = importlib.import_module(f"{JAX}.utils.features").DEFAULT_FEATURE_GATES
    monkeypatch.setenv(ENV, str(k))
    backend = BatchBackend(device="cpu")
    # the JAX segment at the backend's weights (the default scheduler's)
    w = backend._config_supported()
    m, pods, pctx = _mixed_problem(JAX)
    tz = mods(JAX).snapshot.Tensorizer(pad_multiple=128)
    static = tz.build_static(
        pods, m, pctx, least_requested_weight=w["least"], most_requested_weight=w["most"],
        balanced_weight=w["balanced"], spread_weight=w["spread"],
        node_affinity_weight=w["node_affinity"], taint_weight=w["taint"],
        prefer_avoid_weight=w["prefer_avoid"], image_weight=w["image"],
        interpod_weight=w["interpod"])
    with jax_gates.override("PallasSuperSteps", True):
        assert pk._superstep_k() == k
        chosen, rr = pk.schedule_batch_pallas(static, tz.initial_state(static, m, pctx, pods))
    want = [static.node_names[j] if j >= 0 else None for j in np.asarray(chosen)]

    pm, ppods, ppctx = _mixed_problem(PORT)
    with DEFAULT_FEATURE_GATES.override("PallasSuperSteps", True):
        got = backend.schedule_batch(ppods, pm, ppctx)
    assert backend.stats["superstep_k"] == k  # the backend read the gate
    assert backend.stats["kernel_pods"] == len(ppods) and backend.stats["oracle_pods"] == 0
    assert got == want
    assert backend.algorithm._round_robin == rr


def test_backend_records_k_one_with_the_gate_off():
    m, pods, pctx = _mixed_problem(PORT, n_pods=20)
    backend = BatchBackend(device="cpu")
    backend.schedule_batch(pods, m, pctx)
    assert backend.stats["superstep_k"] == 1


# ---- on the card ---------------------------------------------------------

def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused scan is a CUDA kernel with no CPU mode")


def _at_k(k: int, monkeypatch, fn):
    monkeypatch.setenv(ENV, str(k))
    with DEFAULT_FEATURE_GATES.override("PallasSuperSteps", k > 1):
        assert fused_scan.superstep_k() == k
        return fn()


def _segment(device: str):
    m, pods, pctx = _mixed_problem(PORT)
    tz = mods(PORT).snapshot.Tensorizer(pad_multiple=128)
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods)
    return from_reference(vars(static), vars(init), device)


@pytest.mark.cuda
def test_k_builds_are_bit_identical_on_card(monkeypatch):
    _on_card()
    s, st = _segment("cuda")
    want, rr_want = scan_ref.scan(s, st)
    for k in (1, 4, 8):
        before = fused_scan.launches_k.get(k, 0)
        got, rr = _at_k(k, monkeypatch, lambda: fused_scan.schedule(s, st))
        assert fused_scan.launches_k[k] == before + 1
        assert rr == rr_want, f"rr at K={k}"
        np.testing.assert_array_equal(got, want.cpu().numpy(), err_msg=f"K={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [7, 16])
def test_k_builds_are_bit_identical_as_chunk_launches(chunk, monkeypatch):
    """The frontier loop's chunk launches (counter, stop flag and cursor in
    the control words, state written back) at each K: 60 pods in chunks of
    7 leave a tail in every chunk at K = 4 and 8."""
    _on_card()
    s, st = _segment("cuda")
    keys = ("chosen", "req", "nz", "cnt", "ports", "spread", "dm", "downer", "total", "volf",
            "nk")
    outs = {}
    for k in (1, 4, 8):
        pl = fused_scan.plan(s)
        bufs = fused_scan.pack(s, st, pl)
        ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=s.device)
        ctl[fused_scan.CTL_RR] = st.round_robin
        for first in range(0, s.p_real, chunk):
            _at_k(k, monkeypatch, lambda: fused_scan.launch(
                s, st, bufs, pl, start=first, count=min(chunk, s.p_real - first), ctl=ctl))
        torch.cuda.synchronize()
        outs[k] = ({key: bufs[key].cpu() for key in keys}, ctl.cpu())
    assert int(outs[1][1][fused_scan.CTL_CURSOR]) == -(-s.p_real // chunk)
    for k in (4, 8):
        assert torch.equal(outs[k][1], outs[1][1]), f"control words at K={k}"
        for key in keys:
            assert torch.equal(outs[k][0][key], outs[1][0][key]), f"{key} at K={k}"


@pytest.mark.cuda
def test_backend_launches_the_k_build_on_card(monkeypatch):
    _on_card()
    m, pods, pctx = _mixed_problem(PORT)
    want = BatchBackend(device="cuda").schedule_batch(pods, m, pctx)
    backend = BatchBackend(device="cuda")
    before = fused_scan.launches_k.get(8, 0)
    got = _at_k(8, monkeypatch, lambda: backend.schedule_batch(pods, m, pctx))
    assert backend.stats["superstep_k"] == 8
    assert fused_scan.launches_k[8] > before
    assert got == want
