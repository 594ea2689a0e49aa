"""The tensorizer's resource-axis selection (``BatchStatic.r_sel``) in the
port, held against the JAX package's: the selection itself on every seeded
world of ``tests/torch_port_cases.py`` and on worlds whose pods request a
GPU or ephemeral storage, the device tensors' resource axis, the sticky
union across waves, the node cache's token, and bindings on a node that is
overcommitted in a slot no pod requests.

Each package builds its own copy of every world from the same spec; the
port runs on ``device="cpu"``.  Tolerance: exact equality of selections,
shapes, chosen nodes and the round-robin counter."""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from kubernetes_tpu.ops.backend import TPUBatchBackend
from kubernetes_tpu.ops.batch_kernel import DeviceNodeCache as JCache
from kubernetes_tpu.ops.batch_kernel import to_device
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import scan_ref
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.ops.node_cache import DeviceNodeCache
from tests import torch_port_cases as cases

JAX, PORT, HOST, ZONE = cases.JAX, cases.PORT, cases.HOST, cases.ZONE
FULL = [0, 1, 2, 3]


def _storage_pod(M, name, storage="1Gi", cpu="100m"):
    req = {"cpu": M.api.Quantity(cpu), "memory": M.api.Quantity("64Mi"),
           "ephemeral-storage": M.api.Quantity(storage)}
    return M.tu.make_pod(name, containers=[M.api.Container(
        name="c0", image="img", resources=M.api.ResourceRequirements(requests=req))])


def accelerated(pkg: str, wants: str = "both", seed: int = 2, n_nodes: int = 10,
                n_pods: int = 48):
    """Nodes with and without GPUs and ephemeral storage; pods that request
    cpu and memory only, and (``wants``) ``"gpu"``, ``"storage"`` or
    ``"both"`` of the other two slots.  Returns (node_info_map, pods,
    pctx)."""
    M = cases.mods(pkg)
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"node-{i:03d}", cpu=rng.choice(["4", "8"]), memory="16Gi",
                              pods=30, gpu=rng.choice([0, 2, 4]),
                              storage=rng.choice(["0", "20Gi"]),
                              labels={HOST: f"node-{i:03d}", ZONE: f"zone-{i % 2}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = []
    for i in range(n_pods):
        k = rng.randrange(3)
        if k == 1 and wants in ("gpu", "both"):
            pods.append(M.tu.make_pod(f"g-{i:03d}", cpu="200m", memory="256Mi", gpu=1,
                                      labels={"app": "train"}))
        elif k == 2 and wants in ("storage", "both"):
            pods.append(_storage_pod(M, f"s-{i:03d}", storage=rng.choice(["1Gi", "4Gi"])))
        else:
            pods.append(M.tu.make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi",
                                      labels={"app": "web"}))
    return m, pods, M.PriorityContext(m)


WORLDS = {**{name: (build, {}) for name, build in cases.CASES.items()},
          "gpu": (accelerated, {"wants": "gpu"}),
          "storage": (accelerated, {"wants": "storage"}),
          "gpu_and_storage": (accelerated, {"wants": "both"})}
WANT_SEL = {"gpu": [0, 1, 3], "storage": [0, 1, 2], "gpu_and_storage": None}


def _sel(static):
    return None if static.r_sel is None else [int(r) for r in static.r_sel]


def _tensorize(pkg, m, pods, pctx):
    """(BatchStatic, InitialState) of a batch through ``pkg``'s tensorizer."""
    tz = cases.mods(pkg).snapshot.Tensorizer()
    static = tz.build_static(pods, m, pctx)
    return static, tz.initial_state(static, m, pctx, pods)


def _static(pkg, world):
    build, kw = WORLDS[world]
    return _tensorize(pkg, *build(pkg, **kw))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_r_sel_equals_the_jax_tensorizers_and_cuts_the_device_axis(world):
    jstatic = _static(JAX, world)[0]
    static, init = _static(PORT, world)
    assert _sel(static) == _sel(jstatic) == WANT_SEL.get(world, [0, 1])
    assert static.node_alloc.shape[1] == static.g_request.shape[1] == init.requested.shape[1] == 4
    s, st = from_reference(vars(static), vars(init), "cpu")
    r = len(FULL if static.r_sel is None else static.r_sel)
    assert s.node_alloc.shape[1] == s.g_request.shape[1] == st.requested.shape[1] == r
    # the device copy is the host's r_sel columns; cpu and memory lead
    cols = FULL if static.r_sel is None else list(static.r_sel)
    np.testing.assert_array_equal(s.node_alloc.numpy(), static.node_alloc[:, cols])
    np.testing.assert_array_equal(st.requested.numpy(), init.requested[:, cols])
    assert cols[:2] == [0, 1]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_backend_binds_like_the_jax_backend_and_the_oracle(world, monkeypatch):
    """``BatchBackend(device="cpu")`` binds pod for pod with the JAX
    backend and the sequential oracle, with the same counter, and every
    segment it carries to the device has a resource axis ``len(r_sel)``
    wide."""
    build, kw = WORLDS[world]
    out = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods, pctx = build(pkg, **kw)
        oracle = M.gs.GenericScheduler()
        want = cases.oracle_batch(pkg, pods, m, pctx, oracle)
        algo = M.gs.GenericScheduler()
        backend = (TPUBatchBackend(algorithm=algo, kernel_impl="xla") if pkg == JAX
                   else BatchBackend(algorithm=algo, device="cpu"))
        widths = cases.record_resource_widths(monkeypatch) if pkg == PORT else None
        got = backend.schedule_batch(pods, m, pctx)
        assert got == want and algo._round_robin == oracle._round_robin, pkg
        out[pkg] = (got, algo._round_robin)
        if pkg == PORT:
            assert widths and all(len(w) == 1 for w in widths), widths
            assert backend.stats["oracle_pods"] == 0
    assert out[PORT] == out[JAX]


def _wave(M, kind: str, n: int = 6):
    if kind == "gpu":
        return [M.tu.make_pod(f"g{i}", cpu="100m", memory="64Mi", gpu=1) for i in range(n)]
    if kind == "storage":
        return [_storage_pod(M, f"s{i}") for i in range(n)]
    return [M.tu.make_pod(f"p{i}", cpu="100m", memory="64Mi") for i in range(n)]


WAVES = ("plain", "gpu", "plain", "storage", "plain")


@pytest.mark.parametrize("sticky", [True, False], ids=["sticky", "not_sticky"])
def test_r_sel_across_waves_only_grows_while_sticky(sticky):
    """One tensorizer a package over five waves: with ``sticky_buckets``
    (the default) the selection is the union of every wave's so far, so
    it only grows; without, each wave's own.  Equal in both packages."""
    sels = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, _, pctx = accelerated(pkg, n_pods=0)
        tz = M.snapshot.Tensorizer(sticky_buckets=sticky)
        sels[pkg] = [_sel(tz.build_static(_wave(M, kind), m, pctx)) for kind in WAVES]
    assert sels[PORT] == sels[JAX]
    if sticky:
        assert sels[PORT] == [[0, 1], [0, 1, 3], [0, 1, 3], None, None]
    else:
        assert sels[PORT] == [[0, 1], [0, 1, 3], [0, 1], [0, 1, 2], [0, 1]]


def test_two_selections_never_share_a_node_cache_entry():
    """Waves against an unchanged fleet share a node token; a wave whose
    selection differs must not reuse the cached ``node_alloc`` of another
    width.  The port's cache and the JAX cache count alike, and each hands
    out ``node_alloc`` at the wave's own width."""
    stats = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, _, pctx = accelerated(pkg, n_pods=0)
        tz = M.snapshot.Tensorizer(sticky_buckets=False)
        cache = JCache() if pkg == JAX else DeviceNodeCache("cpu")
        tokens, widths = [], []
        for kind in ("plain", "gpu", "gpu", "plain"):
            static = tz.build_static(_wave(M, kind), m, pctx)
            tokens.append(static.node_token)
            alloc = (to_device(static, node_cache=cache).node_alloc if pkg == JAX
                     else cache.node_arrays(static)[1])
            widths.append(int(np.asarray(alloc).shape[1]))
            np.testing.assert_array_equal(np.asarray(alloc),
                                          static.node_alloc[:, list(static.r_sel)])
        assert len(set(tokens)) == 1  # one fleet, one node token
        assert widths == [2, 3, 3, 2]
        stats[pkg] = {k: cache.stats[k] for k in ("reuses", "col_updates", "uploads")}
    # only the repeated gpu wave reuses; each change of selection uploads
    assert stats[PORT] == stats[JAX] == {"reuses": 1, "col_updates": 0, "uploads": 3}


def _overcommitted(pkg: str):
    """``node-000`` holds a GPU pod bound past its allocatable (no GPU at
    all) and has the most cpu, so the scores want it; the batch asks for
    cpu and memory only."""
    M = cases.mods(pkg)
    m = {}
    for i in range(6):
        node = M.tu.make_node(f"node-{i:03d}", cpu="16" if i == 0 else "4", memory="16Gi",
                              pods=30, gpu=0 if i == 0 else 1, labels={HOST: f"node-{i:03d}"})
        m[node.meta.name] = M.NodeInfo(node)
    m["node-000"].add_pod(M.tu.make_pod("squatter", cpu="100m", memory="64Mi", gpu=2,
                                        node_name="node-000"))
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu="500m", memory="256Mi") for i in range(40)]
    return m, pods, M.PriorityContext(m)


def test_a_node_overcommitted_in_an_unrequested_slot_binds_alike():
    """``node-000``'s GPU slot is overcommitted; no pod requests a GPU, so
    the fit check masks that slot out: the node takes pods in the oracle,
    in the JAX backend and in the port, and the port's scan at full width
    (``r_sel`` cleared) chooses what the sliced scan chooses."""
    out = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods, pctx = _overcommitted(pkg)
        assert m["node-000"].requested.units[3] > m["node-000"].allocatable.units[3]
        oracle = M.gs.GenericScheduler()
        want = cases.oracle_batch(pkg, pods, m, pctx, oracle)
        algo = M.gs.GenericScheduler()
        backend = (TPUBatchBackend(algorithm=algo, kernel_impl="xla") if pkg == JAX
                   else BatchBackend(algorithm=algo, device="cpu"))
        got = backend.schedule_batch(pods, m, pctx)
        assert got == want and algo._round_robin == oracle._round_robin
        assert "node-000" in got
        out[pkg] = (got, algo._round_robin)
    assert out[PORT] == out[JAX]
    static, init = _tensorize(PORT, *_overcommitted(PORT))
    assert _sel(static) == [0, 1]
    sliced, rr = scan_ref.scan(*from_reference(vars(static), vars(init), "cpu"))
    full = dataclasses.replace(static, r_sel=None)
    whole, rr_full = scan_ref.scan(*from_reference(vars(full), vars(init), "cpu"))
    np.testing.assert_array_equal(sliced.numpy(), whole.numpy())
    assert rr == rr_full and (sliced.numpy() == 0).any()

