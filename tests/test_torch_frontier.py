"""The frontier scan of the port (``models/snapshot.py`` prefilter,
``ops/frontier.py`` loop and compaction, ``ops/scan_ref.py`` refresh, the
backend's route): twins of ``tests/test_frontier.py``.

Every twin feeds one seeded cluster, built by each package from the same
spec, to the JAX package (``FrontierRun(device_loop=True)`` or
``TPUBatchBackend``, on the CPU) and to the port on ``device="cpu"``.
Chosen nodes, the round-robin counter, the compaction trajectory
(``widths``, ``compactions``, ``alive_frac``, ``chunks``) and ``host_syncs``
must be equal, and equal to the sequential oracle.  The four JAX fault
tests become tests that ``backend.compact`` raises in the port (no
full-width retry), the scheduler requeues the drained pods, and the next
wave binds them as the oracle does.

Tolerance: exact equality everywhere."""

from __future__ import annotations

import random

import numpy as np
import pytest

from kubernetes_tpu.models import snapshot as jsnap
from kubernetes_tpu.ops import TPUBatchBackend
from kubernetes_tpu.ops.batch_kernel import FrontierRun as JFrontierRun
from kubernetes_tpu.ops.batch_kernel import (monotone_plane_device, schedule_batch_arrays,
                                             state_to_device, to_device)
from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan
from kubernetes_tpu_torch.models import snapshot as psnap
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import scan_ref
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.ops.frontier import FrontierRun
from tests import torch_port_cases as cases

JAX, PORT, HOST, ZONE = cases.JAX, cases.PORT, cases.HOST, cases.ZONE
STAT_KEYS = ("widths", "compactions", "alive_frac", "chunks", "host_syncs", "loop_runs")
ENTRY_KEYS = ("prefilter", "widths", "compactions", "alive_frac", "chunks", "mode", "host_syncs")
BACKEND_KEYS = ("frontier_segments", "frontier_compactions", "frontier_prefilter_cols",
                "host_syncs", "kernel_pods", "oracle_pods")


# -- clusters, each package building its own from one spec --------------------

def _add(M, m, name, **kw):
    node = M.tu.make_node(name, **kw)
    m[node.meta.name] = M.NodeInfo(node)


def tiny_cluster(pkg, n_small=8, n_big=8, small_cpu="1", big_cpu="64"):
    """Small nodes saturate fast (columns die mid-segment); big nodes are
    identical (scores tie, so the round-robin counter is live)."""
    M, m = cases.mods(pkg), {}
    for i in range(n_small):
        _add(M, m, f"small-{i:03d}", cpu=small_cpu, memory="64Gi", pods=110,
             labels={HOST: f"small-{i:03d}", ZONE: f"zone-{i % 2}"})
    for i in range(n_big):
        _add(M, m, f"zbig-{i:03d}", cpu=big_cpu, memory="64Gi", pods=110,
             labels={HOST: f"zbig-{i:03d}", ZONE: f"zone-{i % 2}"})
    return m


def tie_cluster(pkg, n=16, pinned=False):
    """Identical nodes on every score input with staggered pod caps (2, 2,
    3, 3, ...): columns die one after another while ties stay live;
    ``pinned`` adds one ssd node for selector-pinned pods."""
    M, m = cases.mods(pkg), {}
    for i in range(n):
        _add(M, m, f"node-{i:03d}", cpu="64", memory="64Gi", pods=2 + i // 2,
             labels={HOST: f"node-{i:03d}", ZONE: "zone-0"})
    if pinned:
        _add(M, m, "zz-pinned", cpu="32", memory="64Gi", pods=110,
             labels={HOST: "zz-pinned", "disk": "ssd"})
    return m


def web_pods(pkg, n, cpu="100m", memory="128Mi", prefix="p"):
    M = cases.mods(pkg)
    return [M.tu.make_pod(f"{prefix}-{i:03d}", cpu=cpu, memory=memory, labels={"app": "web"})
            for i in range(n)]


def pinned_pods(pkg, n=80):
    """Every fifth pod pinned to the ssd node (the n_feasible == 1 path)."""
    M = cases.mods(pkg)
    out = []
    for i in range(n):
        if i % 5 == 0:
            out.append(M.tu.make_pod(f"pin-{i:03d}", cpu="100m", memory="64Mi",
                                     labels={"app": "db"}, node_selector={"disk": "ssd"}))
        else:
            out.append(M.tu.make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi",
                                     labels={"app": "web"}))
    return out


def random_world(pkg, seed, taints=True, n_range=(12, 28), p_range=(60, 140)):
    """Random mixed clusters: taints, zones, saturation."""
    M = cases.mods(pkg)
    rng = random.Random(seed)
    m = {}
    for i in range(rng.randrange(*n_range)):
        labels = {HOST: f"node-{i:03d}", ZONE: f"zone-{i % 3}"}
        tl = []
        if taints and rng.random() < 0.2:
            tl.append(M.api.Taint(key="dedicated", value="x", effect="NoSchedule"))
        _add(M, m, f"node-{i:03d}", cpu=rng.choice(["1", "2", "8"]),
             memory=rng.choice(["4Gi", "16Gi"]), pods=20, labels=labels, taints=tl)
    templates = [dict(cpu="500m", memory="128Mi", labels={"app": "web"}),
                 dict(cpu="1", memory="256Mi", labels={"app": "db"})]
    if taints:
        templates.append(dict(cpu="250m", memory="128Mi", labels={"app": "batch"},
                              tolerations=[M.api.Toleration(key="dedicated",
                                                            operator="Exists")]))
    pods = [M.tu.make_pod(f"p-{i:04d}", **rng.choice(templates))
            for i in range(rng.randrange(*p_range))]
    return m, pods


# -- the two packages side by side --------------------------------------------

def backend_parity(build, backend_kwargs=None, entry_keys=ENTRY_KEYS, backend_keys=BACKEND_KEYS):
    """``build(pkg) -> (node_info_map, pods)``: the JAX backend, the port's
    on the CPU and the oracle on the same cluster; ``entry_keys`` and
    ``backend_keys`` name the ``last_frontier`` and ``stats`` entries held
    equal.  Returns the port backend."""
    kw = backend_kwargs or {}
    out = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods = build(pkg)
        pctx = M.PriorityContext(m)
        oracle = M.gs.GenericScheduler()
        want = cases.oracle_batch(pkg, pods, m, pctx, oracle)
        algo = M.gs.GenericScheduler()
        backend = (TPUBatchBackend(algorithm=algo, **kw) if pkg == JAX
                   else BatchBackend(algorithm=algo, device="cpu", **kw))
        got = backend.schedule_batch(pods, m, pctx)
        assert got == want, f"{pkg}: {sum(a != b for a, b in zip(got, want))} mismatches"
        assert algo._round_robin == oracle._round_robin, f"{pkg}: tie-break counter diverged"
        out[pkg] = (got, algo._round_robin, backend)
    (jgot, jrr, jb), (pgot, prr, pb) = out[JAX], out[PORT]
    assert pgot == jgot and prr == jrr
    assert jb.stats["frontier_fallbacks"] == 0
    for k in backend_keys:
        assert pb.stats[k] == jb.stats[k], (k, pb.stats[k], jb.stats[k])
    assert [{k: e[k] for k in entry_keys} for e in pb.last_frontier] == \
        [{k: e[k] for k in entry_keys} for e in jb.last_frontier]
    return pb


def seeded_segment(m, pods, pkg=JAX):
    """A segment of ``pkg``'s tensorizer, its still_ok seeded."""
    M = cases.mods(pkg)
    pctx = M.PriorityContext(m)
    tz = M.snapshot.Tensorizer()
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods)
    M.snapshot.frontier_seed(static, init)
    return static, init


def run_parity(static, init, **kw):
    """The JAX package's device-loop FrontierRun, the port's and the plain
    full-width scan on the very same arrays."""
    jrun = JFrontierRun(static, init, device_loop=True, **kw)
    j_chosen, j_rr = jrun.finalize()
    s, st = from_reference(vars(static), vars(init), "cpu")
    prun = FrontierRun(s, st, **kw)
    p_chosen, p_rr = prun.finalize()
    plain, plain_rr = scan_ref.scan(s, st)
    np.testing.assert_array_equal(p_chosen, j_chosen)
    np.testing.assert_array_equal(p_chosen, plain.numpy())
    assert p_rr == j_rr == plain_rr
    for k in STAT_KEYS:
        assert prun.stats[k] == jrun.stats[k], (k, prun.stats[k], jrun.stats[k])
    # the host-sync budget: one read a loop run and one result read
    assert prun.stats["host_syncs"] == prun.stats["loop_runs"] + 1
    assert prun.stats["loop_runs"] >= prun.stats["compactions"] + 1
    return prun


# -- leg 1: the tensorize-time prefilter ---------------------------------------

def _seed_world(pkg):
    M = cases.mods(pkg)
    rng = random.Random(3)
    m = tiny_cluster(pkg, n_small=5, n_big=3)
    m["zbig-000"].add_pod(M.tu.make_pod("full-0", cpu="63", memory="1Gi", node_name="zbig-000"))
    m["small-001"].add_pod(M.tu.make_pod("taken", cpu="100m", host_ports=[8080],
                                         node_name="small-001"))
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu=rng.choice(["500m", "2"]), memory="128Mi",
                          labels={"app": "web"}, host_ports=[8080] if i % 3 == 0 else None)
            for i in range(12)]
    return m, pods


def test_frontier_seed_matches_bruteforce():
    """The port's seed plane equals the JAX package's and the conjunction of
    the monotone step-0 filters computed per (signature, column)."""
    planes = {}
    for pkg in (JAX, PORT):
        m, pods = _seed_world(pkg)
        static, init = seeded_segment(m, pods, pkg)
        planes[pkg] = (static, init)
    static, init = planes[PORT]
    for g in range(static.static_ok.shape[0]):
        req = static.g_request[g]
        for j in range(len(static.node_names)):
            fit = all(init.requested[j, r] + req[r] <= static.node_alloc[j, r]
                      for r in range(len(req)) if req[r] > 0)
            pods_ok = init.pod_count[j] + 1 <= static.node_alloc_pods[j]
            ports_ok = not (init.ports_used[j] & static.g_ports[g]).any()
            want = bool(static.static_ok[g, j] and fit and pods_ok and ports_ok)
            assert bool(init.still_ok[g, j]) == want, (g, j)
    np.testing.assert_array_equal(init.still_ok, planes[JAX][1].still_ok)


def test_prefilter_compaction_is_inert():
    """Compacting away the dead columns changes nothing: the port's
    compacted segment equals the JAX package's array for array, and its
    plain scan reproduces the full-width scan through the kept names."""
    segs = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m = tiny_cluster(pkg, n_small=6, n_big=4)
        for i in range(6):
            m[f"small-{i:03d}"].add_pod(M.tu.make_pod(f"hog-{i}", cpu="1",
                                                      node_name=f"small-{i:03d}"))
        static, init = seeded_segment(m, web_pods(pkg, 20, cpu="2"), pkg)
        alive = M.snapshot.frontier_seed(static, init)
        js = np.nonzero(alive)[0]
        assert 0 < len(js) < len(static.node_names)
        cstatic, cinit = M.snapshot.compact_segment(static, init, js, width=8)
        assert cstatic.node_token is None
        segs[pkg] = (static, init, cstatic, cinit)
    static, init, cstatic, cinit = segs[PORT]
    jc, jci = segs[JAX][2], segs[JAX][3]
    assert cstatic.node_names == jc.node_names
    for f in psnap._STATIC_NODE_FIELDS:
        np.testing.assert_array_equal(getattr(cstatic, f), getattr(jc, f), err_msg=f)
    for f in psnap._INIT_NODE_FIELDS:
        np.testing.assert_array_equal(getattr(cinit, f), getattr(jci, f), err_msg=f)
    full, full_rr = scan_ref.scan(*from_reference(vars(static), vars(init), "cpu"))
    comp, comp_rr = scan_ref.scan(*from_reference(vars(cstatic), vars(cinit), "cpu"))
    assert [static.node_names[i] if i >= 0 else None for i in full.tolist()] == \
        [cstatic.node_names[i] if i >= 0 else None for i in comp.tolist()]
    assert full_rr == comp_rr
    j_chosen, j_rr = schedule_batch_arrays(jc, jci)
    np.testing.assert_array_equal(comp.numpy(), j_chosen)
    assert comp_rr == j_rr


# -- legs 2+3: the still_ok carry and mid-segment compaction -------------------

def test_monotone_mask_never_resurrects():
    """The per-step still_ok update (``scan_range(still_ok_steps=True)``,
    the JAX package's chunked host loop's only update) gives, chunk after
    chunk, the JAX host loop's alive masks exactly; the union never grows
    back; the run stays exact."""
    rng = random.Random(11)
    cpus = [rng.choice(["500m", "1"]) for _ in range(120)]
    m = tiny_cluster(JAX, n_small=10, n_big=4, small_cpu="2")
    M = cases.mods(JAX)
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu=c, memory="128Mi", labels={"app": "web"})
            for i, c in enumerate(cpus)]
    static, init = seeded_segment(m, pods)
    masks = []

    class Recorder(JFrontierRun):
        def _maybe_compact(self):
            import jax.numpy as jnp
            masks.append(np.asarray(jnp.any(self._state.still_ok, axis=0) & self._dev.node_exists))

    run = Recorder(static, init, chunk_len=16, compact_frac=0.0, min_width=8)
    run.finalize()
    s, st0 = from_reference(vars(static), vars(init), "cpu")
    st, ours, chosen = st0, [], []
    for first in range(0, s.p_real, 16):
        if first:
            ours.append(scan_ref.alive_of(st.still_ok, s.node_exists)[0].numpy())
        c, st = scan_ref.scan_range(s, st, first, min(first + 16, s.p_real), still_ok_steps=True)
        chosen.append(c)
    assert len(ours) == len(masks) >= 3
    for mine, theirs in zip(ours, masks):
        np.testing.assert_array_equal(mine, theirs)
    for prev, cur in zip(ours, ours[1:]):
        assert not (cur & ~prev).any(), "a dead column came back alive"
    plain, plain_rr = scan_ref.scan(s, st0)
    np.testing.assert_array_equal(np.concatenate([c.numpy() for c in chosen]), plain.numpy())
    assert st.round_robin == plain_rr


def test_per_step_update_is_implied_by_the_refresh():
    """Why the fused kernel has no per-step still_ok update: after every
    chunk-end refresh the plane is the same with and without the per-step
    updates (each monotone component only gets worse as the carry grows,
    and the step never reads the plane)."""
    worlds = [(tie_cluster(PORT), web_pods(PORT, 110)),
              (tiny_cluster(PORT, n_small=10, n_big=4, small_cpu="2"), web_pods(PORT, 120)),
              random_world(PORT, 101), random_world(PORT, 502, taints=False)]
    m, pods, pctx = cases.mixed(PORT, n_nodes=12, n_pods=90)
    worlds.append((m, pods))
    for m, pods in worlds:
        static, init = seeded_segment(m, pods, PORT)
        s, st = from_reference(vars(static), vars(init), "cpu")
        a = b = st
        for first in range(0, s.p_real, 16):
            last = min(first + 16, s.p_real)
            ca, a = scan_ref.scan_range(s, a, first, last, still_ok_steps=True)
            cb, b = scan_ref.scan_range(s, b, first, last)
            assert np.array_equal(ca.numpy(), cb.numpy()) and a.round_robin == b.round_robin
            a, *_ = scan_ref.refresh(s, a, -1)
            b, *_ = scan_ref.refresh(s, b, -1)
            np.testing.assert_array_equal(a.still_ok.numpy(), b.still_ok.numpy())


def test_forced_tie_and_compaction_roundrobin_parity():
    pb = backend_parity(lambda pkg: (tie_cluster(pkg), web_pods(pkg, 110)),
                        dict(frontier_chunk=16, frontier_min_width=8))
    assert pb.stats["frontier_segments"] >= 1
    assert pb.stats["frontier_compactions"] >= 1, pb.last_frontier


def test_n_feasible_one_fast_path_survives_compaction():
    pb = backend_parity(lambda pkg: (tie_cluster(pkg, pinned=True), pinned_pods(pkg)),
                        dict(frontier_chunk=16, frontier_min_width=8))
    assert pb.stats["frontier_compactions"] >= 1


@pytest.mark.parametrize("seed", range(4))
def test_randomized_frontier_parity_with_aggressive_compaction(seed):
    backend_parity(lambda pkg: random_world(pkg, 100 + seed),
                   dict(frontier_chunk=16, frontier_min_width=8, frontier_compact_frac=0.9))


# -- the device-resident loop ---------------------------------------------------

def test_device_loop_equivalence_forced_tie():
    static, init = seeded_segment(tie_cluster(JAX), web_pods(JAX, 110))
    run = run_parity(static, init, chunk_len=16, min_width=8)
    assert run.stats["compactions"] >= 1
    # O(compactions + 1) reads, not O(chunks)
    assert run.stats["host_syncs"] < run.stats["chunks"]


def test_host_sync_budget_matches_the_jax_loop():
    """The port's host syncs equal the JAX loop's, one a loop run plus the
    result read, on a multi-compaction segment."""
    static, init = seeded_segment(tie_cluster(JAX), web_pods(JAX, 110))
    run = run_parity(static, init, chunk_len=16, min_width=8)
    assert run.stats["compactions"] >= 2
    assert run.stats["host_syncs"] == run.stats["compactions"] + 2


def test_device_loop_equivalence_n_feasible_one():
    static, init = seeded_segment(tie_cluster(JAX, pinned=True), pinned_pods(JAX))
    run = run_parity(static, init, chunk_len=16, min_width=8)
    assert run.stats["compactions"] >= 1


@pytest.mark.parametrize("seed", range(2))
def test_device_loop_equivalence_randomized(seed):
    m, pods = random_world(JAX, 500 + seed, taints=False, n_range=(12, 24), p_range=(60, 120))
    static, init = seeded_segment(m, pods)
    run_parity(static, init, chunk_len=16, min_width=8, compact_frac=0.9)


def test_device_loop_backend_parity_and_sync_stats():
    pb = backend_parity(lambda pkg: (tie_cluster(pkg), web_pods(pkg, 110)),
                        dict(frontier_chunk=16, frontier_min_width=8))
    seg = pb.last_frontier[0]
    assert seg["mode"] == "loop"
    assert seg["host_syncs"] <= seg["compactions"] + 2
    assert pb.stats["host_syncs"] >= seg["host_syncs"]


# -- the chunked host loop --------------------------------------------------------

def host_loop_parity(static, init, **kw):
    """The twin of the JAX ``_loop_vs_chunked``: the port's host loop, its
    device loop and plain scan, and the JAX host loop, on the very same
    arrays, agree on every chosen node and the counter.  The host loop pays
    the JAX host loop's syncs; its refresh after each chunk gives it the
    device loop's compactions."""
    jhost = JFrontierRun(static, init, device_loop=False, **kw)
    j_chosen, j_rr = jhost.finalize()
    s, st = from_reference(vars(static), vars(init), "cpu")
    host = FrontierRun(s, st, device_loop=False, **kw)
    h_chosen, h_rr = host.finalize()
    loop = FrontierRun(s, st, **kw)
    l_chosen, l_rr = loop.finalize()
    plain, plain_rr = scan_ref.scan(s, st)
    for other in (j_chosen, l_chosen, plain.numpy()):
        np.testing.assert_array_equal(h_chosen, other)
    assert h_rr == j_rr == l_rr == plain_rr
    assert host.stats["chunks"] == jhost.stats["chunks"] == loop.stats["chunks"]
    # a read of the alive count between chunks, and a result read a chunk
    assert host.stats["host_syncs"] == jhost.stats["host_syncs"] == 2 * host.stats["chunks"] - 1
    assert host.stats["loop_runs"] == 0 and len(host.stats["alive_frac"]) == host.stats["chunks"] - 1
    assert (host.stats["widths"], host.stats["compactions"]) == \
        (loop.stats["widths"], loop.stats["compactions"])
    assert host.stats["host_syncs"] > loop.stats["host_syncs"]
    return host


HOST_LOOP_WORLDS = {
    "forced_tie": (lambda: (tie_cluster(JAX), web_pods(JAX, 110)), {}),
    "n_feasible_one": (lambda: (tie_cluster(JAX, pinned=True), pinned_pods(JAX)), {}),
    "randomized_0": (lambda: random_world(JAX, 500, taints=False, n_range=(12, 24),
                                          p_range=(60, 120)), dict(compact_frac=0.9)),
    "randomized_1": (lambda: random_world(JAX, 501, taints=False, n_range=(12, 24),
                                          p_range=(60, 120)), dict(compact_frac=0.9)),
}


@pytest.mark.parametrize("world", sorted(HOST_LOOP_WORLDS))
def test_host_loop_equivalence(world):
    build, kw = HOST_LOOP_WORLDS[world]
    static, init = seeded_segment(*build())
    run = host_loop_parity(static, init, chunk_len=16, min_width=8, **kw)
    assert run.stats["compactions"] >= 1


def test_host_loop_takes_a_chunk_that_is_not_a_power_of_two():
    """chunk_len 12: the host loop's chunk is the one given (the device
    loop refuses it), and every equality but the device loop's holds."""
    static, init = seeded_segment(tie_cluster(JAX, pinned=True), pinned_pods(JAX))
    jhost = JFrontierRun(static, init, device_loop=False, chunk_len=12, min_width=8)
    j_chosen, j_rr = jhost.finalize()
    s, st = from_reference(vars(static), vars(init), "cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        FrontierRun(s, st, chunk_len=12, min_width=8)
    host = FrontierRun(s, st, device_loop=False, chunk_len=12, min_width=8)
    h_chosen, h_rr = host.finalize()
    np.testing.assert_array_equal(h_chosen, j_chosen)
    np.testing.assert_array_equal(h_chosen, scan_ref.scan(s, st)[0].numpy())
    assert h_rr == j_rr
    assert host.stats["chunks"] == jhost.stats["chunks"] == -(-len(static.group_of_pod) // 12)
    assert host.stats["host_syncs"] == jhost.stats["host_syncs"]
    assert host.stats["compactions"] >= 1


HOST_LOOP_ENTRY_KEYS = ("prefilter", "chunks", "mode", "host_syncs")
HOST_LOOP_BACKEND_KEYS = ("frontier_segments", "frontier_prefilter_cols", "host_syncs",
                          "kernel_pods", "oracle_pods")


def roomy_tie_world(pkg, n_nodes=48, n_roomy=4, n_pods=1000):
    """``tie_cluster`` (caps 2, 2, 3, 3, ...) and ``n_roomy`` nodes of 110
    pods, alike on every score input: columns die one after another under
    live ties while the roomy nodes keep the pool from emptying."""
    M, m = cases.mods(pkg), tie_cluster(pkg, n=n_nodes)
    for i in range(n_roomy):
        _add(M, m, f"roomy-{i:03d}", cpu="64", memory="64Gi", pods=110,
             labels={HOST: f"roomy-{i:03d}", ZONE: "zone-0"})
    return m, web_pods(pkg, n_pods)


@pytest.mark.parametrize("kw", [dict(frontier_device_loop=False, frontier_chunk=16),
                                dict(frontier_chunk=384)], ids=["device_loop_off", "chunk_384"])
def test_host_loop_backend_binds_like_the_jax_backend(kw):
    """A backend built with ``frontier_device_loop=False`` or a chunk that
    is not a power of two takes the host loop in both packages (mode
    ``chunked``) and binds pod for pod like the JAX backend built the same
    way, with its host syncs."""
    if kw["frontier_chunk"] == 16:
        def build(pkg):
            return roomy_tie_world(pkg, n_nodes=16, n_roomy=2, n_pods=110)
    else:
        build = roomy_tie_world
    pb = backend_parity(build, dict(frontier_min_width=8, **kw),
                        entry_keys=HOST_LOOP_ENTRY_KEYS, backend_keys=HOST_LOOP_BACKEND_KEYS)
    seg = pb.last_frontier[0]
    assert seg["mode"] == "chunked" and seg["chunks"] >= 2
    assert seg["host_syncs"] == 2 * seg["chunks"] - 1
    assert pb.stats["frontier_compactions"] >= 1
    with pytest.raises(ValueError, match="positive"):
        BatchBackend(device="cpu", **dict(kw, frontier_chunk=0))


def test_host_loop_chunk_failure_raises(monkeypatch):
    """A chunk that fails raises out of the segment: the port has no
    fallback, so nothing reruns it on another route (the JAX test
    ``test_loop_fault_at_dispatch_degrades_to_chunked_host`` has no twin),
    and the cross-batch host state is dropped."""
    M = cases.mods(PORT)
    m, pods = tie_cluster(PORT), web_pods(PORT, 80)
    backend = BatchBackend(algorithm=M.gs.GenericScheduler(), device="cpu",
                           frontier_chunk=16, frontier_min_width=8, frontier_device_loop=False)
    scan_range, calls = scan_ref.scan_range, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("chunk launch failed")
        return scan_range(*a, **kw)

    monkeypatch.setattr(scan_ref, "scan_range", failing)
    with pytest.raises(RuntimeError, match="chunk launch failed"):
        backend.schedule_batch(pods, m, M.PriorityContext(m))
    assert len(calls) == 3
    assert backend.stats["kernel_pods"] == backend.stats["oracle_pods"] == 0
    assert backend.stats["segments"] == 0 and backend._host_state is None


def test_monotone_plane_matches_the_jax_device_plane_at_seed():
    """The port's tensor plane equals the JAX package's device plane and
    the host builder at the step-0 state."""
    m = tiny_cluster(JAX, n_small=6, n_big=4)
    M = cases.mods(JAX)
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu="500m", memory="128Mi", labels={"app": "web"},
                          host_ports=[8080] if i % 3 == 0 else None) for i in range(24)]
    static, init = seeded_segment(m, pods)
    want = jsnap.monotone_plane(static, init.requested, init.pod_count, init.ports_used,
                                dm=init.dm, downer=init.downer)
    jgot = np.asarray(monotone_plane_device(
        to_device(static), state_to_device(init, r_sel=static.r_sel, use_frontier=True),
        bool(static.terms), bool(static.use_ports)))
    s, st = from_reference(vars(static), vars(init), "cpu")
    np.testing.assert_array_equal(scan_ref.monotone_plane(s, st).numpy(), want)
    np.testing.assert_array_equal(jgot, want)


def _terms_segment():
    """Mixed pods with required anti-affinity and host ports, so the
    plane's term and port components fire mid-segment."""
    m, pods, pctx = cases.mixed(JAX, seed=8, n_nodes=12, n_pods=160)
    M = cases.mods(JAX)
    tz = M.snapshot.Tensorizer()
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods, host_state=M.snapshot.HostBatchState(m))
    M.snapshot.frontier_seed(static, init)
    return static, init


@pytest.mark.parametrize("world", ["tie", "terms"])
def test_still_ok_refresh_never_resurrects(world):
    """At every loop exit: the alive union mapped to the original axis
    never grows back, the refreshed plane lies inside the host plane, and
    the port's tensor plane equals the JAX device plane on the same
    mid-segment state."""
    if world == "tie":
        static, init = seeded_segment(tie_cluster(JAX), web_pods(JAX, 110))
    else:
        static, init = _terms_segment()
    n_full = int(init.requested.shape[0])
    snaps = []

    class Rec(FrontierRun):
        def _sync_loop(self):
            out = super()._sync_loop()
            m, k = self._map, len(self._map)
            st = self.state
            cur = st.still_ok[:, :k].numpy()
            full = {f: np.array(getattr(init, f)) for f in
                    ("requested", "pod_count", "ports_used", "dm", "downer")}
            # the device's requested holds the r_sel slots only; the rest
            # stay as they were (no pod of the segment requests them)
            r_cols = np.arange(full["requested"].shape[1]) if static.r_sel is None else static.r_sel
            full["requested"][np.ix_(m, r_cols)] = st.requested[:k].numpy()
            full["pod_count"][m] = st.pod_count[:k].numpy()
            full["ports_used"][m] = st.ports_used[:k].numpy()
            full["dm"][:, m] = st.dm[:, :k].numpy()
            full["downer"][:, m] = st.downer[:, :k].numpy()
            still_full = np.zeros((cur.shape[0], n_full), dtype=bool)
            still_full[:, m] = cur
            plane = jsnap.monotone_plane(static, full["requested"], full["pod_count"],
                                         full["ports_used"], dm=full["dm"], downer=full["downer"])
            mid = jsnap.InitialState(**{**vars(init), **full})
            jdev = np.asarray(monotone_plane_device(
                to_device(static), state_to_device(mid, r_sel=static.r_sel, use_frontier=True),
                bool(static.terms), bool(static.use_ports)))
            s_full, st_full = from_reference(vars(static), vars(mid), "cpu")
            np.testing.assert_array_equal(scan_ref.monotone_plane(s_full, st_full).numpy(), jdev)
            snaps.append((still_full, plane))
            return out

    run = Rec(*from_reference(vars(static), vars(init), "cpu"), chunk_len=16, min_width=8)
    chosen, rr = run.finalize()
    assert len(snaps) >= 1
    if world == "tie":
        assert run.stats["compactions"] >= 1 and len(snaps) >= 2
    for (prev, _), (cur, _) in zip(snaps, snaps[1:]):
        assert not (cur.any(axis=0) & ~prev.any(axis=0)).any(), "a dead column came back"
    for still_full, plane in snaps:
        assert not (still_full & ~plane).any(), "the refresh kept a column the plane kills"
    p_chosen, p_rr = schedule_batch_arrays(static, init)
    np.testing.assert_array_equal(chosen, p_chosen)
    assert rr == p_rr


def test_a_pool_that_empties_maps_back_as_unschedulable():
    """A fault of the JAX package repaired in the port: when every column
    dies within one chunk and pods remain (a batch larger than its pool),
    the loop compacts to an empty axis and the JAX FrontierRun's map-back
    raises IndexError; its backend hides it by rerunning the segment at
    full width (``frontier_fallbacks``).  The port, which has no such
    retry, maps the later chunks' pods to unschedulable: the same bindings
    as the full-width scan and the JAX backend's, here at the default
    frontier settings (200 one-pod nodes, 1100 pods)."""
    def build(pkg):
        M, m = cases.mods(pkg), {}
        for i in range(200):
            _add(M, m, f"node-{i:03d}", cpu="8", memory="16Gi", pods=1,
                 labels={HOST: f"node-{i:03d}"})
        return m, web_pods(pkg, 1100)

    m, pods = build(JAX)
    static, init = seeded_segment(m, pods)
    with pytest.raises(IndexError):
        JFrontierRun(static, init, device_loop=True).finalize()
    s, st = from_reference(vars(static), vars(init), "cpu")
    run = FrontierRun(s, st)
    chosen, rr = run.finalize()
    plain, plain_rr = scan_ref.scan(s, st)
    np.testing.assert_array_equal(chosen, plain.numpy())
    assert rr == plain_rr and (chosen >= 0).sum() == 200
    assert run.stats["widths"] == [256, 128] and run.stats["alive_frac"][0] == 0.0

    out = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods = build(pkg)
        algo = M.gs.GenericScheduler()
        backend = (TPUBatchBackend(algorithm=algo) if pkg == JAX
                   else BatchBackend(algorithm=algo, device="cpu"))
        out[pkg] = (backend.schedule_batch(pods, m, M.PriorityContext(m)), algo._round_robin,
                    backend)
    assert out[PORT][:2] == out[JAX][:2]
    assert out[JAX][2].stats["frontier_fallbacks"] == 1
    assert out[PORT][2].last_frontier[0]["compactions"] == 1


def test_a_pool_full_at_the_start_prefilters_to_no_column():
    """Every node is full before the segment starts (a preemptor wave):
    the prefilter keeps no column and compacts to the width floor; every
    pod is unschedulable, as in the JAX backend and the oracle."""
    def build(pkg):
        M, m = cases.mods(pkg), {}
        for i in range(200):
            _add(M, m, f"node-{i:03d}", cpu="8", memory="16Gi", pods=1,
                 labels={HOST: f"node-{i:03d}"})
            m[f"node-{i:03d}"].add_pod(M.tu.make_pod(f"filler-{i}", cpu="100m",
                                                     node_name=f"node-{i:03d}"))
        return m, web_pods(pkg, 20)

    pb = backend_parity(build)
    seg = pb.last_frontier[0]
    assert seg["prefilter"] == [256, 128] and seg["mode"] == "plain"
    assert pb.stats["frontier_prefilter_cols"] == 128 and pb.stats["kernel_pods"] == 20


# -- backend.compact raises in the port -----------------------------------------

def _fault_world(n_pods=100, chunk=16):
    """The port's scheduler on a tie cluster, pods created and pumped."""
    M = cases.mods(PORT)
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
    from kubernetes_tpu_torch.store import Store

    cs = Clientset(Store())
    for info in tie_cluster(PORT).values():
        cs.nodes.create(info.node)
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu", frontier_chunk=chunk,
                           frontier_min_width=8)
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=False)
    sched.start()
    pods = web_pods(PORT, n_pods)
    for p in pods:
        cs.pods.create(p)
    sched.pump()
    return M, cs, sched, backend, pods


def _compact_fault_raises(spec, n_pods=100):
    M, cs, sched, backend, pods = _fault_world(n_pods)
    plan = FaultPlan(seed=1).on("backend.compact", mode="error", **spec)
    with plan.armed():
        with pytest.raises(FaultInjected):
            sched.schedule_pending_batch()
    assert plan.fired["backend.compact"] == 1
    assert len(sched.queue) == n_pods  # every drained pod requeued
    assert not any(p.spec.node_name for p in cs.pods.list()[0])
    oracle = M.gs.GenericScheduler()
    m = tie_cluster(PORT)
    want = cases.oracle_batch(PORT, pods, m, M.PriorityContext(m), oracle)
    n_bound = sum(w is not None for w in want)  # the fleet holds 88 pods
    assert sched.schedule_pending_batch() == (n_bound, n_pods - n_bound)
    got = {p.meta.name: p.spec.node_name or None for p in cs.pods.list()[0]}
    assert [got[p.meta.name] for p in pods] == want
    assert sched.algorithm._round_robin == oracle._round_robin
    # the JAX package's backend on its own copy of the world agrees
    jm = tie_cluster(JAX)
    jpods = web_pods(JAX, n_pods)
    jgot = TPUBatchBackend(algorithm=cases.mods(JAX).gs.GenericScheduler(), frontier_chunk=16,
                           frontier_min_width=8).schedule_batch(
        jpods, jm, cases.mods(JAX).PriorityContext(jm))
    assert jgot == want
    # one segment finished, on the scan (the failed one never finished)
    assert backend.stats["oracle_pods"] == 0 and backend.stats["segments"] == 1
    assert backend.stats["kernel_pods"] == n_pods
    return backend


def test_loop_fault_at_dispatch_raises_and_requeues():
    """phase=loop, first hit (the first loop run): the wave raises; nothing
    degrades to another loop form or to full width."""
    _compact_fault_raises(dict(match={"phase": "loop"}, first_n=1))


def test_loop_fault_at_reentry_raises_and_requeues():
    """phase=loop, second hit (the re-entry after a compaction, after the
    first loop run's launches): the wave raises and the next binds."""
    backend = _compact_fault_raises(dict(match={"phase": "loop"}, nth=2))
    assert backend.stats["frontier_compactions"] >= 2  # one before the fault, then the rerun's


def test_compact_fault_at_seed_raises_and_requeues():
    _compact_fault_raises(dict(match={"phase": "seed"}, first_n=1), n_pods=60)


def test_compact_fault_at_gather_raises_and_requeues():
    _compact_fault_raises(dict(match={"phase": "gather"}, first_n=1))


def test_frontier_off_is_plain_path():
    pb = backend_parity(lambda pkg: (tiny_cluster(pkg, n_small=4, n_big=4), web_pods(pkg, 20)),
                        dict(frontier=False))
    assert pb.stats["frontier_segments"] == 0 and pb.last_frontier == []


def test_axis_tightening_shapes_and_parity():
    """The slot, port and resource axes tighten in both packages alike: no
    signature requests a GPU or ephemeral storage, so ``r_sel`` keeps cpu
    and memory, the host arrays stay full width and the device's resource
    axis is two wide."""
    def build(pkg):
        M = cases.mods(pkg)
        pods = []
        for i in range(30):
            if i % 6 == 0:
                pods.append(M.tu.make_pod(f"vol-{i:03d}", cpu="100m", memory="64Mi",
                                          labels={"app": "api"},
                                          volumes=[M.api.Volume(name="v", disk_id=f"pd-{i % 4}",
                                                                disk_kind="gce-pd")]))
            else:
                pods.append(M.tu.make_pod(f"p-{i:03d}", cpu="250m", memory="128Mi",
                                          labels={"app": "web"}))
        return tiny_cluster(pkg, n_small=4, n_big=6), pods

    shapes = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods = build(pkg)
        static = M.snapshot.Tensorizer().build_static(pods, m, M.PriorityContext(m))
        shapes[pkg] = (static.pod_vol_ids.shape, static.use_ports, static.node_alloc.shape,
                       list(static.r_sel))
        assert static.pod_vol_ids.shape[1] == 1 and static.use_ports is False
        assert list(static.r_sel) == [0, 1] and static.node_alloc.shape[1] == 4
        if pkg == PORT:
            init = M.snapshot.Tensorizer().initial_state(static, m, M.PriorityContext(m), pods)
            s, st = from_reference(vars(static), vars(init), "cpu")
            assert s.node_alloc.shape[1] == s.g_request.shape[1] == st.requested.shape[1] == 2
    assert shapes[PORT] == shapes[JAX]
    backend_parity(build)
