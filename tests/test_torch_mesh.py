"""The node-axis mesh of the port (``parallel/mesh.py``, the plain sharded
step ``ops/scan_ref.py::scan_shards``, ``FrontierRun(mesh=)``, the backend's
``frontier_mesh``, the scheduler's mesh gauges): twins of
``tests/test_mesh.py``, and the port held against the JAX package's mesh on
the same seeded inputs.

Every twin feeds the JAX package's tensorized segment (its own test
helpers) to the port through ``carry.from_reference``, or builds one
cluster in each package from one spec.  The port's meshes put all their
shards on the CPU (``make_mesh(n, devices=["cpu"] * n)``), as the JAX
package's tests put theirs on conftest's 8 virtual CPU devices.  The JAX
test of a mesh that fails to build expects the segment to degrade to the
single-device loop; the port has no fallback, so its twin expects a raise
(ROADMAP kept divergence aj).

Tolerance: exact equality everywhere (chosen columns, counters, stats)."""

from __future__ import annotations

import dataclasses
import os
import random
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from kubernetes_tpu.models import Tensorizer
from kubernetes_tpu.models import snapshot as jsnap
from kubernetes_tpu.ops import TPUBatchBackend
from kubernetes_tpu.ops.batch_kernel import FrontierRun as JFrontierRun
from kubernetes_tpu.ops.batch_kernel import schedule_batch_arrays, state_to_device, to_device
from kubernetes_tpu.parallel import make_mesh as jmake_mesh
from kubernetes_tpu.parallel import mesh as jmesh
from kubernetes_tpu.scheduler import PriorityContext
from kubernetes_tpu.testutil import make_pod
from kubernetes_tpu.utils import slo as jslo
from kubernetes_tpu_torch.models import snapshot as psnap
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import _build as kbuild
from kubernetes_tpu_torch.ops import mesh_scan, scan_ref
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.ops.frontier import FrontierRun
from kubernetes_tpu_torch.parallel import mesh as pmesh
from kubernetes_tpu_torch.utils import slo as pslo
from tests import torch_port_cases as cases
from tests.test_frontier import tie_cluster as jtie_cluster
from tests.test_parity import build_cluster, make_batch
from tests.test_torch_fused_plan import _ctypes_fields, _parse_struct
from tests.test_torch_frontier import ENTRY_KEYS, backend_parity, seeded_segment, tie_cluster, web_pods

JAX, PORT = cases.JAX, cases.PORT


def cpu_mesh(n: int) -> pmesh.Mesh:
    return pmesh.make_mesh(n, devices=["cpu"] * n)


def carried(static, init):
    return from_reference(vars(static), vars(init), "cpu")


def _build(seed, n_nodes, n_pods):
    rng = random.Random(seed)
    m = build_cluster(rng, n_nodes, zones=3)
    pctx = PriorityContext(m)
    pods = make_batch(rng, n_pods)
    tz = Tensorizer(pad_multiple=8 * 16)  # divisible by the mesh size
    static = tz.build_static(pods, m, pctx, balanced_weight=1, spread_weight=1)
    init = tz.initial_state(static, m, pctx, pods)
    return static, init


def assert_sharded_parity(static, init, sizes):
    """The port's sharded scan at each mesh size == the port's one-device
    scan == the JAX package's single-device scan."""
    want, rr_want = schedule_batch_arrays(static, init)
    s, st = carried(static, init)
    single, rr_single = scan_ref.scan(s, st)
    np.testing.assert_array_equal(single.numpy(), want)
    assert rr_single == rr_want
    for n in sizes:
        got, rr = pmesh.schedule_batch_sharded(s, st, cpu_mesh(n))
        np.testing.assert_array_equal(got, want, err_msg=f"mismatch at mesh size {n}")
        assert rr == rr_want
    return want


# -- twins of tests/test_mesh.py ---------------------------------------------


def test_sharded_matches_single_device():
    assert_sharded_parity(*_build(21, 40, 200), (8,))


def test_sharded_various_mesh_sizes():
    assert_sharded_parity(*_build(22, 24, 100), (2, 4))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_phase_b_mixed_matches_single_device(n_dev):
    static, init = ge._build_mixed_problem(n_nodes=32, n_pods=80, pad_multiple=n_dev * 8, seed=7)
    assert static.terms and static.use_vols  # the hard half is on
    got = assert_sharded_parity(static, init, (n_dev,))
    assert (got >= 0).any()


def test_sharded_phase_b_volume_conflicts_respected():
    """Many pods sharing few disks: the [V, N] occupancy serializes them one
    node a disk, identically under sharding."""
    from kubernetes_tpu.api import Volume

    rng = random.Random(31)
    m = build_cluster(rng, 16, zones=3)
    pctx = PriorityContext(m)
    pods = [make_pod(f"v-{i}", cpu="100m", labels={"app": "db"},
                     volumes=[Volume(name="v", disk_id=f"pd-{i % 3}", disk_kind="gce-pd")])
            for i in range(30)]
    tz = Tensorizer(pad_multiple=8 * 4)
    static = tz.build_static(pods, m, pctx, balanced_weight=1, spread_weight=1)
    init = tz.initial_state(static, m, pctx, pods)
    assert static.use_vols
    assert_sharded_parity(static, init, (2, 8))


def test_sharded_scan_collective_structure():
    """The mesh kernel's per-pod exchanges are reductions and small gathers,
    never one that carries a [G, N] / [T, N] plane, and the mesh does
    communicate (the statistics are all-reduced)."""
    static, init = _build(21, 32, 96)
    s, st = carried(static, init)
    plan = pmesh.sharded_hlo(s, cpu_mesh(8))
    counts = pmesh.assert_collective_structure(plan, s)
    assert counts["all-reduce"] > 0, counts
    # plan, check, then run: the verified entry point's bindings are exact
    chosen, rr, verified = pmesh.schedule_batch_sharded_verified(s, st, cpu_mesh(8))
    want, rr_want = schedule_batch_arrays(static, init)
    np.testing.assert_array_equal(chosen, want)
    assert rr == rr_want and verified == counts
    # the plan is the kernel's: its words follow the planner's layout
    pl = mesh_scan.plan(pmesh.place_static(s, cpu_mesh(8)))
    assert pl.grid == 8 and pl.msg_a == mesh_scan.NSTAT + s.num_zones
    assert {e["name"]: e["words"] for e in plan} == {
        "statistics": 2 * pl.grid * pl.msg_a, "best_and_ties": 4 * pl.grid,
        "tie_words": pl.grid * pl.bw}


def test_collective_structure_gate_rejects_state_allgather():
    """The gate has teeth: an exchange that carries a full state plane
    fails."""
    static, init = _build(22, 32, 32)
    s, _ = carried(static, init)
    g, t, n = s.static_ok.shape[0], s.term_matches_sig.shape[0], s.n_pad
    bad = [{"name": "plane", "collective": "all-gather", "words": max(g, t, 2) * n}]
    with pytest.raises(AssertionError, match="all-gathers node-axis state"):
        pmesh.assert_collective_structure(bad, s)


def _jax_seeded(pods, nim):
    pctx = PriorityContext(nim)
    tz = Tensorizer()
    static = tz.build_static(pods, nim, pctx)
    init = tz.initial_state(static, nim, pctx, pods)
    jsnap.frontier_seed(static, init)
    return static, init


MESH_STATS = ("n_shards", "compactions", "host_syncs", "shard_alive_frac", "widths",
              "alive_frac", "chunks", "loop_runs")


def loop_parity(m_jax, pods_jax, m_port, pods_port, n_dev, **kw):
    """The JAX package's sharded FrontierRun and the port's, each on its own
    tensorizer's segment of one spec padded by its own
    ``pad_segment_to_multiple``; the port's also against its one-device
    loop and plain scan.  Returns the port's run."""
    jstatic, jinit = seeded_segment(m_jax, pods_jax, JAX)
    jp_static, jp_init = jsnap.pad_segment_to_multiple(jstatic, jinit, n_dev)
    jrun = JFrontierRun(jp_static, jp_init, device_loop=True, mesh=jmake_mesh(n_dev), **kw)
    j_chosen, j_rr = jrun.finalize()
    pstatic, pinit = seeded_segment(m_port, pods_port, PORT)
    pp_static, pp_init = psnap.pad_segment_to_multiple(pstatic, pinit, n_dev)
    run = FrontierRun(*carried(pp_static, pp_init), mesh=cpu_mesh(n_dev), **kw)
    chosen, rr = run.finalize()
    np.testing.assert_array_equal(chosen, j_chosen)
    assert rr == j_rr
    for k in MESH_STATS:
        assert run.stats[k] == jrun.stats[k], (k, run.stats[k], jrun.stats[k])
    s, st = carried(pstatic, pinit)
    single_chosen, single_rr = FrontierRun(s, st, **kw).finalize()
    plain, plain_rr = scan_ref.scan(s, st)
    np.testing.assert_array_equal(chosen, single_chosen)
    np.testing.assert_array_equal(chosen, plain.numpy())
    assert rr == single_rr == plain_rr
    return run


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_loop_forced_ties_and_compaction_parity(n_dev):
    """Identical nodes tie on every score while staggered caps force
    mid-segment compactions: the port's sharded loop, the JAX package's,
    the one-device loop and the plain scan agree on bindings and the tie
    counter at every mesh size, with the JAX loop's stats."""
    run = loop_parity(tie_cluster(JAX, 16), web_pods(JAX, 110), tie_cluster(PORT, 16),
                      web_pods(PORT, 110), n_dev, chunk_len=16, min_width=8)
    assert run.stats["compactions"] >= 1, "compaction never fired sharded"
    assert run.stats["n_shards"] == n_dev
    # the O(compactions + 1) sync budget survives sharding
    assert run.stats["host_syncs"] <= run.stats["loop_runs"] + 1
    assert run.stats["loop_runs"] >= run.stats["compactions"] + 1
    assert all(len(f) == n_dev for f in run.stats["shard_alive_frac"])


def test_sharded_loop_uneven_width_pads_no_phantom_columns():
    """An N the shard count does not divide: the padded columns are dead for
    every signature (no phantom feasible column wins any reduce), the
    port's padding equals the JAX package's, and the sharded run is exact
    against the unpadded plain scan."""
    rng = random.Random(91)
    nim = build_cluster(rng, 20, zones=3)
    pods = [make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi", labels={"app": "web"})
            for i in range(90)]
    pctx = PriorityContext(nim)
    tz = Tensorizer(pad_multiple=2)  # n_pad 20: not divisible by 8
    static = tz.build_static(pods, nim, pctx)
    init = tz.initial_state(static, nim, pctx, pods)
    jsnap.frontier_seed(static, init)
    assert int(static.n_pad) % 8 != 0
    pstatic, pinit = psnap.pad_segment_to_multiple(static, init, 8)
    jstatic, jinit = jsnap.pad_segment_to_multiple(static, init, 8)
    assert int(pstatic.n_pad) % 8 == 0 and pstatic.n_pad > static.n_pad
    for f in jsnap._STATIC_NODE_FIELDS:
        np.testing.assert_array_equal(getattr(pstatic, f), getattr(jstatic, f), err_msg=f)
    for f in jsnap._INIT_NODE_FIELDS:
        np.testing.assert_array_equal(getattr(pinit, f), getattr(jinit, f), err_msg=f)
    n = int(static.n_pad)
    # the padded tail is dead on arrival: no existence, no feasibility
    assert not pstatic.node_exists[n:].any()
    assert not np.asarray(pinit.still_ok)[:, n:].any()
    run = FrontierRun(*carried(pstatic, pinit), chunk_len=16, min_width=8, mesh=cpu_mesh(8))
    m_chosen, m_rr = run.finalize()
    p_chosen, p_rr = schedule_batch_arrays(static, init)
    np.testing.assert_array_equal(m_chosen, p_chosen)
    assert m_rr == p_rr
    assert not (m_chosen >= n).any(), "a phantom pad column was chosen"


def test_sharded_backend_oracle_parity_end_to_end():
    """Through both backends with ``frontier_mesh=True`` on 8 shards:
    bindings and the counter equal the per-pod oracle and each other, the
    segment runs in mesh mode, and its entry (widths, alive fractions,
    per-shard fractions, host syncs) equals the JAX package's."""
    kw = dict(frontier_chunk=16, frontier_min_width=8, frontier_mesh=True, mesh_devices=8)
    out = {}
    orig = TPUBatchBackend.schedule_batch

    def keep(self, *a, **k):  # the JAX backend, for its last_frontier
        out["jax"] = self
        return orig(self, *a, **k)

    TPUBatchBackend.schedule_batch = keep
    try:
        backend = backend_parity(lambda pkg: (tie_cluster(pkg, 16), web_pods(pkg, 110)), kw)
    finally:
        TPUBatchBackend.schedule_batch = orig
    jb = out["jax"]
    assert jb.stats["frontier_fallback_modes"].get("mesh", 0) == 0
    seg = backend.last_frontier[0]
    assert seg["mode"] == "mesh" and seg["n_shards"] == 8
    assert seg["compactions"] >= 1
    assert seg["host_syncs"] <= seg["compactions"] + 2
    assert len(seg["shard_alive_frac"]) > seg["compactions"] >= 1
    assert all(len(s) == 8 for s in seg["shard_alive_frac"])
    for k in ENTRY_KEYS + ("n_shards", "shard_alive_frac"):
        assert seg[k] == jb.last_frontier[0][k], k


def test_sharded_backend_mesh_failure_raises():
    """The JAX twin degrades to the single-device loop when the mesh cannot
    be built or a sharded dispatch fails; the port has no fallback (kept
    divergence aj): fewer than 2 shards raise at construction, and a
    failing sharded step raises out of the batch with no segment served
    another way."""
    with pytest.raises(ValueError, match=">= 2 shards"):
        BatchBackend(device="cpu", frontier_chunk=16, frontier_min_width=8,
                     frontier_mesh=True, mesh_devices=1)
    m, pods = tie_cluster(PORT, 16), web_pods(PORT, 110)
    backend = BatchBackend(device="cpu", frontier_chunk=16, frontier_min_width=8,
                           frontier_mesh=True, mesh_devices=4)
    orig = scan_ref.scan_shards

    def broken(statics, *a, **k):
        if len(statics) > 1:
            raise RuntimeError("mesh step failed")
        return orig(statics, *a, **k)

    scan_ref.scan_shards = broken
    try:
        with pytest.raises(RuntimeError, match="mesh step failed"):
            backend.schedule_batch(pods, m, cases.mods(PORT).PriorityContext(m))
    finally:
        scan_ref.scan_shards = orig
    assert backend.last_frontier == []  # nothing was served another way


# -- the port held against the JAX package's mesh ----------------------------


def _jax_shards(arr) -> list:
    return [np.asarray(sh.data) for sh in
            sorted(arr.addressable_shards, key=lambda sh: [s.start or 0 for s in sh.index])]


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_placement_equals_the_jax_shards(n_dev):
    """JAX ``place_static`` / ``place_state`` shard by shard equal the
    port's per-shard tensors, node planes split, the rest replicated."""
    static, init = _jax_seeded(web_pods(JAX, 40), jtie_cluster(16))
    mesh = jmake_mesh(n_dev)
    r_sel = static.r_sel
    jdev = jmesh.place_static(to_device(static), mesh)
    jst = jmesh.place_state(state_to_device(init, r_sel=r_sel, use_frontier=True), mesh)
    s, st = carried(static, init)
    ps, pst = pmesh.place_static(s, cpu_mesh(n_dev)), pmesh.place_state(st, cpu_mesh(n_dev))
    assert [x.n_pad for x in ps] == [s.n_pad // n_dev] * n_dev

    def port_view(t, f):
        a = t.numpy()
        return a[..., r_sel] if r_sel is not None and f in ("node_alloc", "g_request",
                                                            "requested") else a

    for f in jdev._fields:
        parts = _jax_shards(getattr(jdev, f))
        assert len(parts) == n_dev
        for k in range(n_dev):
            np.testing.assert_array_equal(port_view(getattr(ps[k], f), f), parts[k], err_msg=f)
    for f in jst._fields:
        if f == "round_robin":
            assert all(x.round_robin == int(jst.round_robin) for x in pst)
            continue
        parts = _jax_shards(getattr(jst, f))
        for k in range(n_dev):
            np.testing.assert_array_equal(port_view(getattr(pst[k], f), f), parts[k], err_msg=f)
    # the specs are the JAX rules': a field split on an axis here is split
    # on that axis there
    jspec = jmesh.static_specs()
    for f, ax in pmesh.static_specs().items():
        if f in jdev._fields:
            want = getattr(jspec, f)
            assert (None if len(want) == 0 else list(want).index(jmesh.NODE_AXIS)) == ax, f
    # placing and unplacing the carry round-trips
    back = pmesh.unplace_state(pst)
    for f in pmesh.state_specs():
        assert torch.equal(getattr(back, f), getattr(st, f)), f


def test_loop_specs_follow_the_jax_layout():
    """The loop's split of inputs and outputs: the statics and carry by
    their rules, the rest replicated, the alive masks concatenated."""
    static_in, state_in, *rest = pmesh.loop_in_specs()
    assert static_in == pmesh.static_specs() and state_in == pmesh.state_specs()
    assert rest == [None, None, None]
    state_out, chosen_out, ctl_out, alive_out = pmesh.loop_out_specs()
    assert state_out == pmesh.state_specs() and chosen_out is None and ctl_out is None
    j_alive = jmesh.loop_out_specs()[4]
    assert list(j_alive).index(jmesh.NODE_AXIS) == alive_out == 0
    rules = ((r"node_.*", 0), (r"static_ok", 1))
    assert pmesh.match_partition_rules(rules, ["node_zone", "static_ok", "g_request"]) == {
        "node_zone": 0, "static_ok": 1, "g_request": None}


@pytest.mark.parametrize("seed", [1, 2])
def test_sharded_loop_randomized_parity_with_the_jax_mesh(seed):
    """Random mixed clusters (taints, zones, saturation) under aggressive
    compaction at 4 shards: the port's sharded loop equals the JAX
    package's in bindings, counter and stats."""
    from tests.test_torch_frontier import random_world

    mj, pj = random_world(JAX, seed)
    mp, pp = random_world(PORT, seed)
    loop_parity(mj, pj, mp, pp, 4, chunk_len=16, min_width=8, compact_frac=0.9)


def _mesh_churn(pkg, waves=3, per_wave=40):
    """A scheduler with the batch backend on a 4-shard mesh serving
    ``waves`` waves on staggered-cap nodes: each wave's bindings, counter,
    mesh gauges and ``last_batch_phases["mesh"]``."""
    M = cases.mods(pkg)
    import importlib

    client = importlib.import_module(f"{pkg}.client")
    store = importlib.import_module(f"{pkg}.store")
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    cs = client.Clientset(store.Store())
    for i in range(24):
        cs.nodes.create(M.tu.make_node(f"node-{i:03d}", cpu="64", memory="64Gi",
                                       pods=2 + i // 2, labels={"zone": f"z{i % 2}"}))
    algo = sched_mod.GenericScheduler()
    kw = dict(frontier_chunk=16, frontier_min_width=8, frontier_mesh=True, mesh_devices=4)
    backend = (TPUBatchBackend(algorithm=algo, **kw) if pkg == JAX
               else BatchBackend(algorithm=algo, device="cpu", **kw))
    sched = sched_mod.Scheduler(cs, algorithm=algo, backend=backend)
    sched.start()
    out = []
    for w in range(waves):
        for i in range(per_wave):
            cs.pods.create(M.tu.make_pod(f"w{w}-{i:03d}", cpu="100m", memory="128Mi",
                                         labels={"app": "web"}))
        sched.pump()
        sched.schedule_pending_batch()
        sched.pump()
        pods, _ = cs.pods.list()
        m = sched.metrics
        out.append({
            "bindings": sorted((p.meta.key, p.spec.node_name) for p in pods),
            "rr": algo._round_robin,
            "gauges": (m.mesh_shards.value, m.mesh_worst_shard_upload_fraction.value,
                       m.mesh_shard_alive_skew.value),
            "mesh": sched.last_batch_phases.get("mesh"),
        })
    return out


def test_mesh_wave_gauges_and_slos_equal_the_jax_package():
    """One churn on a 4-shard mesh through each package's scheduler: every
    wave's bindings, counter, the three mesh gauges and the per-shard
    attribution equal the JAX package's, and ``mesh_slos`` grades the same
    gauges against the same thresholds."""
    port, jax_ = _mesh_churn(PORT), _mesh_churn(JAX)
    assert port == jax_
    assert port[0]["mesh"]["n_shards"] == 4 and port[0]["gauges"][0] == 4
    assert "shard_upload_fractions" in port[0]["mesh"]

    def spec(slos):
        return [(s.name, type(s.sli).__name__, s.sli.metric, s.sli.threshold) for s in slos]

    assert spec(pslo.mesh_slos()) == spec(jslo.mesh_slos())


def test_node_cache_attributes_columns_to_their_shard():
    """The node cache's per-shard counters: a full upload counts every
    shard's slice, a diff counts each changed column on the shard that
    owns it, and the mesh joins the token (a new mesh re-uploads)."""
    from kubernetes_tpu.ops.batch_kernel import DeviceNodeCache as JCache
    from kubernetes_tpu_torch.ops.node_cache import DeviceNodeCache

    def statics():
        rng = random.Random(5)
        m = build_cluster(rng, 16, zones=2)
        pods = make_batch(rng, 8)
        tz = Tensorizer(pad_multiple=16)
        a = tz.build_static(pods, m, PriorityContext(m))
        name = sorted(m)[13]
        m[name].add_pod(make_pod("extra", cpu="1", node_name=name))
        m[name].node.status.allocatable["cpu"] = m[name].node.status.allocatable["cpu"]
        b = tz.build_static(pods, m, PriorityContext(m))
        return a, dataclasses.replace(b, node_alloc=b.node_alloc.copy(),
                                      node_token=a.node_token[:2] + (a.node_token[2] + 1,))

    a, b = statics()
    b.node_alloc[13, 0] += 1  # one column changed, on shard 3 of 4
    port, jc = DeviceNodeCache("cpu"), JCache()
    port.set_mesh(cpu_mesh(4))
    jc.set_mesh(jmake_mesh(4))
    for static in (a, a, b):
        port.node_arrays(static)
        jc.node_arrays(static)
    for k in ("reuses", "col_updates", "uploads", "dirty_cols", "cols_total",
              "shard_dirty_cols", "shard_cols_total"):
        assert port.stats[k] == jc.stats[k], (k, port.stats[k], jc.stats[k])
    assert port.stats["shard_dirty_cols"][3] > 0 and port.stats["shard_dirty_cols"][0] == 4
    # a new mesh misses (the token carries the mesh) and restarts the
    # per-shard counters at its own shard count
    reuses = port.stats["reuses"]
    port.set_mesh(cpu_mesh(2))
    jc.set_mesh(jmake_mesh(2))
    port.node_arrays(b)
    jc.node_arrays(b)
    assert port.stats["reuses"] == reuses and port.stats["shard_cols_total"] == [8, 8]
    for k in ("reuses", "col_updates", "uploads", "shard_dirty_cols", "shard_cols_total"):
        assert port.stats[k] == jc.stats[k], (k, port.stats[k], jc.stats[k])


def test_mesh_params_mirror_matches_the_cuda_struct():
    """``MeshParams`` field for field against ``csrc/mesh_scan.cu``, and the
    pointer table's planes in the kernel's enum order."""
    with open(os.path.join(kbuild.CSRC, "mesh_scan.cu")) as f:
        text = f.read()
    assert _ctypes_fields(mesh_scan.MeshParams) == _parse_struct(text, "MeshParams")
    enum = re.search(r"enum\s+ShardPlane\s*\{(.*?)\}", text, re.S).group(1)
    names = [x.split("=")[0].strip() for x in enum.replace("\n", " ").split(",") if x.strip()]
    names = [x[2:].lower() for x in names if x != "NSHARD_PLANES"]
    alias = {"aff": "aff_raw", "taint": "taint_raw", "score": "score_raw",
             "interpod": "interpod_raw"}
    assert [alias.get(x, x) for x in names] == list(mesh_scan.SHARD_PLANES)


@pytest.mark.parametrize("n_local,shards", [(1, 8), (5, 4), (1280, 4), (2560, 2), (5024, 4)])
def test_mesh_plan_covers_each_shard(n_local, shards):
    """The planner's blocks cover a shard's columns in whole tie words, its
    packed width is the refresh's (a multiple of 16), and the grid it asks
    for fits the card's 132 SMs at one block each."""
    pl = mesh_scan.plan_for(n_local, shards, r=4, g=32, t=4, pv=8, w=1, zones=3)
    assert pl.blocks * pl.cols >= n_local > (pl.blocks - 1) * pl.cols
    assert pl.cols % 32 == 0 and pl.bw == pl.cols // 32 and pl.threads % 32 == 0
    assert pl.ns % 16 == 0 and pl.ns >= max(n_local, 16)
    assert pl.grid <= 132
    assert pl.msg_a == mesh_scan.NSTAT + 3


def test_mesh_kernel_raises_off_the_card():
    """The kernel's entry points take CUDA tensors only: on the CPU they
    raise and name the plain version; nothing falls back."""
    static, init = _build(22, 24, 20)
    s, st = carried(static, init)
    mesh = cpu_mesh(2)
    with pytest.raises(RuntimeError, match="scan_shards"):
        mesh_scan.schedule(pmesh.place_static(s, mesh), pmesh.place_state(st, mesh))
