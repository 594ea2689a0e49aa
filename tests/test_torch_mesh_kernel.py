"""The mesh kernel (``ops/csrc/mesh_scan.cu``) on the card: a whole
segment at 2, 4 and 8 shards against the plain sharded step
(``scan_ref.scan_shards``) and the fused scan (also a segment with planes
left in global memory and one with its zone totals there), and the sharded frontier
loop (``FrontierRun(mesh=)``: mesh launches a chunk, the refresh a shard)
against the same loop on the CPU.  The mesh in several launches (mailboxes
across launches at system scope) runs as 2 and 4 launches on one card, on
streams of their own, against the single launch and the plain sharded
step, alone and in the frontier loop; with two cards or more, as one
launch a card too.  Every test here needs a card and skips
elsewhere with a reason; on the CPU the mesh's plain path is covered by
``tests/test_torch_mesh.py``.  This file imports nothing of the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_kernel.py

Tolerance: exact equality of chosen nodes, counters and loop stats."""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, mesh_scan, scan_ref
from kubernetes_tpu_torch.ops.frontier import FrontierRun
from kubernetes_tpu_torch.parallel import mesh as pmesh
from tests import torch_port_cases as cases

PORT = cases.PORT


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh kernel has no CPU mode")


def _cards():
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one card runs the grouped mesh as launches on one card "
                    "(the tests above)")


def _tie_segment():
    """The tie fixture: 40 identical nodes with staggered pod caps (every
    score ties, columns die one after another) and 300 pods, seeded for
    the frontier loop."""
    M = cases.mods(PORT)
    m = {}
    for i in range(40):
        node = M.tu.make_node(f"node-{i:03d}", cpu="64", memory="64Gi", pods=2 + i // 2,
                              labels={"kubernetes.io/hostname": f"node-{i:03d}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = [M.tu.make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi", labels={"app": "web"})
            for i in range(300)]
    pctx = M.PriorityContext(m)
    tz = M.snapshot.Tensorizer()
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods)
    M.snapshot.frontier_seed(static, init)
    return static, init


def _padded(static, init, n, device):
    ps, pi = cases.mods(PORT).snapshot.pad_segment_to_multiple(static, init, n)
    return from_reference(vars(ps), vars(pi), device)


# (case, its builder's arguments, shard counts): the small cases at 2, 4 and
# 8 shards; a segment whose planes the planner leaves partly in global
# memory (20 224 columns in 2 shards), and one whose zone count is past
# what shared memory holds (the zone totals in a global row a block). Few
# pods: the plain sharded step costs 11-16 ms a pod on the card.
KERNEL_CASES = {
    "mixed": ("mixed", {}, (2, 4, 8)),
    "terms_only": ("terms_only", {}, (2, 4, 8)),
    "volumes_only": ("volumes_only", {}, (2, 4, 8)),
    "ties": ("ties", {}, (2, 4, 8)),
    "many_zones": ("many_zones", {}, (2, 4, 8)),
    "planes_partly_global": ("mixed", {"n_nodes": 20224, "n_pods": 12}, (2,)),
    "zones_past_shared": ("many_zones", {"n_zones": 5000, "n_nodes": 5120, "n_pods": 8}, (2, 4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_mesh_kernel_matches_the_plain_sharded_step(case):
    _card()
    builder, kw, sizes = KERNEL_CASES[case]
    static, init = cases.tensorize(PORT, builder, **kw)
    want, rr_want = fused_scan.schedule(*from_reference(vars(static), vars(init), "cuda"))
    for n in sizes:
        s, st = _padded(static, init, n, "cuda")
        mesh = pmesh.make_mesh(n, devices=["cuda"] * n)
        mesh_scan.launches = 0
        got, rr = pmesh.schedule_batch_sharded(s, st, mesh)
        assert mesh_scan.launches == 1
        plain, finals = scan_ref.scan_shards(pmesh.place_static(s, mesh),
                                             pmesh.place_state(st, mesh))
        np.testing.assert_array_equal(got, plain.cpu().numpy(), err_msg=f"{case} at {n}")
        np.testing.assert_array_equal(got, want, err_msg=f"{case} at {n}")
        assert rr == rr_want == finals[0].round_robin
        pl = mesh_scan.plan(pmesh.place_static(s, mesh))
        if case == "planes_partly_global":
            assert pl.global_ and pl.shared, pl.offsets
        if case == "zones_past_shared":
            assert pl.zones_at == "global", pl.zones_at


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_loop_on_card_equals_the_cpu(n):
    """The sharded frontier loop on the card (a mesh launch and a refresh a
    shard per chunk) equals the same loop on the CPU: bindings, counter,
    widths, compactions, alive and per-shard fractions, host syncs."""
    _card()
    static, init = _tie_segment()
    runs = {}
    for dev in ("cpu", "cuda"):
        s, st = _padded(static, init, n, dev)
        mesh = pmesh.make_mesh(n, devices=[dev] * n)
        frontier_refresh.launches = mesh_scan.launches = 0
        run = FrontierRun(s, st, chunk_len=16, min_width=8, mesh=mesh)
        runs[dev] = (run.finalize(), dict(run.stats), run)
    (c_cpu, rr_cpu), st_cpu, _ = runs["cpu"]
    (c_gpu, rr_gpu), st_gpu, run = runs["cuda"]
    np.testing.assert_array_equal(c_gpu, c_cpu)
    assert rr_gpu == rr_cpu
    assert st_gpu == st_cpu
    assert st_gpu["compactions"] >= 1
    assert run.launches == mesh_scan.launches > 0
    assert run.refresh_launches == frontier_refresh.launches == n * run.launches


# (case, its builder's arguments): small segments with ties, terms, volumes
# and zones, and one whose zone rows travel with the messages (past the
# register zones, totals in a global row a block)
GROUPED_CASES = {
    "ties": ("ties", {}),
    "mixed": ("mixed", {}),
    "terms_only": ("terms_only", {}),
    "volumes_only": ("volumes_only", {}),
    "many_zones": ("many_zones", {}),
    "zones_past_shared": ("many_zones", {"n_zones": 5000, "n_nodes": 5120, "n_pods": 8}),
}


def _grouped_parity(case, meshes):
    """Each mesh of ``meshes`` (4 shards, grouped as it says) against the
    single launch of 4 shards, the plain sharded step and the fused scan:
    chosen and counter exact, a kernel launch a group."""
    builder, kw = GROUPED_CASES[case]
    static, init = cases.tensorize(PORT, builder, **kw)
    want, rr_want = fused_scan.schedule(*from_reference(vars(static), vars(init), "cuda"))
    s, st = _padded(static, init, 4, "cuda")
    one = pmesh.make_mesh(4, devices=["cuda"] * 4)
    single, rr_single = pmesh.schedule_batch_sharded(s, st, one)
    plain, finals = scan_ref.scan_shards(pmesh.place_static(s, one), pmesh.place_state(st, one))
    for mesh in meshes:
        s, st = _padded(static, init, 4, mesh.devices[0])
        mesh_scan.launches = mesh_scan.launches_grouped = 0
        got, rr = pmesh.schedule_batch_sharded(s, st, mesh)
        assert mesh_scan.launches == mesh_scan.launches_grouped == len(mesh.groups)
        for other in (single, plain.cpu().numpy(), want):
            np.testing.assert_array_equal(got, other, err_msg=f"{case} in {mesh.groups}")
        assert rr == rr_single == rr_want == finals[0].round_robin


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_mesh_on_one_card_matches_the_single_launch(case):
    """4 shards as 2 launches of 2 and as 4 launches of 1 on one card."""
    _card()
    _grouped_parity(case, [pmesh.make_mesh(4, devices=["cuda"] * 4, launches=k) for k in (2, 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "zones_past_shared"])
def test_grouped_mesh_over_cards_matches_the_single_launch(case):
    """4 shards spread over the cards (a launch a card, peer access on)."""
    _cards()
    _grouped_parity(case, [pmesh.make_mesh(4)])


def _loop(static, init, mesh, dev):
    s, st = _padded(static, init, mesh.size, dev)
    frontier_refresh.launches = mesh_scan.launches = 0
    run = FrontierRun(s, st, chunk_len=16, min_width=8, mesh=mesh)
    out = run.finalize()
    return out, dict(run.stats), run, mesh_scan.launches, frontier_refresh.launches


def _grouped_loop(mesh):
    """The tie fixture's sharded loop in ``mesh``'s launches == the single
    launch's loop on the card == the loop on the CPU, with at least one
    compaction and the host syncs of the single launch."""
    static, init = _tie_segment()
    n = mesh.size
    (c_cpu, rr_cpu), st_cpu, *_ = _loop(static, init, pmesh.make_mesh(n, devices=["cpu"] * n),
                                        "cpu")
    (c_one, rr_one), st_one, *_ = _loop(static, init,
                                        pmesh.make_mesh(n, devices=["cuda"] * n), "cuda")
    (c_grp, rr_grp), st_grp, run, launches, refreshes = _loop(static, init, mesh,
                                                              mesh.devices[0])
    np.testing.assert_array_equal(c_grp, c_one)
    np.testing.assert_array_equal(c_grp, c_cpu)
    assert rr_grp == rr_one == rr_cpu
    assert st_grp == st_one == st_cpu
    assert st_grp["compactions"] >= 1
    assert launches == len(mesh.groups) * run.launches
    assert refreshes == run.refresh_launches == n * run.launches


@pytest.mark.cuda
@pytest.mark.parametrize("launches", [2, 4])
def test_grouped_loop_on_one_card_equals_the_single_launch_loop(launches):
    _card()
    _grouped_loop(pmesh.make_mesh(4, devices=["cuda"] * 4, launches=launches))


@pytest.mark.cuda
def test_grouped_loop_over_cards_equals_the_single_launch_loop():
    _cards()
    _grouped_loop(pmesh.make_mesh(4))
