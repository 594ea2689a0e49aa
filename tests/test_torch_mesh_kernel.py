"""The mesh kernel (``ops/csrc/mesh_scan.cu``) on the card: a whole
segment at 2, 4 and 8 shards against the plain sharded step
(``scan_ref.scan_shards``) and the fused scan (also a segment with planes
left in global memory and one with its zone totals there), and the sharded frontier
loop (``FrontierRun(mesh=)``: mesh launches a chunk, the refresh a shard)
against the same loop on the CPU.  Every test here needs a card and skips
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
