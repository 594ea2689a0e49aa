"""The frontier loop's kernels on the card: the fused scan's chunk launch
(a pod range, the counter in device memory, the stop flag, the cursor and
the state's write-back) and the ``frontier_refresh`` kernel, each against
its plain version (``scan_ref.scan_range`` / ``scan_ref.refresh``); and
``FrontierRun`` on the card against the same run on the CPU.  Every test
here needs a card and skips elsewhere with a reason; on the CPU the loop's
plain path is covered by ``tests/test_torch_frontier.py``.  This file
imports nothing of the JAX package, so it also runs where only the port
is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_frontier_kernel.py

Tolerance: exact equality of chosen nodes, counters, every state plane,
the refreshed plane, the alive mask and count."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, scan_ref
from kubernetes_tpu_torch.ops.frontier import FrontierRun
from tests import torch_port_cases as cases

PORT = cases.PORT
STATE = ("requested", "nonzero_requested", "pod_count", "ports_used", "spread_counts",
         "dm", "downer", "total_match", "vol_any", "vol_ns", "nk")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the frontier loop's kernels have no CPU mode")


def _segment(case, seed_plane=True, **kw):
    static, init = cases.tensorize(PORT, case, **kw)
    if seed_plane:
        cases.mods(PORT).snapshot.frontier_seed(static, init)
    return from_reference(vars(static), vars(init), "cuda")


def _same_state(got, want, what):
    for f in STATE:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a.to(b.dtype), b), f"{what}: {f} differs"
    assert got.round_robin == want.round_robin, what


def _chunks(s, st, pl, chunk, ctl):
    bufs = fused_scan.pack(s, st, pl)
    want_state, done = st, 0
    for first in range(0, s.p_real, chunk):
        last = min(first + chunk, s.p_real)
        fused_scan.launch(s, st, bufs, pl, start=first, count=last - first, ctl=ctl)
        torch.cuda.synchronize()
        want, want_state = scan_ref.scan_range(s, want_state, first, last)
        assert torch.equal(bufs["chosen"][first:last], want), f"chunk at {first}"
        got_state = fused_scan.unpack_state(s, bufs, int(ctl[fused_scan.CTL_RR]))
        _same_state(got_state, want_state, f"after the chunk at {first}")
        done += 1
        assert int(ctl[fused_scan.CTL_CURSOR]) == done
    return bufs, want_state


@pytest.mark.cuda
@pytest.mark.parametrize("case,kw", [
    ("mixed", {}), ("plain", {}), ("terms_only", {}), ("volumes_only", {}), ("ties", {}),
    ("host_ports", {"n_ports": 40, "n_nodes": 24}),
    ("many_zones", {"n_zones": 16}),
    # past shared memory's zone budget at 4 blocks: the global zone scratch
    ("many_zones", {"n_zones": 1000, "n_nodes": 1000, "n_pods": 120})])
def test_chunk_launches_match_scan_range(case, kw):
    """Chunks of 7 pods, each a launch over the carried, written-back state,
    equal the plain scan's chunks plane for plane."""
    _card()
    s, st = _segment(case, seed_plane=False, **kw)
    st = dataclasses.replace(st, round_robin=5)
    pl = fused_scan.plan(s)
    if kw.get("n_zones") == 1000:
        assert pl.zones_at == "global"
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device="cuda")
    ctl[fused_scan.CTL_RR] = st.round_robin
    _chunks(s, st, pl, 7, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("smem_limit", [60000, 24000])
def test_chunk_launches_with_planes_in_global_memory(monkeypatch, smem_limit):
    """A smaller shared-memory budget leaves state planes in global memory
    (updated in place) beside the written-back shared ones."""
    _card()
    s, st = _segment("mixed", seed_plane=False, n_nodes=200, n_pods=90)
    monkeypatch.setattr(fused_scan, "SMEM_LIMIT", smem_limit)
    pl = fused_scan.plan(s)
    assert {"req", "spread"} & set(pl.global_), pl.global_
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device="cuda")
    _chunks(s, st, pl, 16, ctl)


@pytest.mark.cuda
def test_a_raised_stop_flag_makes_launches_no_ops():
    _card()
    s, st = _segment("mixed", seed_plane=False)
    pl = fused_scan.plan(s)
    bufs = fused_scan.pack(s, st, pl)
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device="cuda")
    ctl[fused_scan.CTL_STOP] = 1
    ctl[fused_scan.CTL_RR] = 3
    before = {k: v.clone() for k, v in bufs.items() if k not in ("res",)}
    ctl_before = ctl.clone()
    fused_scan.launch(s, st, bufs, pl, start=0, count=8, ctl=ctl)
    still = torch.ones((s.static_ok.shape[0], pl.ns), dtype=torch.bool, device="cuda")
    alive = torch.zeros(pl.ns, dtype=torch.bool, device="cuda")
    frontier_refresh.launch(s, bufs, pl, still, alive, ctl, 10**6)
    torch.cuda.synchronize()
    for k, v in before.items():
        assert torch.equal(bufs[k], v), k
    assert torch.equal(ctl, ctl_before) and still.all() and not alive.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "terms_only", "host_ports", "ties"])
def test_refresh_kernel_matches_plain_refresh(case):
    """After a few chunks: the kernel's still_ok, alive mask, count and
    stop flag equal ``scan_ref.refresh`` on the unpacked state, from an
    all-True plane (the strictest test of the monotone plane) and from the
    seeded one, with a threshold on each side of the count."""
    _card()
    kw = {"n_ports": 40, "n_nodes": 24} if case == "host_ports" else {}
    s, st = _segment(case, **kw)
    pl = fused_scan.plan(s)
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device="cuda")
    ctl[fused_scan.CTL_RR] = st.round_robin
    bufs, want_state = _chunks(s, st, pl, max(1, s.p_real // 3), ctl)
    g, n = s.static_ok.shape[0], s.n_pad
    for start_plane in (torch.ones((g, n), dtype=torch.bool, device="cuda"), st.still_ok):
        plain_in = dataclasses.replace(want_state, still_ok=start_plane)
        _, _, n_alive, _ = scan_ref.refresh(s, plain_in, -1)
        for thresh in (-1, n_alive - 1, n_alive):
            want, alive, want_n, stop = scan_ref.refresh(s, plain_in, thresh)
            still = torch.zeros((g, pl.ns), dtype=torch.bool, device="cuda")
            still[:, :n] = start_plane
            got_alive = torch.ones(pl.ns, dtype=torch.bool, device="cuda")
            ctl[fused_scan.CTL_STOP] = 0
            frontier_refresh.launch(s, bufs, pl, still, got_alive, ctl, thresh)
            torch.cuda.synchronize()
            assert torch.equal(still[:, :n], want.still_ok) and not still[:, n:].any()
            assert torch.equal(got_alive[:n], alive) and not got_alive[n:].any()
            assert int(ctl[fused_scan.CTL_ALIVE]) == want_n
            assert bool(ctl[fused_scan.CTL_STOP]) == stop
            assert int(ctl[fused_scan.CTL_ACC]) == 0 and int(ctl[fused_scan.CTL_DONE]) == 0


def _tie_segment(device, n=16, pods=110):
    M = cases.mods(PORT)
    m = {}
    for i in range(n):
        node = M.tu.make_node(f"node-{i:03d}", cpu="64", memory="64Gi", pods=2 + i // 2,
                              labels={cases.HOST: f"node-{i:03d}"})
        m[node.meta.name] = M.NodeInfo(node)
    pod_list = [M.tu.make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi", labels={"app": "web"})
                for i in range(pods)]
    pctx = M.PriorityContext(m)
    tz = M.snapshot.Tensorizer()
    static = tz.build_static(pod_list, m, pctx)
    init = tz.initial_state(static, m, pctx, pod_list)
    M.snapshot.frontier_seed(static, init)
    return from_reference(vars(static), vars(init), device)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,min_width", [(16, 8), (8, 2), (64, 8)])
def test_frontier_run_on_card_equals_the_cpu_run(chunk, min_width):
    """The loop on the card (chunk and refresh launches, compactions by
    gather and re-pack) gives the CPU run's chosen nodes, counter and
    trajectory, and the full-width kernel's."""
    _card()
    runs = {}
    for dev in ("cpu", "cuda"):
        run = FrontierRun(*_tie_segment(dev), chunk_len=chunk, min_width=min_width)
        runs[dev] = (run.finalize(), run.stats)
    (c_cpu, rr_cpu), st_cpu = runs["cpu"]
    (c_gpu, rr_gpu), st_gpu = runs["cuda"]
    np.testing.assert_array_equal(c_gpu, c_cpu)
    assert rr_gpu == rr_cpu and st_gpu == st_cpu
    assert st_gpu["host_syncs"] <= st_gpu["compactions"] + 2
    full, full_rr = fused_scan.schedule(*_tie_segment("cuda"))
    np.testing.assert_array_equal(c_gpu, full)
    assert rr_gpu == full_rr
