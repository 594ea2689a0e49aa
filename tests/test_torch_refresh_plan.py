"""The frontier refresh's host planner and its tile walk, on the CPU.

``frontier_refresh.plan`` lays the [G, ns] plane out as a grid of column
tiles by signature groups; the kernel (``csrc/frontier_refresh.cu``) stages
each tile's column state and its group's rows of the signature table (each
signature row reduced, once a packing, to its requests and the rows it
names) in shared memory, and walks only those.  Here, with no card:

- the plan covers every (signature, column) cell exactly once, a thread
  ``CPT`` neighbouring columns of one signature, within the shared-memory
  budget, with at least ``MIN_BLOCKS`` blocks at the main width;
- a plain torch emulation of the kernel's walk (tile by tile, group by
  group, the named rows ``kcap`` at a time) equals ``scan_ref.refresh``;
- ``scan_ref.refresh``'s plane, alive mask and count equal the JAX
  package's ``monotone_plane_device`` (on the CPU, as
  ``test_torch_frontier.py`` runs it) and its alive count at the planner's
  edge shapes.

The kernel itself is held against ``scan_ref.refresh`` by the ``cuda`` tests
in ``test_torch_frontier_kernel.py`` and by ``chip_smoke.py``.

Tolerance: exact equality (integers and bools)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.batch_kernel import monotone_plane_device
from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import frontier_refresh as fr
from kubernetes_tpu_torch.ops import fused_scan, scan_ref
from tests import torch_port_cases as cases

GS = (1, 7, 32, 200)
WIDTHS = (128, 1024, 5120, 20224)
# (terms, host-port slots): off, terms only, ports only (more than a warp's
# 32 slots), both
KINDS = ((0, 0), (4, 0), (0, 40), (4, 40))
R = 4


def _plan(g, ns, t, pv):
    return fr.plan_for(ns, g, R, t, pv, t > 0, pv > 0)


def _cells(rp):
    """How many times the plan's threads cover each [G, ns] cell: block
    (x, y), thread -> signature y * gs + tid // (cols / CPT), columns x *
    cols + (tid % (cols / CPT)) * CPT + [0, CPT), where both lie inside."""
    x = np.arange(rp.tiles)[:, None, None]
    y = np.arange(rp.groups)[None, :, None]
    tid = np.arange(rp.threads)[None, None, :]
    qpr = rp.cols // fr.CPT
    gl, c0 = tid // qpr, (tid % qpr) * fr.CPT
    base = x * rp.cols
    gn = np.minimum(rp.gs, rp.g - y * rp.gs)
    mine = (gl < gn) & (c0 < np.minimum(rp.cols, rp.ns - base))
    g = np.broadcast_to(y * rp.gs + gl, mine.shape)[mine]
    col = np.broadcast_to(base + c0, mine.shape)[mine]
    count = np.zeros((rp.g, rp.ns), dtype=np.int32)
    for i in range(fr.CPT):
        np.add.at(count, (g, col + i), 1)
    return count


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"t{k[0]}-pv{k[1]}")
@pytest.mark.parametrize("ns", WIDTHS)
@pytest.mark.parametrize("g", GS)
def test_plan_covers_every_cell_once_within_budget(g, ns, kind):
    t, pv = kind
    rp = _plan(g, ns, t, pv)
    assert (_cells(rp) == 1).all()
    assert rp.cols in fr.COLS and (rp.cols % 32 == 0 or rp.groups == 1)
    assert rp.tiles < 1 << fr.TILE_BITS
    assert rp.threads == rp.gs * rp.cols // fr.CPT and rp.threads % 32 == 0
    assert 32 <= rp.threads <= fr.MAX_THREADS
    assert rp.tiles == -(-ns // rp.cols) and rp.groups == -(-g // rp.gs)
    assert rp.named == 2 * t + pv and (rp.kcap >= 1 if rp.named else rp.kcap == 0)
    assert rp.tw % 4 == 0 and rp.tw >= R + 1 + rp.named
    # every region 16-byte aligned, in order, none overlapping, within budget
    end = 0
    for k in fr.REGIONS:
        off = rp.offsets[k]
        assert off % 16 == 0 and off >= end
        end = off + rp.region_bytes[k]
    assert end <= rp.smem_bytes <= fr.BUDGET
    assert rp.smem_bytes + fr.STATIC_RESERVE <= fused_scan.SMEM_LIMIT
    if g >= 32 and ns >= 5120:
        assert rp.blocks >= fr.MIN_BLOCKS


def test_main_width_fills_the_card():
    """chip_smoke's main segment: 32 signatures x 5120 columns, 4 terms,
    ports off: at least two blocks an SM and no idle signature slot."""
    rp = _plan(32, 5120, 4, 0)
    assert rp.blocks >= 264 and rp.groups == 1 and rp.gs == 32
    # every dm and downer row staged with the tile
    assert rp.kcap == rp.named == 8


def test_a_row_too_wide_for_any_tiling_is_refused_by_the_planner():
    with pytest.raises(ValueError, match="no refresh tiling fits"):
        _plan(30, 1024, 4, 40000)


def test_plan_of_a_real_segment_uses_the_fused_plan():
    static, init = cases.tensorize(cases.PORT, "mixed")
    s, _ = from_reference(vars(static), vars(init), "cpu")
    pl = fused_scan.plan(s)
    rp = fr.plan(s, pl)
    d = fused_scan._dims(s)
    assert (rp.ns, rp.g) == (pl.ns, d["g"])
    assert rp.named == (2 * d["t"] if s.use_terms else 0) + (d["pv"] if s.use_ports else 0)


# ---- the kernel's walk, emulated ---------------------------------------------

def reduced_rows(static, bufs, pl):
    """Each signature's requests and the row ids it names, read from the
    fused scan's packed signature rows (``signature_rows``): dm rows of
    its own required anti-affinity terms (``te[3]``), downer rows of the
    required anti-affinity terms that match it (``te[7]``), its set port
    slots."""
    d = fused_scan._dims(static)
    r = d["r"]
    t = d["t"] if static.use_terms else 0
    pv = d["pv"] if static.use_ports else 0
    port0 = r + 4 + fused_scan.TERM_FIELDS * d["t"]
    out = []
    for sg in bufs["sig"].tolist():
        assert len(sg) == pl.sw
        rows = set()
        for a in range(sg[r + 3] if t else 0):
            te = sg[r + 4 + a * fused_scan.TERM_FIELDS:]
            if te[3]:
                rows.add(te[0])
            if te[7]:
                rows.add(t + te[0])
        rows |= {2 * t + q for q in range(pv) if sg[port0 + q]}
        out.append((sg[:r], sorted(rows)))
    return out


def walk(static, bufs, pl, still, thresh):
    """The kernel's algorithm in plain torch over the packed ``bufs``, block
    by block as ``frontier_refresh.plan`` lays the grid out: stage the
    tile's column rows and the group's rows of the signature table (each
    signature's requests and the rows it names, which must equal what its
    packed signature row says), number every row (where they fit one
    stage) or the named rows' union in row order, and walk each
    signature's requests with need > 0 and its rows, ``kcap`` at a time.
    Returns (plane, alive, n_alive, stop)."""
    rp = fr.plan(static, pl)
    d = fused_scan._dims(static)
    r, ns = d["r"], pl.ns
    t = d["t"] if static.use_terms else 0
    tab = fr.signature_table(static, rp.tw)
    for row, (needs, rows) in zip(tab.tolist(), reduced_rows(static, bufs, pl)):
        assert row[:r] == needs and row[r] == len(rows) and row[r + 1:r + 1 + len(rows)] == rows
    b = bufs
    still = still.clone()
    alive = torch.zeros(ns, dtype=torch.bool)
    n_alive = 0
    for x in range(rp.tiles):
        cs = slice(x * rp.cols, min(ns, (x + 1) * rp.cols))
        req, alloc = b["req"][:, cs], b["alloc"][:, cs]
        base = (b["exists"][cs] != 0) & (b["cnt"][cs] + 1 <= b["alloc_pods"][cs])
        col_alive = torch.zeros(cs.stop - cs.start, dtype=torch.bool)
        for y in range(rp.groups):
            g0 = y * rp.gs
            rows_of = tab[g0:min(d["g"], g0 + rp.gs)].tolist()
            resources = [[(k, row[k]) for k in range(r) if row[k] > 0] for row in rows_of]
            named = [row[r + 1:r + 1 + row[r]] for row in rows_of]
            # every row staged with the tile where they fit one stage, else
            # the rows named, in row order
            union = (list(range(rp.named)) if rp.kcap >= rp.named
                     else sorted(set().union(*named)))
            slot = {rid: k for k, rid in enumerate(union)}
            lists = [sorted(slot[rid] for rid in rows) for rows in named]

            def row(rid):
                if rid < t:
                    return b["dm"][rid, cs]
                if rid < 2 * t:
                    return b["downer"][rid - t, cs]
                return b["ports"][rid - 2 * t, cs]

            for gl, (res, lst) in enumerate(zip(resources, lists)):
                g = g0 + gl
                m = still[g, cs] & (b["static_ok"][g, cs] != 0) & base
                for k, need in res:
                    m &= req[k].long() + need <= alloc[k].long()
                for k0 in range(0, len(union), rp.kcap or 1):
                    staged = {s: row(union[s]) for s in range(k0, min(len(union), k0 + rp.kcap))}
                    for s in lst:
                        if s in staged:
                            m &= staged[s] <= 0
                still[g, cs] = m
                col_alive |= m
        alive[cs] = col_alive
        n_alive += int(col_alive.sum())
    return still, alive, n_alive, n_alive <= thresh


def _packed(static, init):
    s, st = from_reference(static, init, "cpu")
    pl = fused_scan.plan(s)
    bufs = fused_scan.pack(s, st, pl)
    still = torch.zeros((s.static_ok.shape[0], pl.ns), dtype=torch.bool)
    still[:, :s.n_pad] = st.still_ok
    return s, st, pl, bufs, still


def _held(s, st, pl, bufs, still):
    n = s.n_pad
    _, _, n_ref, _ = scan_ref.refresh(s, st, -1)
    for thresh in (-1, n_ref - 1, n_ref):
        want, want_alive, want_n, want_stop = scan_ref.refresh(s, st, thresh)
        got, alive, n_alive, stop = walk(s, bufs, pl, still, thresh)
        assert torch.equal(got[:, :n], want.still_ok) and not got[:, n:].any()
        assert torch.equal(alive[:n], want_alive) and not alive[n:].any()
        assert (n_alive, stop) == (want_n, want_stop)


@pytest.mark.parametrize("g,n,t,pv", [
    (1, 128, 0, 0), (7, 1024, 4, 40), (32, 5120, 4, 0), (200, 128, 4, 40),
    (7, 200, 0, 40),  # a packed width of 208: a ragged last tile
    (3, 100, 4, 300),  # a port row of 300 slots
])
def test_walk_equals_scan_ref_at_edge_shapes(g, n, t, pv):
    static, init = cases.refresh_segment(g, n, t, pv, use_terms=t > 0, use_ports=pv > 0,
                                         seed=g + n)
    _held(*_packed(static, init))


@pytest.mark.parametrize("case,kw", [("mixed", {}), ("terms_only", {}), ("ties", {}),
                                     ("host_ports", {"n_ports": 40, "n_nodes": 24})])
def test_walk_equals_scan_ref_on_tensorized_segments(case, kw):
    """Real segments after their first third of pods, from an all-True
    plane and from the frontier seed."""
    static, init = cases.tensorize(cases.PORT, case, **kw)
    cases.mods(cases.PORT).snapshot.frontier_seed(static, init)
    s, st = from_reference(vars(static), vars(init), "cpu")
    _, st = scan_ref.scan_range(s, st, 0, max(1, s.p_real // 3))
    pl = fused_scan.plan(s)
    bufs = fused_scan.pack(s, st, pl)
    g, n = s.static_ok.shape[0], s.n_pad
    for start in (torch.ones((g, n), dtype=torch.bool), st.still_ok):
        st_in = dataclasses.replace(st, still_ok=start)
        still = torch.zeros((g, pl.ns), dtype=torch.bool)
        still[:, :n] = start
        _held(s, st_in, pl, bufs, still)


def test_walk_stages_named_rows_in_several_chunks(monkeypatch):
    """With two named rows a chunk the walk still equals the plain
    refresh (the kernel's chunk loop)."""
    monkeypatch.setattr(fr, "KCAP_MAX", 2)
    fr.plan_for.cache_clear()
    try:
        static, init = cases.refresh_segment(7, 1024, 4, 40, use_ports=True, seed=3)
        s, st, pl, bufs, still = _packed(static, init)
        rp = fr.plan(s, pl)
        assert rp.kcap == 2 and rp.named == 48
        _held(s, st, pl, bufs, still)
    finally:
        fr.plan_for.cache_clear()


# ---- scan_ref.refresh against the JAX device plane ---------------------------

def _jax_refresh(static, init):
    """The JAX package's ``monotone_plane_device`` on the segment's arrays
    (the fields it reads), the plane ANDed into ``still_ok``, and the
    loop's alive count."""
    a = jnp.asarray
    dev = SimpleNamespace(
        g_request=a(static["g_request"]), node_alloc=a(static["node_alloc"]),
        node_alloc_pods=a(static["node_alloc_pods"]), static_ok=a(static["static_ok"]),
        node_exists=a(static["node_exists"]), g_ports=a(static["g_ports"]),
        own_raa=a(static["own_raa"]), term_matches_sig=a(static["term_matches_sig"]),
        is_raa=a(static["is_raa"]))
    state = SimpleNamespace(requested=a(init["requested"]), pod_count=a(init["pod_count"]),
                            ports_used=a(init["ports_used"]), dm=a(init["dm"]),
                            downer=a(init["downer"]))
    mono = np.asarray(monotone_plane_device(dev, state, bool(static["terms"]),
                                            bool(static["use_ports"])))
    still = init["still_ok"] & mono
    alive = still.any(axis=0) & static["node_exists"]
    return still, alive, int(alive.sum())


@pytest.mark.parametrize("ns", WIDTHS)
@pytest.mark.parametrize("g", GS)
def test_scan_ref_refresh_equals_the_jax_device_plane(g, ns):
    """At the planner's edge shapes, each with the terms and ports in turn
    (every kind at each width)."""
    t, pv = KINDS[(GS.index(g) + WIDTHS.index(ns)) % len(KINDS)]
    static, init = cases.refresh_segment(g, ns, t, pv, use_terms=t > 0, use_ports=pv > 0,
                                         seed=7 * g + ns)
    want_still, want_alive, want_n = _jax_refresh(static, init)
    s, st = from_reference(static, init, "cpu")
    got, alive, n_alive, stop = scan_ref.refresh(s, st, want_n)
    np.testing.assert_array_equal(got.still_ok.numpy(), want_still)
    np.testing.assert_array_equal(alive.numpy(), want_alive)
    assert n_alive == want_n and stop
