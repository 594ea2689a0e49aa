"""The plain PyTorch segment scan: filter → score → selectHost → commit,
pod by pod, each step vectorized over the node axis.

This is the plain version of the fused CUDA kernel (``fused_scan.py``) and
the port of the JAX package's XLA step (``kubernetes_tpu/ops/
batch_kernel.py::make_step`` with ``axis_name=None``).  ``scan_range``
scans a pod range over a carried ``ScanState`` and returns the final state,
as a chunk of the frontier loop does (``ops/frontier.py``); with
``still_ok_steps`` it also tightens the ``still_ok`` row of each pod's
signature, as ``make_step(use_frontier=True)`` does.  ``monotone_plane``
and ``refresh`` are the plain versions of the loop's chunk-end refresh
(``ops/csrc/frontier_refresh.cu``; the JAX package's
``monotone_plane_device``).  ``scan_shards`` and ``refresh_shards`` are
the plain sharded step and refresh of the node-axis mesh
(``parallel/mesh.py``): the same step over each shard's columns, folded
across the shards at exactly the JAX package's ``_ax_*`` seams;
``scan_range`` is its one-shard case, and ``ops/csrc/mesh_scan.cu`` the
kernel held against it.  On ``device="cpu"`` these are the scan of the
main path; on a card only the tests and ``chip_smoke.py`` call them, to
hold the kernels against them.

Arithmetic contract, shared with the kernel lane for lane:

- every score is computed in int64 with exact floor division
  (``torch.div(..., rounding_mode="floor")``), so masked lanes whose
  numerators go negative floor the same way in both versions;
- the selection mask, tie rule and round-robin counter follow the
  reference's ``selectHost``: the pick is the ``(rr % ties) + 1``-th tie in
  node order, ``rr`` bumps only when at least two nodes are feasible, and no
  feasible node gives -1.

The step issues no host synchronisation: the round-robin counter and the
chosen index stay on the device until the segment ends.
"""

from __future__ import annotations

import torch

import dataclasses

from ..models.carry import ScanState, ScanStatic
from ..scheduler.units import FIXED_POINT_ONE, MAX_PRIORITY

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1
_FP = MAX_PRIORITY * FIXED_POINT_ONE


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _usage_score(requested, capacity, most: bool):
    """least/most-requested per-resource score: capacity==0 → 0 and
    requested > capacity → 0."""
    safe_cap = capacity.clamp(min=1)
    if most:
        raw = _fdiv(requested * MAX_PRIORITY, safe_cap)
    else:
        raw = _fdiv((capacity - requested) * MAX_PRIORITY, safe_cap)
    return torch.where((capacity == 0) | (requested > capacity), 0, raw)


def _balanced_score(cpu_req, cpu_cap, mem_req, mem_cap):
    f_cpu = _fdiv(cpu_req * FIXED_POINT_ONE, cpu_cap.clamp(min=1))
    f_mem = _fdiv(mem_req * FIXED_POINT_ONE, mem_cap.clamp(min=1))
    diff = (f_cpu - f_mem).abs()
    score = _fdiv(_FP - diff * MAX_PRIORITY, FIXED_POINT_ONE)
    bad = (cpu_cap == 0) | (mem_cap == 0) | (cpu_req >= cpu_cap) | (mem_req >= mem_cap)
    return torch.where(bad, 0, score)


def _normalized(raw, max_c, reverse: bool):
    """10*raw//max over feasible (0 when max == 0); the reversed variant
    scores 10*(max-raw)//max and 10 when max == 0.  ``max_c`` is the
    feasible maximum, already folded over the shards."""
    safe = max_c.clamp(min=1)
    if reverse:
        return torch.where(max_c > 0, _fdiv(MAX_PRIORITY * (max_c - raw), safe), MAX_PRIORITY)
    return torch.where(max_c > 0, _fdiv(MAX_PRIORITY * raw, safe), 0)


# -- the node-axis mesh: the step's cross-shard seams --------------------------
# The port of the JAX package's ``_ax_*`` collective seams
# (``kubernetes_tpu/ops/batch_kernel.py``: ``_ax_sum``, ``_ax_max``,
# ``_ax_min``, ``_ax_any``, ``_ax_first_true`` and the tie prefix's
# ``all_gather``).  Under a mesh every shard runs the same step over its own
# columns and these are the only points where shards exchange anything.  A
# shard's scan is a generator that yields (seam, its local value) and is sent
# the value folded over every shard; ``_lockstep`` advances all shards' scans
# to their next seam together.  One shard (the single-device scan) folds to
# its own value.

_INT32_MAX = 2**31 - 1


def _stack(vals: list) -> torch.Tensor:
    return torch.stack([v.to(vals[0].device) for v in vals])


_FOLDS = {
    "sum": lambda vals: _stack(vals).sum(dim=0),
    "max": lambda vals: _stack(vals).max(dim=0).values,
    "min": lambda vals: _stack(vals).min(dim=0).values,
    "any": lambda vals: _stack(vals).any(dim=0),
    # every shard's value in shard order (the tie prefix reads those below it)
    "gather": _stack,
}


def _lockstep(shards: list) -> list:
    """Run the shards' scans (generators) seam by seam; returns what each
    returned.  Every fold is over shard order, never arrival order."""
    sends = [None] * len(shards)
    while True:
        msgs, done = [], []
        for gen, value in zip(shards, sends):
            try:
                msgs.append(gen.send(value))
            except StopIteration as end:
                done.append(end.value)
        if done:
            if len(done) != len(shards):
                raise RuntimeError("the shards' scans left the lockstep")
            return done
        kind = msgs[0][0]
        vals = [m[1] for m in msgs]
        folded = vals[0] if len(vals) == 1 and kind != "gather" else _FOLDS[kind](vals)
        sends = [folded.to(v.device) for v in vals]


def scan(static: ScanStatic, state: ScanState) -> tuple[torch.Tensor, int]:
    """Run the segment scan; returns (chosen node index per pod [P] int32
    on the static's device, -1 = unschedulable; final round-robin
    counter).  ``state`` is left untouched."""
    chosen, final = scan_range(static, state)
    return chosen, final.round_robin


def scan_range(static: ScanStatic, state: ScanState, start: int = 0, stop: int | None = None,
               still_ok_steps: bool = False) -> tuple[torch.Tensor, ScanState]:
    """Scan pods ``start`` to ``stop`` (default: the segment's end) from the
    carried ``state``; returns (chosen node index per pod of the range,
    the final state).  ``state`` is left untouched.  Its ``still_ok``
    plane, when present, is carried; ``still_ok_steps`` ANDs each pod's
    monotone filter components into its signature's row at every step."""
    chosen, (final,) = scan_shards([static], [state], start, stop, still_ok_steps)
    return chosen, final


def scan_shards(statics: list, states: list, start: int = 0, stop: int | None = None,
                still_ok_steps: bool = False) -> tuple[torch.Tensor, list]:
    """The plain sharded step (the JAX package's ``make_step`` with
    ``axis_name`` under ``shard_map``): ``statics[k]`` / ``states[k]`` are
    shard k's slices of the node axis (``parallel.mesh.place_static`` /
    ``place_state``), all of one width, shard k owning the global columns
    from ``k * width``; the per-pod tables are replicated.  Scans pods
    ``start`` to ``stop`` and returns (the chosen global column per pod,
    each shard's final state).  One shard is ``scan_range``."""
    width = statics[0].n_pad
    if any(s.n_pad != width for s in statics):
        raise ValueError("every shard of the node axis must have the same width")
    outs = _lockstep([_shard_scan(s, st, k, k * width, start, stop, still_ok_steps)
                      for k, (s, st) in enumerate(zip(statics, states))])
    return outs[0][0], [final for _, final in outs]


def _shard_scan(static: ScanStatic, state: ScanState, rank: int, offset: int, start: int,
                stop: int | None, still_ok_steps: bool):
    """One shard's scan: the step over its columns, yielding at each seam."""
    dev = static.device
    n = static.n_pad
    w = static.weights
    i64 = torch.int64
    alloc = static.node_alloc.to(i64)
    alloc_pods = static.node_alloc_pods.to(i64)
    cpu_cap, mem_cap = alloc[:, 0], alloc[:, 1]
    g_request = static.g_request.to(i64)
    g_nonzero = static.g_nonzero.to(i64)
    spread_inc = static.spread_inc.to(i64)
    static_score = static.static_score.to(i64)
    node_aff_raw = static.node_aff_raw.to(i64)
    taint_raw = static.taint_intol_raw.to(i64)
    interpod_raw = static.interpod_raw.to(i64)
    own_w = static.own_w.to(i64)
    sym_w = static.sym_w.to(i64)
    node_domain = static.node_domain.to(i64)
    vol_limits = static.vol_limits.to(i64)
    k_range = torch.arange(vol_limits.shape[0], device=dev)
    col_ids = offset + torch.arange(n, device=dev)  # global column ids
    has_zone = static.node_zone >= 0
    zone_onehot = (
        (torch.arange(static.num_zones, device=dev)[:, None] == static.node_zone[None, :])
        & has_zone[None, :]
    )  # [Z, N]

    requested = state.requested.to(i64).clone()
    nonzero = state.nonzero_requested.to(i64).clone()
    pod_count = state.pod_count.to(i64).clone()
    ports_used = state.ports_used.clone()
    spread = state.spread_counts.to(i64).clone()
    dm = state.dm.to(i64).clone()
    downer = state.downer.to(i64).clone()
    total_match = state.total_match.to(i64).clone()
    vol_any = state.vol_any.clone()
    vol_ns = state.vol_ns.clone()
    nk = state.nk.to(i64).clone()
    still_ok = state.still_ok.clone() if state.still_ok is not None else None
    if still_ok_steps and still_ok is None:
        raise ValueError("still_ok_steps needs a seeded still_ok plane")
    rr = torch.tensor(state.round_robin, dtype=i64, device=dev)

    stop = static.p_real if stop is None else stop
    chosen_out = torch.empty(stop - start, dtype=torch.int32, device=dev)
    for k, g in enumerate(static.group_of_pod[start:stop].tolist()):
        i = start + k
        g_req = g_request[g]
        g_nz = g_nonzero[g]
        # -- feasibility ---------------------------------------------------
        # kernel: implements GeneralPredicates
        # (resources, pod count and ports here, as in fused_scan.cu; the
        # host/selector part and the node conditions ride static_ok)
        fit = ~((g_req > 0) & (requested + g_req > alloc)).any(dim=1)
        pods_ok = pod_count + 1 <= alloc_pods
        feasible = static.static_ok[g] & fit & pods_ok & static.node_exists
        if still_ok_steps:
            # monotone components only: each can only get worse as the
            # carry grows (see monotone_plane); the step never reads the
            # plane for feasibility
            still_ok[g] &= fit & pods_ok
        if static.use_ports:
            ports_ok = ~(ports_used & static.g_ports[g]).any(dim=1)
            feasible = feasible & ports_ok
            if still_ok_steps:
                still_ok[g] &= ports_ok
        if static.use_terms:
            # kernel: implements MatchInterPodAffinity
            m_g = static.term_matches_sig[:, g]  # [T]
            sym_anti_bad = ((m_g & static.is_raa)[:, None] & (downer > 0)).any(dim=0)
            first_ok = (total_match == 0) & static.self_match
            ra_ok = (dm > 0) | first_ok[:, None]
            own_ra_bad = (static.own_ra[g][:, None] & ~ra_ok).any(dim=0)
            own_raa_bad = (static.own_raa[g][:, None] & (dm > 0)).any(dim=0)
            feasible = feasible & ~sym_anti_bad & ~own_ra_bad & ~own_raa_bad
            if still_ok_steps:
                still_ok[g] &= ~sym_anti_bad & ~own_raa_bad
        if static.use_vols:
            # kernel: implements NoDiskConflict, MaxVolumeCount
            vids = static.pod_vol_ids[i].long()
            vvalid = static.pod_vol_valid[i]
            vro = static.pod_vol_ro_ok[i]
            vco = static.pod_vol_count_only[i]
            rows_any = vol_any[vids]  # [W, N]
            blocked = torch.where(vro[:, None], vol_ns[vids], rows_any)
            disk_bad = (vvalid[:, None] & blocked).any(dim=0)
            new_v = vvalid[:, None] & ~rows_any  # [W, N]
            k_onehot = (k_range[:, None] == static.pod_vol_kind[i][None, :]) & vvalid[None, :]
            count_new = (k_onehot[:, :, None] & new_v[None, :, :]).sum(dim=1)  # [K, N]
            over = k_onehot.any(dim=1)[:, None] & (nk + count_new > vol_limits[:, None])
            feasible = feasible & ~disk_bad & ~over.any(dim=0)
        n_feasible = yield "sum", feasible.sum()

        # -- scores (int64 fixed point) ------------------------------------
        cpu_req = nonzero[:, 0] + g_nz[0]
        mem_req = nonzero[:, 1] + g_nz[1]
        total = static_score[g]
        if w["least"]:
            s = _fdiv(_usage_score(cpu_req, cpu_cap, False)
                      + _usage_score(mem_req, mem_cap, False), 2)
            total = total + w["least"] * s
        if w["most"]:
            s = _fdiv(_usage_score(cpu_req, cpu_cap, True)
                      + _usage_score(mem_req, mem_cap, True), 2)
            total = total + w["most"] * s
        if w["balanced"]:
            total = total + w["balanced"] * _balanced_score(cpu_req, cpu_cap, mem_req, mem_cap)
        if w["spread"]:
            cnt = spread[g]
            max_n = yield "max", torch.where(feasible, cnt, 0).max()
            node_fp = torch.where(max_n > 0, _fdiv((max_n - cnt) * _FP, max_n.clamp(min=1)), _FP)
            # elementwise sums, not a matmul: CUDA has no integer matmul
            zsum = yield "sum", ((zone_onehot & (feasible & has_zone)[None, :])
                                 * cnt[None, :]).sum(dim=1)  # [Z], replicated
            max_z = zsum.max()
            zcnt = (zone_onehot.to(i64) * zsum[:, None]).sum(dim=0)  # zsum[zone] per node
            zone_fp = torch.where(max_z > 0, _fdiv((max_z - zcnt) * _FP, max_z.clamp(min=1)), _FP)
            any_zone = yield "any", (feasible & has_zone).any()
            have_zones = static.g_has_spread[g] & any_zone
            total_fp = torch.where(have_zones & has_zone, _fdiv(node_fp + 2 * zone_fp, 3), node_fp)
            total = total + w["spread"] * _fdiv(total_fp, FIXED_POINT_ONE)
        if w["node_affinity"]:
            raw = node_aff_raw[g]
            max_c = yield "max", torch.where(feasible, raw, 0).max()
            total = total + w["node_affinity"] * _normalized(raw, max_c, False)
        if w["taint"]:
            raw = taint_raw[g]
            max_c = yield "max", torch.where(feasible, raw, 0).max()
            total = total + w["taint"] * _normalized(raw, max_c, True)
        if w["interpod"]:
            raw = interpod_raw[g]
            if static.use_terms:
                raw = raw + (own_w[g][:, None] * dm).sum(dim=0) \
                    + ((m_g.to(i64) * sym_w)[:, None] * downer).sum(dim=0)
            max_c = (yield "max", torch.where(feasible, raw, _I64_MIN).max()).clamp(min=0)
            min_c = (yield "min", torch.where(feasible, raw, _I64_MAX).min()).clamp(max=0)
            rng = max_c - min_c
            s = torch.where(rng > 0, _fdiv(MAX_PRIORITY * (raw - min_c), rng.clamp(min=1)), 0)
            total = total + w["interpod"] * s

        # -- selectHost ------------------------------------------------------
        max_score = yield "max", torch.where(feasible, total, _I64_MIN).max()
        ties = feasible & (total == max_score)
        t_local = ties.sum()
        t_count = yield "sum", t_local
        idx = rr % t_count.clamp(min=1)
        # the global running tie count in node order: the local cumsum
        # shifted by the ties of the shards before this one
        below = (yield "gather", t_local)[:rank].sum()
        cum = torch.cumsum(ties.to(i64), dim=0) + below
        hit = ties & (cum == idx + 1)
        # the first hit in global column order: a shard with none offers
        # INT32_MAX, and n_feasible == 0 is guarded below
        cand = torch.where(hit.any(), offset + torch.argmax(hit.to(torch.int8)), _INT32_MAX)
        pick = yield "min", cand
        chosen = torch.where(n_feasible == 0, -1, pick)
        rr = rr + (n_feasible >= 2).to(i64)
        chosen_out[k] = chosen

        # -- commit: only the owning shard's columns change --------------------
        landed = chosen >= 0
        onehot = col_ids == chosen  # all False when chosen == -1 or on another shard
        oh = onehot.to(i64)
        requested += oh[:, None] * g_req[None, :]
        nonzero += oh[:, None] * g_nz[None, :]
        pod_count += oh
        if static.use_ports:
            ports_used |= onehot[:, None] & static.g_ports[g][None, :]
        spread += spread_inc[:, g][:, None] * oh[None, :]
        if static.use_terms:
            d_at = yield "sum", (node_domain * oh[None, :]).sum(dim=1)  # [T]
            valid_at = yield "any", (static.dom_valid & onehot[None, :]).any(dim=1)
            same_dom = (node_domain == d_at[:, None]) & static.dom_valid & valid_at[:, None]
            m_i = (m_g & landed).to(i64)
            own_i = (static.own_all[g] & landed).to(i64)
            dm += same_dom.to(i64) * m_i[:, None]
            downer += same_dom.to(i64) * own_i[:, None]
            total_match += m_i
        if static.use_vols:
            # count-only and unused slots aim at the sentinel row, which
            # must stay empty: they never write occupancy
            vol_upd = (vvalid & ~vco & landed)[:, None] & onehot[None, :]
            vol_any[vids] = vol_any[vids] | vol_upd
            vol_ns[vids] = vol_ns[vids] | (vol_upd & ~vro[:, None])
            newv_at = yield "any", (new_v & onehot[None, :]).any(dim=1)  # [W]
            newv_chosen = vvalid & newv_at & landed
            nk += (k_onehot & newv_chosen[None, :]).sum(dim=1)[:, None] * oh[None, :]
    i32 = torch.int32
    final = ScanState(
        requested=requested.to(i32), nonzero_requested=nonzero.to(i32),
        pod_count=pod_count.to(i32), ports_used=ports_used, spread_counts=spread.to(i32),
        # device: sync — the plain sharded scan's counter, read once at the segment's end
        round_robin=int(rr), dm=dm.to(i32), downer=downer.to(i32),
        total_match=total_match.to(i32), vol_any=vol_any, vol_ns=vol_ns, nk=nk.to(i32),
        still_ok=still_ok)
    return chosen_out, final


def monotone_plane(static: ScanStatic, state: ScanState) -> torch.Tensor:
    """The monotone feasibility plane [G, N] at ``state``: static_ok,
    existence, resource fit, pod count, host ports, own required
    anti-affinity (``dm > 0``) and placed owners' symmetric required
    anti-affinity (``downer > 0``).  Every component only gets worse as
    the carry grows.  The tensor twin of ``models.snapshot.monotone_plane``
    and of the JAX package's ``monotone_plane_device``; the term products
    there are integer matmuls, here per-term loops (no integer matmul on
    CUDA)."""
    # kernel: implements GeneralPredicates
    # (the same resource/pod-count/port masks as the step, over [G, N];
    # frontier_refresh.cu is its kernel)
    i64 = torch.int64
    g_req = static.g_request.to(i64)  # [G, R]
    fit = torch.ones(static.static_ok.shape, dtype=torch.bool, device=static.device)
    for r in range(g_req.shape[1]):
        need = g_req[:, r, None]
        fit &= (state.requested[None, :, r].to(i64) + need
                <= static.node_alloc[None, :, r].to(i64)) | (need <= 0)
    pods_ok = state.pod_count.to(i64) + 1 <= static.node_alloc_pods.to(i64)
    mono = static.static_ok & static.node_exists[None, :] & fit & pods_ok[None, :]
    if static.use_ports:
        for q in range(static.g_ports.shape[1]):
            mono &= ~(static.g_ports[:, q, None] & state.ports_used[None, :, q])
    if static.use_terms:
        sym = static.term_matches_sig & static.is_raa[:, None]  # [T, G]
        for t in range(static.term_matches_sig.shape[0]):
            mono &= ~(static.own_raa[:, t, None] & (state.dm[t] > 0)[None, :])
            mono &= ~(sym[t][:, None] & (state.downer[t] > 0)[None, :])
    return mono


def alive_of(still_ok: torch.Tensor, node_exists: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The G-union alive mask [N] (a node some signature may still take)
    and its count."""
    alive = still_ok.any(dim=0) & node_exists
    return alive, int(alive.sum())


def refresh(static: ScanStatic, state: ScanState, thresh: int
            ) -> tuple[ScanState, torch.Tensor, int, bool]:
    """The plain version of the frontier loop's chunk-end refresh
    (``ops/csrc/frontier_refresh.cu``): ``still_ok &= monotone_plane``,
    the alive mask and count, and the compaction flag ``n_alive <=
    thresh`` (``thresh`` -1: never).  Returns (the state with the new
    plane, alive, n_alive, stop)."""
    still_ok = state.still_ok & monotone_plane(static, state)
    alive, n_alive = alive_of(still_ok, static.node_exists)
    return dataclasses.replace(state, still_ok=still_ok), alive, n_alive, n_alive <= thresh


def refresh_shards(statics: list, states: list, thresh: int
                   ) -> tuple[list, list, int, bool]:
    """``refresh`` run per shard (the refresh of the JAX package's sharded
    loop): each shard tightens its own slice, and the alive count that
    decides the compaction flag is summed over the shards.  Returns (the
    shards' states, their alive masks, n_alive, stop)."""
    outs = [refresh(s, st, -1) for s, st in zip(statics, states)]
    n_alive = sum(n for _, _, n, _ in outs)
    return [o[0] for o in outs], [o[1] for o in outs], n_alive, n_alive <= thresh
