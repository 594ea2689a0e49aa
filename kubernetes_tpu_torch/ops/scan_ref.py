"""The plain PyTorch segment scan: filter → score → selectHost → commit,
pod by pod, each step vectorized over the node axis.

This is the plain version of the fused CUDA kernel (``fused_scan.py``) and
the port of the JAX package's XLA step (``kubernetes_tpu/ops/
batch_kernel.py::make_step`` with ``axis_name=None``, no frontier plane).
On ``device="cpu"`` it is the scan of the main path; on a card only the
tests and ``chip_smoke.py`` call it, to hold the kernel against it.

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


def _normalized_max(raw, feasible, reverse: bool):
    """10*raw//max over feasible (0 when max == 0); the reversed variant
    scores 10*(max-raw)//max and 10 when max == 0."""
    max_c = torch.where(feasible, raw, 0).max()
    safe = max_c.clamp(min=1)
    if reverse:
        return torch.where(max_c > 0, _fdiv(MAX_PRIORITY * (max_c - raw), safe), MAX_PRIORITY)
    return torch.where(max_c > 0, _fdiv(MAX_PRIORITY * raw, safe), 0)


def scan(static: ScanStatic, state: ScanState) -> tuple[torch.Tensor, int]:
    """Run the segment scan; returns (chosen node index per pod [P] int32
    on the static's device, -1 = unschedulable; final round-robin
    counter).  ``state`` is left untouched."""
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
    col_ids = torch.arange(n, device=dev)
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
    rr = torch.tensor(state.round_robin, dtype=i64, device=dev)

    p_real = static.p_real
    chosen_out = torch.empty(p_real, dtype=torch.int32, device=dev)
    for i, g in enumerate(static.group_of_pod.tolist()):
        g_req = g_request[g]
        g_nz = g_nonzero[g]
        # -- feasibility ---------------------------------------------------
        fit = ~((g_req > 0) & (requested + g_req > alloc)).any(dim=1)
        pods_ok = pod_count + 1 <= alloc_pods
        feasible = static.static_ok[g] & fit & pods_ok & static.node_exists
        if static.use_ports:
            feasible = feasible & ~(ports_used & static.g_ports[g]).any(dim=1)
        if static.use_terms:
            m_g = static.term_matches_sig[:, g]  # [T]
            sym_anti_bad = ((m_g & static.is_raa)[:, None] & (downer > 0)).any(dim=0)
            first_ok = (total_match == 0) & static.self_match
            ra_ok = (dm > 0) | first_ok[:, None]
            own_ra_bad = (static.own_ra[g][:, None] & ~ra_ok).any(dim=0)
            own_raa_bad = (static.own_raa[g][:, None] & (dm > 0)).any(dim=0)
            feasible = feasible & ~sym_anti_bad & ~own_ra_bad & ~own_raa_bad
        if static.use_vols:
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
        n_feasible = feasible.sum()

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
            max_n = torch.where(feasible, cnt, 0).max()
            node_fp = torch.where(max_n > 0, _fdiv((max_n - cnt) * _FP, max_n.clamp(min=1)), _FP)
            # elementwise sums, not a matmul: CUDA has no integer matmul
            zsum = ((zone_onehot & (feasible & has_zone)[None, :]) * cnt[None, :]).sum(dim=1)
            max_z = zsum.max()
            zcnt = (zone_onehot.to(i64) * zsum[:, None]).sum(dim=0)  # zsum[zone] per node
            zone_fp = torch.where(max_z > 0, _fdiv((max_z - zcnt) * _FP, max_z.clamp(min=1)), _FP)
            have_zones = static.g_has_spread[g] & (feasible & has_zone).any()
            total_fp = torch.where(have_zones & has_zone, _fdiv(node_fp + 2 * zone_fp, 3), node_fp)
            total = total + w["spread"] * _fdiv(total_fp, FIXED_POINT_ONE)
        if w["node_affinity"]:
            total = total + w["node_affinity"] * _normalized_max(node_aff_raw[g], feasible, False)
        if w["taint"]:
            total = total + w["taint"] * _normalized_max(taint_raw[g], feasible, True)
        if w["interpod"]:
            raw = interpod_raw[g]
            if static.use_terms:
                raw = raw + (own_w[g][:, None] * dm).sum(dim=0) \
                    + ((m_g.to(i64) * sym_w)[:, None] * downer).sum(dim=0)
            max_c = torch.where(feasible, raw, _I64_MIN).max().clamp(min=0)
            min_c = torch.where(feasible, raw, _I64_MAX).min().clamp(max=0)
            rng = max_c - min_c
            s = torch.where(rng > 0, _fdiv(MAX_PRIORITY * (raw - min_c), rng.clamp(min=1)), 0)
            total = total + w["interpod"] * s

        # -- selectHost ------------------------------------------------------
        max_score = torch.where(feasible, total, _I64_MIN).max()
        ties = feasible & (total == max_score)
        idx = rr % ties.sum().clamp(min=1)
        cum = torch.cumsum(ties.to(i64), dim=0)
        pick = torch.argmax((ties & (cum == idx + 1)).to(torch.int8))
        chosen = torch.where(n_feasible == 0, -1, pick)
        rr = rr + (n_feasible >= 2).to(i64)
        chosen_out[i] = chosen

        # -- commit ------------------------------------------------------------
        landed = chosen >= 0
        onehot = col_ids == chosen  # all False when chosen == -1
        oh = onehot.to(i64)
        requested += oh[:, None] * g_req[None, :]
        nonzero += oh[:, None] * g_nz[None, :]
        pod_count += oh
        if static.use_ports:
            ports_used |= onehot[:, None] & static.g_ports[g][None, :]
        spread += spread_inc[:, g][:, None] * oh[None, :]
        if static.use_terms:
            d_at = (node_domain * oh[None, :]).sum(dim=1)  # [T]
            valid_at = (static.dom_valid & onehot[None, :]).any(dim=1)
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
            newv_chosen = vvalid & (new_v & onehot[None, :]).any(dim=1) & landed
            nk += (k_onehot & newv_chosen[None, :]).sum(dim=1)[:, None] * oh[None, :]
    return chosen_out, int(rr)
