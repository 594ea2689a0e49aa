"""The fused scan's host-side plan, its ctypes mirror and its build key.

``fused_scan.plan`` decides the cluster size, the block size and which
state planes live in each block's shared memory; the kernel reads the rest
from global memory through the same code.  These checks are plain Python
and run on the CPU; the kernel itself is held against ``scan_ref`` by the
``cuda``-marked tests in ``test_torch_kernel.py`` and by ``chip_smoke.py``.
"""

import ctypes
import os
import re
import shutil

import numpy as np
import pytest

from kubernetes_tpu_torch.models.carry import from_reference
from kubernetes_tpu_torch.ops import _build, fused_scan
from tests import torch_port_cases as cases

# the main segment of chip_smoke phase 4 (5000 nodes x 20 000 mixed pods)
MAIN = dict(n=5120, r=4, g=32, t=4, pv=8, v=32, w=1, k=3, zones=3,
            use_terms=True, use_vols=True, use_ports=False)
HOT = ("req", "nz", "cnt", "ports", "dm", "downer", "volf", "nk")
NODE_CONST = ("alloc", "alloc_pods", "exists", "zone", "node_domain", "dom_valid")


def _block_bytes(pl):
    return pl.smem_bytes + fused_scan.STATIC_RESERVE


def test_stated_order():
    assert fused_scan.PLANES == ("pod_rows", "spread_inc") + HOT + ("spread", "res") + NODE_CONST


def test_main_segment_is_all_in_shared_memory_on_16_blocks():
    pl = fused_scan.plan_for(**MAIN)
    assert (pl.cs, pl.cols, pl.ns) == (16, 320, 5120)
    assert pl.global_ == ()
    assert set(pl.shared) == set(fused_scan.PLANES)
    assert pl.threads * pl.cpt >= pl.cols and pl.threads % 32 == 0
    assert _block_bytes(pl) <= fused_scan.SMEM_LIMIT
    # the planned budget: 232 B a column of mutable state, 60 B of node rows
    mutable = sum(pl.plane_bytes[p] for p in HOT + ("spread",)) / pl.cols
    const = sum(pl.plane_bytes[p] for p in NODE_CONST) / pl.cols
    assert (mutable, const) == (232, 60)


def test_twenty_thousand_nodes_spill_in_the_stated_order():
    pl = fused_scan.plan_for(**{**MAIN, "n": 20096})
    assert pl.cs == 16 and pl.cols % 16 == 0 and pl.ns >= 20096
    assert pl.global_, "20 000 nodes do not fit in 16 blocks' shared memory"
    # the planes in global memory are a suffix of the stated order
    k = len(pl.shared)
    assert pl.shared == fused_scan.PLANES[:k] and pl.global_ == fused_scan.PLANES[k:]
    assert "spread" in pl.global_ and "pod_rows" in pl.shared and "req" in pl.shared
    assert _block_bytes(pl) <= fused_scan.SMEM_LIMIT


def _every_plane_once(pl):
    assert set(pl.shared) | set(pl.global_) == set(fused_scan.PLANES)
    assert not set(pl.shared) & set(pl.global_)
    spans = sorted((pl.offsets[p], pl.offsets[p] + pl.plane_bytes[p]) for p in pl.shared)
    fixed = pl.fixed_bytes
    # the kernel's fixed layout: pod buffers, nonzero requests, two inboxes
    assert pl.gnz_off == fused_scan.NBUF * (pl.sws + pl.w4) * 4
    assert pl.sws <= pl.sw and pl.sws % 4 == 0
    assert pl.gnz_off < pl.inbox_a_off < pl.inbox_b_off < fixed
    assert all(x % 16 == 0 for x in (pl.gnz_off, pl.inbox_a_off, pl.inbox_b_off, fixed))
    assert pl.msg_a % 4 == 0 and pl.msg_b % 4 == 0 and pl.msg_b >= 3 + pl.cpt * pl.threads // 32
    assert all(a >= fixed for a, _ in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:])), "overlap"
    assert all(o % 16 == 0 for o, _ in spans), "bulk copies need 16-byte alignment"
    assert max([b for _, b in spans] + [fixed]) == pl.smem_bytes


@pytest.mark.parametrize("n", [1, 64, 128, 1024, 5120, 10112, 20096, 65536, 131072])
def test_every_plane_placed_once_within_budget(n):
    for ports in (False, True):
        pl = fused_scan.plan_for(**{**MAIN, "n": n, "use_ports": ports})
        _every_plane_once(pl)
        assert _block_bytes(pl) <= fused_scan.SMEM_LIMIT
        assert pl.ns == pl.cs * pl.cols >= n and pl.cols % 16 == 0
        assert 1 <= pl.cs <= fused_scan.MAX_CLUSTER
        assert 32 <= pl.threads <= fused_scan.MAX_THREADS and pl.threads % 32 == 0
        assert pl.cpt in (1, 2, 4, 8, 16) and pl.threads * pl.cpt >= pl.cols


def test_no_segment_check_shape_accepts_is_refused():
    """Seeded sweep up to every limit of ``check_shape``: the planner
    always finds a plan whose fixed buffers fit."""
    rng = np.random.default_rng(7)
    # zones and host ports have no cap: the sweep goes well past the
    # shared-memory zone budget and the signature row's port slot
    edges = [dict(n=fused_scan.MAX_NODES, r=fused_scan.MAX_R, g=512, t=fused_scan.MAX_TERMS,
                  pv=4096, v=2048, w=fused_scan.MAX_SLOTS,
                  k=fused_scan.MAX_KINDS, zones=8192)]
    for _ in range(200):
        edges.append(dict(n=int(rng.integers(1, fused_scan.MAX_NODES + 1)),
                          r=int(rng.integers(1, fused_scan.MAX_R + 1)),
                          g=int(rng.integers(1, 1025)), t=int(rng.integers(0, fused_scan.MAX_TERMS + 1)),
                          pv=int(rng.integers(0, 4 * fused_scan.MAX_PORTS + 1)),
                          v=int(rng.integers(1, 2049)), w=int(rng.integers(0, fused_scan.MAX_SLOTS + 1)),
                          k=int(rng.integers(0, fused_scan.MAX_KINDS + 1)),
                          zones=int(rng.integers(0, 4097))))
    for dims in edges:
        for flags in ((True, True, True), (False, False, False)):
            pl = fused_scan.plan_for(**dims, use_terms=flags[0], use_vols=flags[1],
                                     use_ports=flags[2])
            _every_plane_once(pl)
            assert _block_bytes(pl) <= fused_scan.SMEM_LIMIT
            assert pl.threads <= fused_scan.MAX_THREADS and pl.threads * pl.cpt >= pl.cols


@pytest.mark.parametrize("zones,n,where,cs", [
    (3, 5120, "registers", 16),
    (235, 5120, "shared", 16),   # the most that fit at 16 blocks
    (236, 5120, "global", 16),
    (236, 1000, "shared", 4),
    (300, 1000, "shared", 4),
    (300, 5120, "global", 16),
    (1000, 1000, "global", 4),
])
def test_zone_statistics_are_placed_where_they_fit(zones, n, where, cs):
    """Registers up to REG_ZONES; shared memory while both inboxes and the
    zone arrays fit ZONE_SMEM at the plan's cluster; else a global scratch,
    and exchange (a) carries only the statistics' 10 words."""
    pl = fused_scan.plan_for(**{**MAIN, "n": n, "zones": zones})
    assert (pl.zones_at, pl.cs) == (where, cs)
    _every_plane_once(pl)
    assert _block_bytes(pl) <= fused_scan.SMEM_LIMIT
    if where == "shared":
        assert pl.msg_a >= 10 + 2 * zones and pl.zone_off >= pl.inbox_b_off
        assert fused_scan.zone_bytes(zones, cs) <= fused_scan.ZONE_SMEM
    elif where == "global":
        assert pl.msg_a == 12 and pl.zone_off == 0
        assert fused_scan.zone_bytes(zones, cs) > fused_scan.ZONE_SMEM
        assert fused_scan.zbuf_words(zones, cs) == 3 * cs * zones
    else:
        assert pl.zone_off == 0


def test_a_wide_signature_row_keeps_its_port_slot_in_shared_memory():
    """A row with more port flags than MAX_PORTS keeps the first MAX_PORTS
    (and the terms before them) in the pod buffers; the rest are read from
    global memory.  A narrow row is copied whole."""
    narrow = fused_scan.plan_for(**{**MAIN, "pv": 64})
    assert narrow.sws == narrow.sw
    wide = fused_scan.plan_for(**{**MAIN, "pv": 1000})
    head = MAIN["r"] + 4 + fused_scan.TERM_FIELDS * MAIN["t"]
    assert wide.sw == -(-(head + 1000) // 4) * 4
    assert wide.sws == -(-(head + fused_scan.MAX_PORTS) // 4) * 4 < wide.sw
    assert wide.gnz_off == narrow.gnz_off + fused_scan.NBUF * (wide.sws - narrow.sws) * 4


def test_plan_of_a_real_segment_matches_its_packing():
    static, init = cases.tensorize(cases.PORT, "mixed")
    s, st = from_reference(vars(static), vars(init), "cpu")
    pl = fused_scan.plan(s, cpt=2)
    assert pl.cpt == 2
    b = fused_scan.pack(s, st, pl)
    for name in ("alloc", "req", "spread", "volf", "dm", "static_ok"):
        assert b[name].shape[-1] == pl.ns
    assert b["sig"].shape[1] == pl.sw and b["pod_vol"].shape[1] == pl.w4
    assert b["spread_inc_t"].shape[1] == pl.g4
    p = fused_scan.params(s, st, b, pl)
    assert list(p.off) == [-1 if pl.offsets[k] is None else pl.offsets[k]
                           for k in fused_scan.PLANES]
    assert (p.cs, p.cols, p.threads, p.cpt, p.smem_bytes) == (
        pl.cs, pl.cols, pl.threads, pl.cpt, pl.smem_bytes)


# ---- the ctypes mirror of struct ScanParams ----------------------------------

def _parse_struct(text: str, name: str) -> list[tuple[str, str, int]]:
    """(field, "ptr" or "i32", count) per field of ``struct name`` in C
    source ``text``, in declaration order."""
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(?:const\s+)?(u?int\d+_t)\s*(\*?)\s*(.*)$", decl, re.S)
        assert m, decl
        kind = "ptr" if m.group(2) else {"int32_t": "i32"}[m.group(1)]
        for part in m.group(3).split(","):
            part = part.strip()
            kind_i = "ptr" if part.startswith("*") else kind
            arr = re.match(r"\*?\s*(\w+)\s*(?:\[(\d+)\])?$", part)
            out.append((arr.group(1), kind_i, int(arr.group(2) or 1)))
    return out


def _ctypes_fields(cls) -> list[tuple[str, str, int]]:
    out = []
    for fname, ctype in cls._fields_:
        if issubclass(ctype, ctypes.Array):
            assert ctype._type_ is ctypes.c_int32
            out.append((fname, "i32", ctype._length_))
        else:
            out.append((fname, "ptr" if ctype is ctypes.c_void_p else "i32", 1))
            assert ctype in (ctypes.c_void_p, ctypes.c_int32)
    return out


def test_scan_params_mirror_matches_the_cuda_struct():
    with open(os.path.join(_build.CSRC, "fused_scan.cu")) as f:
        text = f.read()
    assert _ctypes_fields(fused_scan.ScanParams) == _parse_struct(text, "ScanParams")
    # the placement slots follow the kernel's enum
    enum = re.search(r"enum\s+Plane\s*\{(.*?)\}", text, re.S).group(1)
    names = [x.strip() for x in enum.replace("\n", " ").split(",") if x.strip()]
    names = [x.split("=")[0].strip() for x in names if x.strip() != "NPLANES"]
    assert [x[2:].lower() for x in names] == [
        {"pod_rows": "pod", "spread_inc": "inc"}.get(p, p) for p in fused_scan.PLANES]


def test_refresh_params_mirror_matches_the_cuda_struct():
    from kubernetes_tpu_torch.ops import frontier_refresh

    with open(os.path.join(_build.CSRC, "frontier_refresh.cu")) as f:
        text = f.read()
    assert _ctypes_fields(frontier_refresh.RefreshParams) == _parse_struct(text, "RefreshParams")
    # the control words' slots the kernel names, as the host numbers them
    for name in ("STOP", "ALIVE", "ACC", "DONE"):
        slot = re.search(r"CTL_%s = (\d+)" % name, text).group(1)
        assert int(slot) == getattr(fused_scan, f"CTL_{name}")


def test_struct_parser_sees_a_drifted_field():
    text = "struct ScanParams {\n const int32_t* a; // x\n int32_t n, m;\n int32_t wt[7];\n};"
    assert _parse_struct(text, "ScanParams") == [("a", "ptr", 1), ("n", "i32", 1),
                                                 ("m", "i32", 1), ("wt", "i32", 7)]


# ---- the build key covers the headers a source includes ----------------------

def test_library_path_changes_with_an_included_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int f() { return g(); }\n')
    (csrc / "k.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("static int g() { return 1; }\n")
    (csrc / "other.cuh").write_text("// not included\n")
    first = _build.library_path("k", str(csrc))
    assert [os.path.basename(p) for p in _build.sources("k", str(csrc))] == [
        "k.cu", "k.cuh", "inner.cuh"]
    (csrc / "other.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("k", str(csrc)) == first
    (csrc / "inner.cuh").write_text("static int g() { return 2; }\n")
    second = _build.library_path("k", str(csrc))
    assert second != first
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int f() { return -g(); }\n')
    assert _build.library_path("k", str(csrc)) not in (first, second)
    # the real kernel's key is a pure function of its sources
    assert _build.library_path("fused_scan") == _build.library_path("fused_scan")
