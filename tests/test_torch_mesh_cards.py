"""The node-axis mesh over several cards, on the CPU: how ``parallel/mesh.py``
groups shards into launches, how ``ops/mesh_scan.py`` plans, gates and
checks a mesh in several launches, the node cache's per-card uploads and
the backend's placement.  Nothing here touches a card: the
``torch.device("cuda", i)`` objects are built and never used, and
``torch.cuda.device_count`` (with ``is_available`` where the backend asks
it) is monkeypatched where the code reads it.  The kernel's runs in several
launches are ``tests/test_torch_mesh_kernel.py``'s, on the card.

Tolerance: exact equality everywhere (groupings, plans, counters)."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import mesh_scan
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.ops.node_cache import DeviceNodeCache
from kubernetes_tpu_torch.parallel import mesh as pmesh

CUDA = [torch.device("cuda", i) for i in range(4)]


@pytest.fixture
def cards(monkeypatch):
    """Patch the visible card count (and that a card is there)."""
    def set_cards(n: int) -> None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    return set_cards


@pytest.mark.parametrize("n_cards, devices, groups", [
    (1, [0, 0, 0, 0], ((0, 1, 2, 3),)),
    (2, [0, 0, 1, 1], ((0, 1), (2, 3))),
    (4, [0, 1, 2, 3], ((0,), (1,), (2,), (3,))),
    (3, [0, 0, 1, 2], ((0, 1), (2,), (3,))),
])
def test_make_mesh_spreads_shards_over_the_cards(cards, n_cards, devices, groups):
    """``make_mesh(4)`` with no devices: shard k on card k * C // 4, a
    launch a card, its shards contiguous."""
    cards(n_cards)
    mesh = pmesh.make_mesh(4)
    assert [d.index for d in mesh.devices] == devices
    assert mesh.groups == groups
    assert pmesh.make_mesh().size == n_cards  # a shard a card by default


def test_explicit_grouping_on_one_card_and_the_mesh_key():
    one = pmesh.make_mesh(4, devices=["cuda"] * 4)
    two = pmesh.make_mesh(4, devices=["cuda"] * 4, launches=2)
    four = pmesh.make_mesh(4, devices=["cuda"] * 4, launches=4)
    assert one.groups == ((0, 1, 2, 3),)
    assert two.groups == ((0, 1), (2, 3))
    assert four.groups == ((0,), (1,), (2,), (3,))
    # the grouping joins the key: a grouped mesh never aliases the single launch
    assert len({one.key, two.key, four.key}) == 3
    assert one.key == pmesh.make_mesh(4, devices=["cuda"] * 4).key
    with pytest.raises(ValueError, match="equal launches"):
        pmesh.make_mesh(4, devices=["cuda"] * 4, launches=3)
    with pytest.raises(ValueError, match="one device"):  # a launch never spans two cards
        pmesh.make_mesh(4, devices=[CUDA[0]] * 2 + [CUDA[1]] * 2, launches=1)
    with pytest.raises(ValueError, match="contiguous"):
        pmesh.Mesh(tuple(CUDA[:2] * 2))
    with pytest.raises(ValueError, match="in order"):
        pmesh.Mesh(tuple([CUDA[0]] * 4), ((0, 2), (1, 3)))


def test_node_cache_token_carries_the_grouping():
    cache = DeviceNodeCache("cpu")
    static = types.SimpleNamespace(node_token=(1, 0, 0), r_sel=None)
    tokens = []
    for launches in (None, 2):
        cache.set_mesh(pmesh.make_mesh(4, devices=["cpu"] * 4, launches=launches))
        tokens.append(cache._token_for(static))
    assert tokens[0] != tokens[1]


def test_node_cache_attribution_is_the_same_in_every_grouping():
    """The per-shard dirty and total columns do not depend on how the
    shards are launched; a card's shards land in one tensor."""
    rng = np.random.default_rng(0)
    host = rng.integers(0, 9, size=(16, 2)).astype(np.int32)
    stats = []
    for launches in (None, 2, 4):
        cache = DeviceNodeCache("cpu")
        cache.set_mesh(pmesh.make_mesh(4, devices=["cpu"] * 4, launches=launches))
        put = cache._shard_put(host)
        assert isinstance(put, torch.Tensor)
        np.testing.assert_array_equal(put.numpy(), host)
        cache._note_shard_total(16)
        cache._note_shard_dirty(np.array([1, 5, 13, 14]), 16)
        stats.append((cache.stats["shard_dirty_cols"], cache.stats["shard_cols_total"]))
    assert stats[0] == stats[1] == stats[2] == ([1, 1, 0, 2], [4, 4, 4, 4])


def test_node_cache_runs_of_shards_by_card_and_column_writes_per_card():
    """With shards on two cards a field is one tensor a card (the cards'
    runs from the mesh), and a diff writes each changed column into its
    card's tensor, in fresh tensors."""
    assert pmesh.runs_by_device((CUDA[0], CUDA[0], CUDA[1], CUDA[1])) == ((0, 1), (2, 3))
    # two devices the CPU has (meta stands in for a second card): a tensor each
    cache = DeviceNodeCache("cpu")
    meta, cpu = torch.device("meta"), torch.device("cpu")
    cache.set_mesh(pmesh.Mesh((meta, meta, cpu, cpu)))
    host = np.arange(32, dtype=np.int32).reshape(16, 2)
    parts = cache._shard_put(host)
    assert isinstance(parts, tuple) and [p.device for p in parts] == [meta, cpu]
    assert parts[0].shape == (8, 2)
    np.testing.assert_array_equal(parts[1].numpy(), host[8:])
    old = (torch.arange(8, dtype=torch.int32), torch.arange(8, 16, dtype=torch.int32))
    new_h = np.arange(16, dtype=np.int32) + 100
    got = DeviceNodeCache._put_cols(old, np.array([3, 12]), new_h)
    assert isinstance(got, tuple) and got[0] is not old[0] and got[1] is not old[1]
    want = np.arange(16)
    want[[3, 12]] += 100
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    np.testing.assert_array_equal(torch.cat(old).numpy(), np.arange(16))  # untouched
    one = DeviceNodeCache._put_cols(old[0], np.array([2]), new_h)
    assert one[2] == 102 and isinstance(one, torch.Tensor)


def test_from_reference_joins_per_card_node_arrays():
    """A node field given as one tensor a card is joined in shard order on
    the segment's device."""
    from kubernetes_tpu_torch.models.carry import NODE_FIELDS, from_reference
    from tests import torch_port_cases as cases

    static, init = cases.tensorize(cases.PORT, "mixed")
    whole = from_reference(vars(static), vars(init), "cpu")[0]
    arrays = [getattr(whole, f) for f in NODE_FIELDS]
    halves = tuple((a[: len(a) // 2], a[len(a) // 2:]) for a in arrays)
    joined = from_reference(vars(static), vars(init), "cpu", node_arrays=halves)[0]
    for f in NODE_FIELDS:
        assert torch.equal(getattr(joined, f), getattr(whole, f)), f


def _plan(shards, clusters, resident=None, launches=1, n_local=1280, zones=3):
    return mesh_scan.plan_for(n_local, shards, r=4, g=32, t=4, pv=8, v=6, w=2, k=2, zones=zones,
                              use_terms=True, use_vols=True, use_ports=True, clusters=clusters,
                              resident=resident, launches=launches)


def _card_fits(cs, threads, cpt, smem):
    """A card that holds 2 clusters of 16 blocks, 4 of 8, 8 of 4."""
    return {16: 2, 8: 4, 4: 8, 2: 16, 1: 32}[cs]


def _statics(shards: int):
    from tests import torch_port_cases as cases
    from kubernetes_tpu_torch.models.carry import from_reference

    static, init = cases.tensorize(cases.PORT, "mixed", n_nodes=shards * 1280 - 7, n_pods=8)
    ps, pi = cases.mods(cases.PORT).snapshot.pad_segment_to_multiple(static, init, shards)
    s, _ = from_reference(vars(ps), vars(pi), "cpu")
    return pmesh.place_static(s, pmesh.make_mesh(shards, devices=["cpu"] * shards))


def test_plan_holds_each_card_to_its_own_clusters():
    """Two launches on one card need room for all S clusters at once; on
    two cards each card holds its S / 2."""
    statics = _statics(4)
    one_card = mesh_scan.plan(statics, ((0, 1), (2, 3)), devices=[CUDA[0]] * 4,
                              clusters=_card_fits)
    two_cards = mesh_scan.plan(statics, ((0, 1), (2, 3)),
                               devices=[CUDA[0], CUDA[0], CUDA[1], CUDA[1]], clusters=_card_fits)
    single = mesh_scan.plan(statics, devices=[CUDA[0]] * 4, clusters=_card_fits)
    assert one_card.cs == single.cs == 8 and two_cards.cs == 16
    assert (one_card.launches, two_cards.launches, single.launches) == (2, 2, 1)
    assert _plan(4, _card_fits, resident=2).cs == 16 and _plan(4, _card_fits).cs == 8
    with pytest.raises(ValueError, match="cannot be 5 launches"):
        _plan(4, _card_fits, launches=5)


@pytest.mark.parametrize("zones", [3, 5000])
def test_grouped_exchanges_pass_the_collective_gate(zones):
    """A grouped plan's exchanges carry the ``launches`` scope (each
    shard's two messages pushed to the other launches, past the register
    zones with its zone row) and, at the main segment's few zones, pass
    ``assert_collective_structure``; the gate still rejects a plane-sized
    exchange beside them."""
    statics = _statics(4)
    wide = dataclasses.replace(statics[0], n_pad=4 * statics[0].n_pad)
    for launches in (2, 4):
        pl = _plan(4, mesh_scan.h100_clusters, launches=launches, zones=zones,
                   n_local=statics[0].n_pad)
        ex = mesh_scan.exchanges(pl)
        far = [e for e in ex if e["scope"] == "launches"]
        assert [e["name"] for e in far] == ["launch_statistics", "launch_best_and_ties"]
        zone_words = 0 if pl.zones_at == "registers" else 2 * zones
        assert far[0]["words"] == 4 * (launches - 1) * (pl.box_a + zone_words)
        assert far[1]["words"] == 4 * (launches - 1) * pl.box_b
        if zones > 8:
            continue  # a zone row per shard: the gate's limit is set for a node plane
        counts = pmesh.assert_collective_structure(ex, wide)
        assert counts["all-reduce"] == 3 and counts["all-gather"] == 3
        g, t = wide.static_ok.shape[0], wide.term_matches_sig.shape[0]
        bad = ex + [{"name": "plane", "collective": "all-gather", "scope": "launches",
                     "words": max(g, t, 2) * wide.n_pad}]
        with pytest.raises(AssertionError, match="all-gathers node-axis state"):
            pmesh.assert_collective_structure(bad, wide)
    assert all(e["scope"] != "launches" for e in mesh_scan.exchanges(_plan(4, mesh_scan.h100_clusters)))


def test_sharded_hlo_plans_the_mesh_grouping():
    from tests import torch_port_cases as cases
    from kubernetes_tpu_torch.models.carry import from_reference

    static, init = cases.tensorize(cases.PORT, "mixed")
    s, _ = from_reference(vars(static), vars(init), "cpu")
    scopes = {k: {e["scope"] for e in pmesh.sharded_hlo(s, pmesh.make_mesh(
        4, devices=["cpu"] * 4, launches=k))} for k in (1, 2)}
    assert "launches" not in scopes[1] and "launches" in scopes[2]


def test_backend_spreads_the_mesh_over_the_cards(cards):
    """``frontier_mesh=True, mesh_devices=4``: 4 shards over 2 cards in 2
    launches; 1 card keeps them on the backend's device in one launch;
    "auto" stays off even with 4 cards (divergence ak)."""
    cards(2)
    b = BatchBackend(device="cuda", frontier_mesh=True, mesh_devices=4)
    assert [d.index for d in b._mesh.devices] == [0, 0, 1, 1]
    assert b._mesh.groups == ((0, 1), (2, 3))
    assert b.device_node_cache._mesh_key == b._mesh.key
    b = BatchBackend(device="cuda", frontier_mesh=True, mesh_devices=6)  # 4 shards
    assert b._mesh.size == 4 and len(b._mesh.groups) == 2
    cards(1)
    b = BatchBackend(device="cuda", frontier_mesh=True, mesh_devices=4)
    assert b._mesh.devices == (torch.device("cuda"),) * 4 and len(b._mesh.groups) == 1
    cards(4)
    b = BatchBackend(device="cuda", frontier_mesh=True, mesh_devices=2)
    assert [d.index for d in b._mesh.devices] == [0, 1]
    assert BatchBackend(device="cuda", frontier_mesh="auto")._mesh is None
    assert BatchBackend(device="cuda", frontier_mesh=True)._mesh.size == 4


def test_mesh_kernel_checks_each_shards_device():
    """Shards on several cards pass the device check; a shard on the CPU,
    a mixed CPU/CUDA mesh, or a shard whose state is on another device
    than its statics, raises and names the plain version."""
    def shard(dev):
        return (types.SimpleNamespace(device=dev),
                types.SimpleNamespace(pod_count=types.SimpleNamespace(device=dev)))

    ok = [shard(d) for d in (CUDA[0], CUDA[0], CUDA[1], CUDA[1])]
    assert mesh_scan._device([a for a, _ in ok], [b for _, b in ok]) == [
        CUDA[0], CUDA[0], CUDA[1], CUDA[1]]
    mixed = [shard(torch.device("cpu")), shard(CUDA[0])]
    with pytest.raises(RuntimeError, match="scan_shards"):
        mesh_scan._device([a for a, _ in mixed], [b for _, b in mixed])
    split = [shard(CUDA[0])]
    with pytest.raises(RuntimeError, match="its card"):
        mesh_scan._device([split[0][0]], [shard(CUDA[1])[1]])


def test_grouped_pack_needs_its_control_words():
    """A grouped mesh is packed with launch 0's control words; the plan's
    launch count must be the grouping's."""
    statics = _statics(4)
    pl = _plan(4, mesh_scan.h100_clusters, launches=2, n_local=statics[0].n_pad)
    fake = [types.SimpleNamespace(device=CUDA[0], pod_count=types.SimpleNamespace(device=CUDA[0]))
            for _ in range(4)]
    with pytest.raises(ValueError, match="for 2 launches, not 1"):
        mesh_scan.pack(fake, fake, pl)
    with pytest.raises(ValueError, match="control words"):
        mesh_scan.pack(fake, fake, pl, ((0, 1), (2, 3)))
    with pytest.raises(ValueError, match="in order"):
        mesh_scan.pack(fake, fake, pl, ((0, 2), (1, 3)))
