"""The port's ``DeviceNodeCache`` (``ops/node_cache.py``) and the
tensorizer's node tokens: twins of the device-resident node-state tests of
``tests/test_pipeline.py``, each world built by each package from the same
spec.  The port's cache runs on ``device="cpu"`` here; the arrays it hands
out, its stats and the tokens' behaviour must equal the JAX package's.

Tolerance: exact equality."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from kubernetes_tpu.ops.batch_kernel import DeviceNodeCache as JCache
from kubernetes_tpu.ops.batch_kernel import to_device
from kubernetes_tpu_torch.models.carry import NODE_FIELDS, from_reference
from kubernetes_tpu_torch.ops.backend import BatchBackend
from kubernetes_tpu_torch.ops.node_cache import DeviceNodeCache
from tests import torch_port_cases as cases

JAX, PORT, ZONE = cases.JAX, cases.PORT, cases.ZONE
STAT_KEYS = ("reuses", "col_updates", "uploads", "dirty_cols", "cols_total")


def _world(pkg, n_nodes=24, cpus=("4", "8", "16"), pods_cap=30, zone=True):
    imp = importlib.import_module
    M = cases.mods(pkg)
    cs = imp(f"{pkg}.client").Clientset(imp(f"{pkg}.store").Store())
    for i in range(n_nodes):
        labels = {cases.HOST: f"node-{i:03d}"}
        if zone:
            labels[ZONE] = f"zone-{i % 3}"
        cs.nodes.create(M.tu.make_node(f"node-{i:03d}", cpu=cpus[i % len(cpus)],
                                       memory=["8Gi", "16Gi", "32Gi"][i % 3], pods=pods_cap,
                                       labels=labels))
    algo = M.gs.GenericScheduler()
    backend = (imp(f"{pkg}.ops").TPUBatchBackend(algorithm=algo) if pkg == JAX
               else BatchBackend(algorithm=algo, device="cpu"))
    sched = imp(f"{pkg}.scheduler").Scheduler(cs, algorithm=algo, backend=backend,
                                              emit_events=False)
    sched.start()
    return M, cs, sched


class Side:
    """One package's world, tensorizer and cache: ``arrays()`` tensorizes
    the current snapshot and hands its node-axis statics through the cache
    (host numpy, for comparing)."""

    def __init__(self, pkg, **world):
        self.pkg = pkg
        self.M, self.cs, self.sched = _world(pkg, **world)
        self.tz = self.sched.backend.tensorizer
        self.cache = JCache() if pkg == JAX else DeviceNodeCache("cpu")
        self.pods = [self.M.tu.make_pod(f"p{i}", cpu="100m", memory="128Mi") for i in range(4)]

    def update_node(self, name, fn):
        node = self.cs.nodes.get(name)
        fn(node)
        self.cs.nodes.update(node)
        self.sched.pump()

    def arrays(self):
        snap = self.sched.snapshot()
        static = self.tz.build_static(self.pods, snap, self.M.PriorityContext(snap))
        if self.pkg == JAX:
            d = to_device(static, node_cache=self.cache)
            got = {f: getattr(d, f) for f in NODE_FIELDS}
            # the JAX cache slices node_alloc by r_sel; the port keeps every resource
            if static.r_sel is not None:
                host_alloc = static.node_alloc[:, static.r_sel]
            else:
                host_alloc = static.node_alloc
        else:
            node_arrays = self.cache.node_arrays(static)
            s, _ = from_reference(vars(static), vars(self.tz.initial_state(
                static, snap, self.M.PriorityContext(snap), self.pods)), "cpu", node_arrays)
            got = {f: getattr(s, f) for f in NODE_FIELDS}
            assert all(getattr(s, f) is a for f, a in zip(NODE_FIELDS, node_arrays))
            host_alloc = static.node_alloc
        out = {f: np.asarray(v) for f, v in got.items()}
        np.testing.assert_array_equal(out["node_alloc"], host_alloc)
        for f in ("node_exists", "node_alloc_pods", "node_zone"):
            np.testing.assert_array_equal(out[f], getattr(static, f), err_msg=f)
        return static, got


def _both(**world):
    return Side(JAX, **world), Side(PORT, **world)


def _same_stats(j, p):
    assert {k: p.cache.stats[k] for k in STAT_KEYS} == {k: j.cache.stats[k] for k in STAT_KEYS}


def test_device_node_cache_reuses_and_updates_columns():
    j, p = _both(n_nodes=8)
    held = {}
    for side in (j, p):
        s1, d1 = side.arrays()
        assert side.cache.stats["uploads"] == 1
        _, d2 = side.arrays()
        assert side.cache.stats["reuses"] == 1
        assert d2["node_alloc"] is d1["node_alloc"]  # same device tensor, no upload

        def cpu2(node):
            node.status.allocatable["cpu"] = "2"
        side.update_node("node-002", cpu2)
        s2, d3 = side.arrays()
        assert s2.node_dirty == [2] and s2.node_token[0] == s1.node_token[0]
        assert s2.node_token[1:] == (s1.node_token[1], s1.node_token[2] + 1)
        assert side.cache.stats["col_updates"] == 1
        held[side.pkg] = (d1, d3)
    _same_stats(j, p)
    # the port's cached tensor is updated into a fresh tensor, as the JAX
    # package's functional update is: a holder of the earlier one keeps its
    # values
    d1, d3 = held[PORT]
    assert d3["node_alloc"] is not d1["node_alloc"]
    assert not np.array_equal(np.asarray(d1["node_alloc"]), np.asarray(d3["node_alloc"]))


def test_device_node_cache_zone_vocab_shift():
    """One node's zone relabel can renumber every column's zone id: the
    cache diffs the host arrays, not the dirty-node list."""
    j, p = _both(n_nodes=6)
    for side in (j, p):
        side.update_node("node-000", lambda n: n.meta.labels.__setitem__(ZONE, "zone-solo"))
        s1, _ = side.arrays()
        side.update_node("node-000", lambda n: n.meta.labels.__setitem__(ZONE, "zone-0"))
        s2, d2 = side.arrays()
        assert s2.node_dirty == [0]
        assert not np.array_equal(s1.node_zone, s2.node_zone)
        np.testing.assert_array_equal(np.asarray(d2["node_zone"]), s2.node_zone)
    _same_stats(j, p)


def test_device_node_cache_survives_tensorizer_swap():
    """A fresh tensorizer restarts its epoch and version; the instance
    nonce keeps its tokens from aliasing the cached tensors of another."""
    for pkg in (JAX, PORT):
        a = Side(pkg, n_nodes=4)
        s1, _ = a.arrays()
        b = Side(pkg, n_nodes=4, cpus=("2",), pods_cap=10, zone=False)
        b.cache = a.cache
        b.tz = type(a.tz)()
        s2, d2 = b.arrays()
        assert s1.node_token != s2.node_token and s1.node_token[1:] == s2.node_token[1:]
        assert a.cache.stats["uploads"] == 2


def test_many_dirty_columns_take_a_full_upload():
    j, p = _both(n_nodes=16)
    for side in (j, p):
        side.arrays()
        for k in range(4):  # a quarter of the fleet: past the n/8 scatter limit
            side.update_node(f"node-{k:03d}",
                             lambda n: n.status.allocatable.__setitem__("cpu", "3"))
        s, d = side.arrays()
        assert len(s.node_dirty) == 4
    _same_stats(j, p)


def test_compacted_view_bypasses_the_cache():
    """A prefiltered segment (``compact_segment``) carries no token: a full
    upload counted all-dirty, never a hit on the full-width entry."""
    for pkg in (JAX, PORT):
        side = Side(pkg, n_nodes=8)
        snap = side.sched.snapshot()
        pctx = side.M.PriorityContext(snap)
        static = side.tz.build_static(side.pods, snap, pctx)
        init = side.tz.initial_state(static, snap, pctx, side.pods)
        cstatic, _ = side.M.snapshot.compact_segment(static, init, np.arange(8), 8)
        assert cstatic.node_token is None
        if pkg == JAX:
            to_device(cstatic, node_cache=side.cache)
        else:
            side.cache.node_arrays(cstatic)
        assert side.cache.stats["uploads"] == 1 and side.cache.stats["dirty_cols"] == 8


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_waves_report_the_upload_fraction(pkg):
    """The scheduler reads the cache per wave: the first wave uploads the
    node axis, the next reuses it (fraction 0), in both packages."""
    M, cs, sched = _world(pkg, n_nodes=12)
    for w in range(3):
        cs.pods.create_many([M.tu.make_pod(f"w{w}-{i}", cpu="100m") for i in range(6)])
        sched.pump()
        assert sched.schedule_pending_batch() == (6, 0)
        assert sched.last_batch_phases["host_syncs"] >= 1
    stats = sched.backend.device_node_cache.stats
    assert stats["uploads"] == 1 and stats["cols_total"] == 3 * 128
    # placements do not move the node statics: every later wave reuses them
    assert stats["reuses"] + stats["col_updates"] == 2
