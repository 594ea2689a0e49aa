"""Twins of ``tests/test_host_state.py``: the port's cross-batch host state
(``models.snapshot.HostBatchState``) and the backend that keeps it across
``schedule_batch`` calls.

The JAX module imports ``kubernetes_tpu.ops`` and the JAX
``HostBatchState``, so these twins are written by hand.  Each package
builds its own copy of every world from one seed (the world builders of
``tests/test_torch_parity.py``) and drives its own state through the same
churn: the reconciled state must equal a fresh rebuild in the port, and
the port's views must equal the JAX package's.  The multi-batch referee
also holds the tensorizer's sticky resource-axis selection (``r_sel``)
and its ``bucket_scale`` coarsening equal to the JAX package's wave by
wave.

Tolerance: exact equality."""

from __future__ import annotations

import random

import pytest

from kubernetes_tpu.ops import TPUBatchBackend
from kubernetes_tpu_torch.ops.backend import BatchBackend
from tests import torch_port_cases as cases
from tests.test_torch_parity import build_cluster, make_batch

JAX, PORT = cases.JAX, cases.PORT


def _views(state) -> dict:
    """Every derived view of a host state, keyed by pod key and node name
    (engine ids differ between states; content must not)."""
    return {
        "nodes": list(state.node_names),
        "node_of": {k: state.node_names[state.pod_node_j[i]] for i, k in enumerate(state.pod_keys)},
        "content": {k: state.pod_content[i] for i, k in enumerate(state.pod_keys)},
        "disks": {key: {state.node_names[j]: tuple(rc) for j, rc in locs.items()}
                  for key, locs in state.disk_locations.items()},
        "nk": state.nk_counts.tolist(),
    }


def _assert_state_equiv(a, b) -> None:
    assert sorted(a.pod_keys) == sorted(b.pod_keys)
    assert _views(a) == _views(b)


def _mutate_cluster(M, rng, m):
    """Inter-batch churn on the NodeInfo map: delete a third of the placed
    pods, bind a few pods from outside, relabel one (remove + add, as the
    cache's update does)."""
    for info in m.values():
        for pod in list(info.pods):
            if pod.meta.name.startswith(("pend-", "w")) and rng.random() < 0.33:
                info.remove_pod(pod)
    names = list(m)
    for i in range(17):
        node = rng.choice(names)
        m[node].add_pod(M.tu.make_pod(f"ext-{i}", cpu="100m", memory="64Mi",
                                      labels={"app": rng.choice(["web", "db", "ext"])},
                                      node_name=node))
    for name, info in m.items():
        if info.pods:
            old = info.pods[0]
            new = M.tu.make_pod(old.meta.name.split("/")[-1], cpu="100m", memory="64Mi",
                                labels={"app": "relabeled"}, node_name=name)
            new.meta.namespace = old.meta.namespace
            info.remove_pod(old)
            info.add_pod(new)
            break


def _churned_states(pkg):
    M = cases.mods(pkg)
    rng = random.Random(7)
    m = build_cluster(M, rng, 40, existing_per_node=3)
    state = M.snapshot.HostBatchState(m)
    names = list(m)
    for i, pod in enumerate(make_batch(M, rng, 120)):
        node = names[i % len(names)]
        m[node].add_pod(pod)
        state.add_pod(pod, node)
    _mutate_cluster(M, rng, m)
    state.reconcile(m)
    return state, M.snapshot.HostBatchState(m)


def test_reconcile_equals_rebuild_under_churn():
    state, fresh = _churned_states(PORT)
    _assert_state_equiv(state, fresh)
    jstate, jfresh = _churned_states(JAX)
    assert _views(state) == _views(jstate)
    for s in (state, fresh, jstate, jfresh):
        s.close()


def test_reconcile_volume_refcounts():
    """Two pods sharing a disk on one node: deleting one keeps the mount,
    deleting both clears it (refcounted), in both packages alike."""
    trail = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        info = M.NodeInfo(M.tu.make_node("n1", cpu="8", memory="16Gi"))
        vols = [M.api.Volume(name="v", disk_kind="aws-ebs", disk_id="d1")]
        p1 = M.tu.make_pod("p1", cpu="100m", memory="64Mi", node_name="n1", volumes=vols)
        p2 = M.tu.make_pod("p2", cpu="100m", memory="64Mi", node_name="n1", volumes=vols)
        info.add_pod(p1)
        info.add_pod(p2)
        m = {"n1": info}
        state = M.snapshot.HostBatchState(m)
        key = ("aws-ebs", "d1")
        seen = [(state.disk_locations[key][0][0], int(state.nk_counts.sum()))]
        info.remove_pod(p2)
        state.reconcile(m)
        seen.append((state.disk_locations[key][0][0], int(state.nk_counts.sum())))
        info.remove_pod(p1)
        state.reconcile(m)
        seen.append((key in state.disk_locations, int(state.nk_counts.sum())))
        trail[pkg] = seen
        state.close()
    assert trail[PORT] == trail[JAX] == [(2, 1), (1, 1), (False, 0)]


def test_reconcile_node_set_change_rebuilds():
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m = build_cluster(M, random.Random(3), 10, existing_per_node=2)
        state = M.snapshot.HostBatchState(m)
        m["node-new"] = M.NodeInfo(M.tu.make_node("node-new", cpu="8", memory="16Gi"))
        state.reconcile(m)
        fresh = M.snapshot.HostBatchState(m)
        _assert_state_equiv(state, fresh)
        del m["node-0003"]
        state.reconcile(m)
        fresh2 = M.snapshot.HostBatchState(m)
        _assert_state_equiv(state, fresh2)
        assert "node-new" in state.node_names and "node-0003" not in state.node_names
        for s in (state, fresh, fresh2):
            s.close()


# wave -> (the tensorizer's bucket_scale, as overload rung 1 sets it; GPU pods?)
WAVES = ((1, False), (2, True), (1, False))


def _multi_batch(pkg):
    """Three batches through one backend, churn between them; the second
    runs with bucket_scale 2 and carries GPU pods.  Returns each wave's
    bindings, the oracle's, the counter and what the tensorizer built."""
    M = cases.mods(pkg)
    rng = random.Random(11)
    m = build_cluster(M, rng, 60, existing_per_node=2)
    for i, name in enumerate(sorted(m)):
        if i % 5 == 0:  # a few GPU nodes
            node = M.tu.make_node(name, cpu="16", memory="32Gi", pods=110, gpu=4,
                                  labels=dict(m[name].node.meta.labels))
            m[name].set_node(node)
    algo = M.gs.GenericScheduler()
    backend = (TPUBatchBackend(algorithm=algo, kernel_impl="xla") if pkg == JAX
               else BatchBackend(algorithm=algo, device="cpu"))
    tz = backend.tensorizer
    build, built = tz.build_static, []

    def recording(*a, **kw):
        static = build(*a, **kw)
        if static is not None:
            built.append((None if static.r_sel is None else [int(r) for r in static.r_sel],
                          static.static_ok.shape[0], static.term_matches_sig.shape[0],
                          static.g_ports.shape[1], static.v_state))
        return static

    tz.build_static = recording
    rr_oracle, waves = 0, []
    for wave, (scale, gpus) in enumerate(WAVES):
        tz.bucket_scale = scale
        pctx = M.PriorityContext(m, services=[], replicasets=[])
        batch = make_batch(M, rng, 150)
        if gpus:
            batch += [M.tu.make_pod(f"gpu-{i}", cpu="500m", memory="1Gi", gpu=1,
                                    labels={"app": "train"}) for i in range(12)]
        for p in batch:
            p.meta.name = f"w{wave}-{p.meta.name}"
        oracle = M.gs.GenericScheduler()
        oracle._round_robin = rr_oracle
        want = cases.oracle_batch(pkg, batch, m, pctx, oracle)
        built.clear()
        got = backend.schedule_batch(batch, m, pctx)
        rr_oracle = oracle._round_robin
        waves.append((got, want, algo._round_robin, rr_oracle, list(built)))
        for p, node in zip(batch, got):
            if node is not None:
                m[node].add_pod(p)
        _mutate_cluster(M, rng, m)
    return waves, backend


def test_multi_batch_parity_with_interleaved_churn():
    """The referee: three batches through one backend, with churn between
    them, bind exactly like the oracle run on each batch's state and like
    the JAX backend; the host state is built once and reconciled twice.
    The tensorizer's r_sel only grows (cpu and memory, then the GPU slot
    from the GPU wave on), and the rung-1 wave's coarser buckets stay."""
    waves, backend = _multi_batch(PORT)
    jwaves, jbackend = _multi_batch(JAX)
    for w, ((got, want, rr, rr_want, built), jw) in enumerate(zip(waves, jwaves)):
        mismatch = [(i, a, b) for i, (a, b) in enumerate(zip(want, got)) if a != b]
        assert not mismatch, f"wave {w}: {mismatch[:5]}"
        assert rr == rr_want
        assert (got, rr, built) == (jw[0], jw[2], jw[4]), f"wave {w}"
    assert backend.stats["host_state_rebuilds"] == jbackend.stats["host_state_rebuilds"] == 1
    assert backend.stats["host_state_reconciles"] == jbackend.stats["host_state_reconciles"] == 2
    assert backend.stats["kernel_pods"] > 0
    sels = [[b[0] for b in built] for *_, built in waves]
    assert {tuple(s) for s in sels[0]} == {(0, 1)}
    assert {tuple(s) for s in sels[1] + sels[2]} == {(0, 1, 3)}
    groups = [[b[1] for b in built] for *_, built in waves]
    assert min(groups[1]) >= 64 and min(groups[2]) >= max(groups[1])  # never shrinks


def test_engine_compaction_under_unique_label_churn():
    """Pods with per-wave-unique labels would grow the match corpus for
    ever; past the dead-content threshold the reconcile rebuilds the
    engine, the memo stays near the live set and the state stays right."""
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        info = M.NodeInfo(M.tu.make_node("n1", cpu="64", memory="256Gi", pods=10000))
        m = {"n1": info}
        state = M.snapshot.HostBatchState(m)
        state.MAX_DEAD_CONTENT = 50
        for wave in range(30):
            pods = [M.tu.make_pod(f"w{wave}-p{i}", cpu="1m", memory="1Mi",
                                  labels={"rollout": f"sha-{wave}-{i}"}, node_name="n1")
                    for i in range(5)]
            for p in pods:
                info.add_pod(p)
            state.reconcile(m)
            for p in pods:
                info.remove_pod(p)
            state.reconcile(m)
        assert len(state._lid_memo) <= state.MAX_DEAD_CONTENT + 10
        assert len(state.pod_keys) == 0
        fresh = M.snapshot.HostBatchState(m)
        _assert_state_equiv(state, fresh)
        fresh.close()
        state.close()


def test_batch_exception_drops_persistent_state():
    """A commit callback that raises mid-batch drops the cross-batch host
    state (the aborted batch's placements have no cache generation to
    reconcile them away); the next batch rebuilds it and binds as the
    oracle does, and the tensorizer keeps its sticky selection."""
    M = cases.mods(PORT)
    rng = random.Random(5)
    m = build_cluster(M, rng, 20, existing_per_node=1)
    algo = M.gs.GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    pctx = M.PriorityContext(m, services=[], replicasets=[])
    batch = make_batch(M, rng, 40)

    class Boom(Exception):
        pass

    def exploding(entries):
        raise Boom()

    with pytest.raises(Boom):
        backend.schedule_batch(batch, m, pctx, on_segment=exploding)
    assert backend._host_state is None
    sticky = set(backend.tensorizer._r_sticky)
    oracle = M.gs.GenericScheduler()
    oracle._round_robin = algo._round_robin
    want = cases.oracle_batch(PORT, batch, m, pctx, oracle)
    got = backend.schedule_batch(batch, m, pctx)
    assert got == want and algo._round_robin == oracle._round_robin
    assert backend.stats["host_state_rebuilds"] == 2
    assert backend.tensorizer._r_sticky == sticky == {0, 1}
    assert None not in got
