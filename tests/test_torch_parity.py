"""Twins of ``tests/test_parity.py``: the port's batch path against the JAX
package's and the sequential oracle on its scenarios.

The JAX module drives ``kubernetes_tpu.ops.TPUBatchBackend`` directly, so
these twins are written by hand: every scenario is a builder that makes
the same seeded cluster and batch with either package's own API kinds
(``build(pkg)``), and ``assert_parity`` runs the JAX backend
(``kernel_impl="xla"``), ``BatchBackend(device="cpu")`` and each package's
oracle over it.  It also holds the tensorizer's resource-axis selection
(``r_sel``) equal in both packages and checks that every segment the port
carries to the device has a resource axis ``len(r_sel)`` wide.  Its twin of
``test_backend_in_scheduler_end_to_end`` is in ``tests/test_torch_scheduler
.py``.

Tolerance: exact equality of every binding and of the round-robin
counter."""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

from kubernetes_tpu.ops.backend import TPUBatchBackend
from kubernetes_tpu_torch.ops.backend import BatchBackend
from tests import torch_port_cases as cases

JAX, PORT, HOST, ZONE = cases.JAX, cases.PORT, cases.HOST, cases.ZONE


# -- the worlds of test_parity.py, in either package --------------------------------

def build_cluster(M, rng, n_nodes, zones=3, tainted_frac=0.1, existing_per_node=2):
    m = {}
    for i in range(n_nodes):
        labels = {HOST: f"node-{i:04d}"}
        if zones:
            labels[ZONE] = f"zone-{i % zones}"
        if rng.random() < 0.3:
            labels["disk"] = rng.choice(["ssd", "hdd"])
        taints = []
        if rng.random() < tainted_frac:
            taints.append(M.api.Taint(key="dedicated", value="special", effect="NoSchedule"))
        node = M.tu.make_node(f"node-{i:04d}", cpu=rng.choice(["4", "8", "16"]),
                              memory=rng.choice(["8Gi", "16Gi", "32Gi"]),
                              pods=rng.choice([50, 110]), labels=labels, taints=taints)
        info = M.NodeInfo(node)
        for j in range(rng.randrange(existing_per_node + 1)):
            info.add_pod(M.tu.make_pod(
                f"existing-{i}-{j}", cpu=rng.choice(["100m", "500m", "1"]),
                memory=rng.choice(["128Mi", "512Mi", "1Gi"]),
                labels={"app": rng.choice(["web", "db", "cache"])}, node_name=node.meta.name))
        m[node.meta.name] = info
    return m


def make_batch(M, rng, n_pods, templates=None):
    templates = templates or [
        dict(cpu="100m", memory="128Mi", labels={"app": "web"}),
        dict(cpu="500m", memory="512Mi", labels={"app": "db"}),
        dict(cpu="1", memory="1Gi", labels={"app": "cache"}),
        dict(cpu="250m", memory="256Mi", labels={"app": "web"}, node_selector={"disk": "ssd"}),
        dict(cpu="200m", memory="128Mi", labels={"app": "batch"},
             tolerations=[M.api.Toleration(key="dedicated", operator="Exists")]),
    ]
    return [M.tu.make_pod(f"pend-{i:05d}", **dict(rng.choice(templates))) for i in range(n_pods)]


def _sel(M, labels):
    return M.api.LabelSelector.from_match_labels(labels)


def _term(M, labels, key):
    return M.api.PodAffinityTerm(selector=_sel(M, labels), topology_key=key)


def _weighted(M, weight, labels, key):
    return M.api.WeightedPodAffinityTerm(weight=weight, term=_term(M, labels, key))


def basic_resources(M):
    rng = random.Random(1)
    m = build_cluster(M, rng, 24, zones=0, tainted_frac=0, existing_per_node=2)
    pods = make_batch(M, rng, 120, templates=[dict(cpu="100m", memory="128Mi"),
                                              dict(cpu="2", memory="4Gi"),
                                              dict(cpu="500m", memory="1Gi")])
    return m, pods, M.PriorityContext(m)


def zones_spread_services(M):
    rng = random.Random(2)
    m = build_cluster(M, rng, 30, zones=3)
    svcs = [M.api.Service(meta=M.api.ObjectMeta(name=a), selector={"app": a})
            for a in ("web", "db", "cache")]
    return m, make_batch(M, rng, 150), M.PriorityContext(m, services=svcs)


def replicaset_owners_and_spread(M):
    rng = random.Random(3)
    m = build_cluster(M, rng, 20, zones=2)
    rs = M.api.ReplicaSet(meta=M.api.ObjectMeta(name="rs-web"), selector=_sel(M, {"app": "web"}))
    ref = M.api.OwnerReference(kind="ReplicaSet", name="rs-web", uid="uid-rs-web",
                               controller=True)
    pods = [M.tu.make_pod(f"w-{i}", cpu="200m", memory="256Mi", labels={"app": "web"},
                          owner_refs=[ref]) for i in range(80)]
    return m, pods, M.PriorityContext(m, replicasets=[rs])


def most_requested_binpack(M):
    rng = random.Random(4)
    m = build_cluster(M, rng, 16, zones=0)
    return m, make_batch(M, rng, 100), M.PriorityContext(m)


def taints_and_node_affinity(M):
    rng = random.Random(5)
    m = build_cluster(M, rng, 25, zones=3, tainted_frac=0.3)
    for i, (name, info) in enumerate(sorted(m.items())):
        if i % 4 == 0:
            info.node.spec.taints.append(M.api.Taint(key="soft", value="x",
                                                     effect="PreferNoSchedule"))
            info.set_node(info.node)
    return m, make_batch(M, rng, 120), M.PriorityContext(m)


def host_ports(M):
    rng = random.Random(6)
    m = build_cluster(M, rng, 10, zones=0, existing_per_node=0)
    pods = [M.tu.make_pod(f"p-{i}", cpu="100m", host_ports=[8080]) for i in range(15)]
    return m, pods, M.PriorityContext(m)


def unschedulable_overflow(M):
    rng = random.Random(7)
    m = build_cluster(M, rng, 6, zones=0, existing_per_node=0)
    return m, make_batch(M, rng, 120, templates=[dict(cpu="2", memory="4Gi")]), M.PriorityContext(m)


def mixed_affinity_volume_batch(M):
    rng = random.Random(8)
    m = build_cluster(M, rng, 15, zones=2)
    aff = M.api.Affinity(pod_anti_affinity_required=[_term(M, {"app": "solo"}, HOST)])
    pods = []
    for i in range(90):
        if i % 10 == 5:
            pods.append(M.tu.make_pod(f"solo-{i}", cpu="100m", labels={"app": "solo"},
                                      affinity=aff))
        elif i % 17 == 3:
            pods.append(M.tu.make_pod(f"vol-{i}", cpu="100m", volumes=[M.api.Volume(
                name="v", disk_id=f"pd-{i % 4}", disk_kind="gce-pd")]))
        else:
            pods.append(M.tu.make_pod(f"plain-{i}", cpu="200m", memory="256Mi",
                                      labels={"app": "web"}))
    return m, pods, M.PriorityContext(m)


def existing_affinity_pods(M):
    rng = random.Random(9)
    m = build_cluster(M, rng, 12, zones=3, existing_per_node=0)
    names = sorted(m)
    anti = M.api.Affinity(pod_anti_affinity_required=[_term(M, {"app": "web"}, ZONE)])
    pref = M.api.Affinity(pod_affinity_preferred=[_weighted(M, 7, {"app": "web"}, ZONE)])
    m[names[0]].add_pod(M.tu.make_pod("lonely", cpu="100m", labels={"app": "db"}, affinity=anti,
                                      node_name=names[0]))
    m[names[1]].add_pod(M.tu.make_pod("friendly", cpu="100m", labels={"app": "cache"},
                                      affinity=pref, node_name=names[1]))
    pods = [M.tu.make_pod(f"web-{i}", cpu="100m", labels={"app": "web"}) for i in range(24)]
    return m, pods, M.PriorityContext(m)


def large_randomized(M):
    rng = random.Random(10)
    m = build_cluster(M, rng, 60, zones=4, tainted_frac=0.15, existing_per_node=3)
    svcs = [M.api.Service(meta=M.api.ObjectMeta(name=a), selector={"app": a})
            for a in ("web", "db")]
    return m, make_batch(M, rng, 400), M.PriorityContext(m, services=svcs)


def batch_required_anti_affinity_self(M):
    rng = random.Random(20)
    m = build_cluster(M, rng, 10, zones=2, existing_per_node=0)
    aff = M.api.Affinity(pod_anti_affinity_required=[_term(M, {"app": "solo"}, HOST)])
    pods = [M.tu.make_pod(f"solo-{i}", cpu="100m", labels={"app": "solo"}, affinity=aff)
            for i in range(14)]
    return m, pods, M.PriorityContext(m)


def batch_required_affinity_first_pod_rule(M):
    rng = random.Random(21)
    m = build_cluster(M, rng, 12, zones=3, existing_per_node=0)
    aff = M.api.Affinity(pod_affinity_required=[_term(M, {"app": "herd"}, ZONE)])
    pods = [M.tu.make_pod(f"herd-{i}", cpu="100m", labels={"app": "herd"}, affinity=aff)
            for i in range(9)]
    return m, pods, M.PriorityContext(m)


def batch_required_affinity_unsatisfiable(M):
    rng = random.Random(22)
    m = build_cluster(M, rng, 6, zones=2, existing_per_node=0)
    aff = M.api.Affinity(pod_affinity_required=[_term(M, {"app": "ghost"}, ZONE)])
    pods = [M.tu.make_pod(f"p-{i}", cpu="100m", labels={"app": "real"}, affinity=aff)
            for i in range(4)]
    return m, pods, M.PriorityContext(m)


def batch_preferred_affinity_scoring(M):
    rng = random.Random(23)
    m = build_cluster(M, rng, 9, zones=3, existing_per_node=1)
    pref = M.api.Affinity(pod_affinity_preferred=[_weighted(M, 50, {"app": "web"}, ZONE)])
    anti = M.api.Affinity(pod_anti_affinity_preferred=[_weighted(M, 30, {"app": "web"}, ZONE)])
    pods = []
    for i in range(30):
        if i % 3 == 0:
            pods.append(M.tu.make_pod(f"seed-{i}", cpu="100m", labels={"app": "web"}))
        elif i % 3 == 1:
            pods.append(M.tu.make_pod(f"follow-{i}", cpu="100m", labels={"app": "f"},
                                      affinity=pref))
        else:
            pods.append(M.tu.make_pod(f"avoid-{i}", cpu="100m", labels={"app": "a"},
                                      affinity=anti))
    return m, pods, M.PriorityContext(m)


def batch_symmetric_required_affinity_weight(M):
    rng = random.Random(24)
    m = build_cluster(M, rng, 8, zones=2, existing_per_node=0)
    req = M.api.Affinity(pod_affinity_required=[_term(M, {"app": "web"}, ZONE)])
    pods = [M.tu.make_pod("web-seed", cpu="100m", labels={"app": "web"}),
            M.tu.make_pod("clingy", cpu="100m", labels={"app": "clingy"}, affinity=req)]
    pods += [M.tu.make_pod(f"web-{i}", cpu="100m", labels={"app": "web"}) for i in range(10)]
    return m, pods, M.PriorityContext(m, hard_pod_affinity_weight=40)


def volume_disk_conflict_and_limits(M):
    rng = random.Random(25)
    m = build_cluster(M, rng, 8, zones=2, existing_per_node=0)
    vol = M.api.Volume
    pods = []
    for i in range(40):
        if i % 4 == 0:  # exclusive EBS disk: two pods sharing an id conflict
            pods.append(M.tu.make_pod(f"ebs-{i}", cpu="50m", volumes=[vol(
                name="v", disk_id=f"ebs-{i % 6}", disk_kind="aws-ebs")]))
        elif i % 4 == 1:  # read-only gce-pd: sharable
            pods.append(M.tu.make_pod(f"pd-ro-{i}", cpu="50m", volumes=[vol(
                name="v", disk_id="pd-shared", disk_kind="gce-pd", read_only=True)]))
        elif i % 4 == 2:  # writable gce-pd: not sharable
            pods.append(M.tu.make_pod(f"pd-rw-{i}", cpu="50m", volumes=[vol(
                name="v", disk_id=f"pd-rw-{i % 5}", disk_kind="gce-pd")]))
        else:
            pods.append(M.tu.make_pod(f"plain-{i}", cpu="100m", memory="128Mi"))
    return m, pods, M.PriorityContext(m)


def max_volume_count(M):
    m = {"only": M.NodeInfo(M.tu.make_node("only", cpu="64", memory="128Gi", pods=110))}
    pods = [M.tu.make_pod(f"az-{i}", cpu="10m", volumes=[M.api.Volume(
        name="v", disk_id=f"az-{i}", disk_kind="azure-disk")]) for i in range(18)]
    return m, pods, M.PriorityContext(m)


def pvc_zone_and_node_affinity(M):
    sel = importlib.import_module(f"{M.api.__name__}.selectors")
    rng = random.Random(26)
    m = build_cluster(M, rng, 9, zones=3, existing_per_node=0)
    names = sorted(m)
    meta = M.api.ObjectMeta
    pvs = {
        "pv-z1": M.api.PersistentVolume(meta=meta(name="pv-z1"), zone="zone-1", phase="Bound"),
        "pv-local": M.api.PersistentVolume(
            meta=meta(name="pv-local"), phase="Bound",
            node_affinity=sel.NodeSelector(terms=[sel.NodeSelectorTerm(match_expressions=[
                sel.Requirement(HOST, "In", [names[4]])])])),
    }
    pvcs = {
        "default/claim-z1": M.api.PersistentVolumeClaim(meta=meta(name="claim-z1"),
                                                        volume_name="pv-z1", phase="Bound"),
        "default/claim-local": M.api.PersistentVolumeClaim(meta=meta(name="claim-local"),
                                                           volume_name="pv-local", phase="Bound"),
        "default/claim-unbound": M.api.PersistentVolumeClaim(meta=meta(name="claim-unbound")),
    }
    pods = []
    for i in range(24):
        claim = {0: "claim-z1", 1: "claim-local", 2: "claim-unbound"}.get(i % 4)
        prefix = {0: "zonal", 1: "local", 2: "lost"}.get(i % 4, "plain")
        vols = [M.api.Volume(name="v", pvc_name=claim)] if claim else None
        pods.append(M.tu.make_pod(f"{prefix}-{i}", cpu="50m" if claim else "100m",
                                  volumes=vols))
    return m, pods, M.PriorityContext(m, pvcs=pvcs, pvs=pvs)


def large_randomized_with_affinity_and_volumes(M):
    rng = random.Random(27)
    m = build_cluster(M, rng, 40, zones=4, tainted_frac=0.1, existing_per_node=2)
    svcs = [M.api.Service(meta=M.api.ObjectMeta(name=a), selector={"app": a})
            for a in ("web", "db")]
    soft = M.api.Affinity(pod_affinity_preferred=[_weighted(M, 10, {"app": "web"}, ZONE)])
    anti = M.api.Affinity(pod_anti_affinity_required=[_term(M, {"app": "lonely"}, HOST)])
    pods = []
    for i in range(300):
        r = rng.random()
        if r < 0.1:
            pods.append(M.tu.make_pod(f"soft-{i}", cpu="100m", labels={"app": "web"},
                                      affinity=soft))
        elif r < 0.2:
            pods.append(M.tu.make_pod(f"lonely-{i}", cpu="100m", labels={"app": "lonely"},
                                      affinity=anti))
        elif r < 0.3:
            pods.append(M.tu.make_pod(f"vol-{i}", cpu="100m", volumes=[M.api.Volume(
                name="v", disk_id=f"pd-{rng.randrange(30)}",
                disk_kind=rng.choice(["gce-pd", "aws-ebs"]))]))
        else:
            t = rng.choice([dict(cpu="100m", memory="128Mi", labels={"app": "web"}),
                            dict(cpu="500m", memory="512Mi", labels={"app": "db"})])
            pods.append(M.tu.make_pod(f"plain-{i}", **t))
    return m, pods, M.PriorityContext(m, services=svcs)


# scenario -> (builder, priorities: None (the default set) or "autoscaler")
SCENARIOS = {
    "basic_resources": (basic_resources, None),
    "zones_spread_services": (zones_spread_services, None),
    "replicaset_owners_and_spread": (replicaset_owners_and_spread, None),
    "most_requested_binpack": (most_requested_binpack, "autoscaler"),
    "taints_and_node_affinity": (taints_and_node_affinity, None),
    "host_ports": (host_ports, None),
    "unschedulable_overflow": (unschedulable_overflow, None),
    "mixed_affinity_volume_batch_stays_on_kernel": (mixed_affinity_volume_batch, None),
    "existing_affinity_pods_affect_eligible_batch": (existing_affinity_pods, None),
    "large_randomized": (large_randomized, None),
    "batch_required_anti_affinity_self": (batch_required_anti_affinity_self, None),
    "batch_required_affinity_first_pod_rule": (batch_required_affinity_first_pod_rule, None),
    "batch_required_affinity_unsatisfiable": (batch_required_affinity_unsatisfiable, None),
    "batch_preferred_affinity_scoring": (batch_preferred_affinity_scoring, None),
    "batch_symmetric_required_affinity_weight": (batch_symmetric_required_affinity_weight, None),
    "volume_disk_conflict_and_limits": (volume_disk_conflict_and_limits, None),
    "max_volume_count_enforced": (max_volume_count, None),
    "pvc_zone_and_node_affinity": (pvc_zone_and_node_affinity, None),
    "large_randomized_with_affinity_and_volumes": (large_randomized_with_affinity_and_volumes,
                                                   None),
}


# -- the shared helper ------------------------------------------------------------

def assert_parity(name, monkeypatch):
    """Scenario ``name`` through the JAX backend, the port's on the CPU and
    each package's oracle: equal bindings and counters everywhere, equal
    ``r_sel`` in both tensorizers, and a device resource axis of
    ``len(r_sel)`` on every segment the port carries.  Returns (the port
    backend, the port's world, its bindings)."""
    build, prio = SCENARIOS[name]
    out = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        m, pods, pctx = build(M)
        priorities = (importlib.import_module(f"{pkg}.scheduler").cluster_autoscaler_priorities()
                      if prio else None)
        oracle = M.gs.GenericScheduler(priorities=priorities)
        want = cases.oracle_batch(pkg, pods, m, pctx, oracle)
        algo = M.gs.GenericScheduler(priorities=priorities)
        if pkg == JAX:
            backend = TPUBatchBackend(algorithm=algo, kernel_impl="xla")
        else:
            backend = BatchBackend(algorithm=algo, device="cpu")
            widths = cases.record_resource_widths(monkeypatch)
        got = backend.schedule_batch(pods, m, pctx)
        mismatches = [(p.meta.name, w, g) for p, w, g in zip(pods, want, got) if w != g]
        assert not mismatches, f"{pkg}: {len(mismatches)} mismatches, first: {mismatches[:5]}"
        assert algo._round_robin == oracle._round_robin, f"{pkg}: tie-break counter diverged"
        static = M.snapshot.Tensorizer().build_static(pods, m, pctx)
        sel = None if static is None or static.r_sel is None else list(static.r_sel)
        out[pkg] = (got, algo._round_robin, sel, backend, m)
        if pkg == PORT:
            assert widths and all(len(w) == 1 for w in widths), widths
    (jgot, jrr, jsel, jb, _), (pgot, prr, psel, pb, pm) = out[JAX], out[PORT]
    assert (pgot, prr, psel) == (jgot, jrr, jsel)
    for k in ("kernel_pods", "oracle_pods"):
        assert pb.stats[k] == jb.stats[k], k
    return pb, pm, pgot


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parity(name, monkeypatch):
    pb, _, _ = assert_parity(name, monkeypatch)
    assert pb.stats["kernel_pods"] > 0, "the scan never ran"


# the scenarios that pin more than parity (the JAX tests' own extra checks)
ALL_ON_SCAN = {
    "mixed_affinity_volume_batch_stays_on_kernel": 90,
    "existing_affinity_pods_affect_eligible_batch": 24,
    "batch_required_anti_affinity_self": 14,
    "batch_required_affinity_first_pod_rule": 9,
    "batch_preferred_affinity_scoring": 30,
    "batch_symmetric_required_affinity_weight": 12,
    "volume_disk_conflict_and_limits": 40,
    "large_randomized_with_affinity_and_volumes": 300,
}


@pytest.mark.parametrize("name", sorted(ALL_ON_SCAN))
def test_batch_stays_on_the_scan(name, monkeypatch):
    """Pods with their own terms and disks are scan-expressible: no pod of
    the batch goes to the oracle, and the first two scenarios' whole
    batches run as one segment."""
    pb, _, _ = assert_parity(name, monkeypatch)
    assert pb.stats["oracle_pods"] == 0 and pb.stats["kernel_pods"] == ALL_ON_SCAN[name]
    if name == "mixed_affinity_volume_batch_stays_on_kernel":
        assert pb.stats["segments"] == 1


def test_host_ports_and_overflow_leave_pods_unbound(monkeypatch):
    """10 nodes, 15 pods on one host port: at least 5 fail in both
    packages; 6 small nodes overflow with 2-cpu pods; the first-pod rule
    packs one zone; an unsatisfiable affinity binds nothing."""
    _, _, got = assert_parity("host_ports", monkeypatch)
    assert got.count(None) >= 5 and len(set(got) - {None}) == len(got) - got.count(None)
    _, _, got = assert_parity("unschedulable_overflow", monkeypatch)
    assert None in got and any(got)
    _, m, got = assert_parity("batch_required_affinity_first_pod_rule", monkeypatch)
    assert len({m[n].node.meta.labels[ZONE] for n in got}) == 1
    _, _, got = assert_parity("batch_required_affinity_unsatisfiable", monkeypatch)
    assert got == [None] * 4


def test_max_volume_count_and_pvc_placement(monkeypatch):
    """The azure-disk limit of 16 spills 2 pods; zonal claims land in
    zone-1, local ones on the PV's node, unbound ones nowhere."""
    _, _, got = assert_parity("max_volume_count_enforced", monkeypatch)
    assert got.count(None) == 2
    _, m, got = assert_parity("pvc_zone_and_node_affinity", monkeypatch)
    names = sorted(m)
    for i, node in enumerate(got):
        if i % 4 == 0:
            assert m[node].node.meta.labels[ZONE] == "zone-1"
        elif i % 4 == 1:
            assert node == names[4]
        elif i % 4 == 2:
            assert node is None


def test_build_static_rows_equal_the_jax_uncached_sweep(monkeypatch):
    """Twin of ``test_build_static_row_cache_equivalence``: the port's
    tensorizer always reuses its node-static rows; its arrays equal the
    JAX tensorizer's with the row cache off (a full per-signature sweep),
    prefer-avoid controller refs and an annotated node included."""
    import kubernetes_tpu.models.snapshot as jsnap

    monkeypatch.setattr(jsnap, "_DISABLE_ROW_CACHE", True)
    got = {}
    for pkg in (JAX, PORT):
        M = cases.mods(pkg)
        rng = random.Random(11)
        m = build_cluster(M, rng, 40, zones=3)
        first = m[sorted(m)[0]].node
        first.meta.annotations[M.priorities.PREFER_AVOID_PODS_ANNOTATION] = "uid-avoided"
        pods = make_batch(M, rng, 200)
        for i, p in enumerate(pods[:40]):
            uid = "uid-avoided" if i % 4 == 0 else f"uid-{i}"
            p.meta.owner_references = [M.api.OwnerReference(
                kind="ReplicaSet", name=f"rs{i}", uid=uid, controller=True)]
        static = M.snapshot.Tensorizer(pad_multiple=64).build_static(
            pods, m, M.PriorityContext(m), prefer_avoid_weight=10000)
        got[pkg] = static
    for f in ("static_ok", "node_aff_raw", "taint_intol_raw", "static_score", "interpod_raw",
              "g_request", "node_alloc"):
        np.testing.assert_array_equal(getattr(got[PORT], f), getattr(got[JAX], f), err_msg=f)
    assert list(got[PORT].r_sel) == list(got[JAX].r_sel) == [0, 1]
