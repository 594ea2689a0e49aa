"""Seeded cluster specs shared by the ``test_torch_*`` parity tests.

Every builder takes a package name — ``"kubernetes_tpu"`` (the JAX
reference) or ``"kubernetes_tpu_torch"`` (the port) — and builds the same
cluster from the same seed with that package's own API kinds, ``make_node``
/ ``make_pod`` and ``NodeInfo``: the two packages never share an object.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

HOST = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"
JAX = "kubernetes_tpu"
PORT = "kubernetes_tpu_torch"


def mods(pkg: str) -> SimpleNamespace:
    api = importlib.import_module(f"{pkg}.api")
    return SimpleNamespace(
        api=api,
        tu=importlib.import_module(f"{pkg}.testutil"),
        NodeInfo=importlib.import_module(f"{pkg}.scheduler.nodeinfo").NodeInfo,
        priorities=importlib.import_module(f"{pkg}.scheduler.priorities"),
        PriorityContext=importlib.import_module(f"{pkg}.scheduler.priorities").PriorityContext,
        gs=importlib.import_module(f"{pkg}.scheduler.generic_scheduler"),
        snapshot=importlib.import_module(f"{pkg}.models.snapshot"),
    )


def _affinities(api):
    sel = api.LabelSelector.from_match_labels
    return {
        "soft": api.Affinity(pod_affinity_preferred=[api.WeightedPodAffinityTerm(
            weight=10, term=api.PodAffinityTerm(selector=sel({"app": "web"}), topology_key=ZONE))]),
        "lone": api.Affinity(pod_anti_affinity_required=[api.PodAffinityTerm(
            selector=sel({"app": "lone"}), topology_key=HOST)]),
        "follow": api.Affinity(pod_affinity_required=[api.PodAffinityTerm(
            selector=sel({"app": "db"}), topology_key=ZONE)]),
        "shun": api.Affinity(pod_anti_affinity_preferred=[api.WeightedPodAffinityTerm(
            weight=5, term=api.PodAffinityTerm(selector=sel({"app": "web"}), topology_key=HOST))]),
        "prefer_ssd": api.Affinity(node_affinity_preferred=[api.PreferredSchedulingTerm(
            weight=3, preference=api.NodeSelectorTerm(
                match_expressions=[api.Requirement("disk", "In", ["ssd"])]))]),
    }


def mixed(pkg: str, seed: int = 8, n_nodes: int = 12, n_pods: int = 60):
    """Affinity, anti-affinity, required affinity (first-pod rule), volumes,
    NoSchedule and PreferNoSchedule taints, zones, services, a ReplicaSet,
    host ports, node selectors and preferred node affinity; some existing
    pods carry terms and disks.  Returns (node_info_map, pods, pctx)."""
    M = mods(pkg)
    api, tu = M.api, M.tu
    aff = _affinities(api)
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        name = f"n{i:02d}"
        labels = {HOST: name, ZONE: f"z{i % 3}"}
        if rng.random() < 0.4:
            labels["disk"] = "ssd"
        taints = []
        r = rng.random()
        if r < 0.15:
            taints.append(api.Taint(key="dedicated", value="x", effect="NoSchedule"))
        elif r < 0.3:
            taints.append(api.Taint(key="soft", value="x", effect="PreferNoSchedule"))
        node = tu.make_node(name, cpu=rng.choice(["4", "8"]),
                            memory=rng.choice(["8Gi", "16Gi"]),
                            pods=rng.choice([20, 110]), labels=labels, taints=taints)
        info = M.NodeInfo(node)
        for e in range(rng.randrange(3)):
            kind = rng.random()
            kw = dict(cpu="200m", memory="256Mi", node_name=name,
                      labels={"app": rng.choice(["web", "db", "cache"])})
            if kind < 0.2:
                kw["affinity"] = aff["lone"]
                kw["labels"] = {"app": "lone"}
            elif kind < 0.35:
                kw["affinity"] = aff["soft"]
            elif kind < 0.5:
                kw["volumes"] = [api.Volume(name="v", disk_id=f"d{rng.randrange(5)}",
                                            disk_kind=rng.choice(["gce-pd", "aws-ebs"]))]
            info.add_pod(tu.make_pod(f"ex-{i}-{e}", **kw))
        m[name] = info
    pods = []
    for i in range(n_pods):
        r = rng.random()
        if r < 0.12:
            pods.append(tu.make_pod(f"a{i:03d}", cpu="100m", labels={"app": "web"},
                                    affinity=aff["soft"]))
        elif r < 0.24:
            pods.append(tu.make_pod(f"b{i:03d}", cpu="100m", labels={"app": "lone"},
                                    affinity=aff["lone"]))
        elif r < 0.32:
            pods.append(tu.make_pod(f"f{i:03d}", cpu="100m", labels={"app": "db"},
                                    affinity=aff["follow"]))
        elif r < 0.38:
            pods.append(tu.make_pod(f"s{i:03d}", cpu="150m", labels={"app": "api"},
                                    affinity=aff["shun"]))
        elif r < 0.52:
            pods.append(tu.make_pod(
                f"c{i:03d}", cpu="100m",
                volumes=[api.Volume(name="v", disk_id=f"d{rng.randrange(5)}",
                                    disk_kind=rng.choice(["gce-pd", "aws-ebs"]),
                                    read_only=rng.random() < 0.3)]))
        elif r < 0.58:
            pods.append(tu.make_pod(f"p{i:03d}", cpu="100m", host_ports=[8080]))
        elif r < 0.64:
            pods.append(tu.make_pod(f"q{i:03d}", cpu="250m", node_selector={"disk": "ssd"},
                                    labels={"app": "db"}))
        elif r < 0.7:
            pods.append(tu.make_pod(
                f"t{i:03d}", cpu="200m", labels={"app": "cache"},
                tolerations=[api.Toleration(key="dedicated", operator="Exists")]))
        elif r < 0.76:
            pods.append(tu.make_pod(f"n{i:03d}", cpu="300m", memory="512Mi",
                                    affinity=aff["prefer_ssd"]))
        else:
            pods.append(tu.make_pod(f"d{i:03d}", cpu=rng.choice(["200m", "1"]),
                                    memory="256Mi", labels={"app": "web"}))
    svcs = [api.Service(meta=api.ObjectMeta(name=a), selector={"app": a})
            for a in ("web", "db")]
    rs = api.ReplicaSet(meta=api.ObjectMeta(name="rs-cache"),
                        selector=api.LabelSelector.from_match_labels({"app": "cache"}))
    return m, pods, M.PriorityContext(m, services=svcs, replicasets=[rs])


def plain(pkg: str, seed: int = 1, n_nodes: int = 8, n_pods: int = 50):
    M = mods(pkg)
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"n{i}", cpu=rng.choice(["4", "8"]), memory="16Gi",
                              labels={HOST: f"n{i}", ZONE: f"z{i % 2}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = [M.tu.make_pod(f"p{i:03d}", cpu=rng.choice(["100m", "1"]), memory="256Mi",
                          labels={"app": rng.choice(["web", "db"])})
            for i in range(n_pods)]
    svcs = [M.api.Service(meta=M.api.ObjectMeta(name="web"), selector={"app": "web"})]
    return m, pods, M.PriorityContext(m, services=svcs)


def terms_only(pkg: str, seed: int = 5, n_nodes: int = 10, n_pods: int = 40):
    """Only affinity-bearing pods, no volumes or ports."""
    M = mods(pkg)
    aff = _affinities(M.api)
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"n{i:02d}", cpu="8", memory="16Gi",
                              labels={HOST: f"n{i:02d}", ZONE: f"z{i % 3}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = []
    for i in range(n_pods):
        k = rng.choice(["soft", "lone", "follow", "shun"])
        app = {"soft": "web", "lone": "lone", "follow": "db", "shun": "api"}[k]
        pods.append(M.tu.make_pod(f"t{i:03d}", cpu="100m", labels={"app": app},
                                  affinity=aff[k]))
    return m, pods, M.PriorityContext(m)


def volumes_only(pkg: str, seed: int = 6, n_nodes: int = 6, n_pods: int = 60):
    """Disk pods only: conflicts, read-only sharing, count-only slots and
    the per-kind volume-count limits (few nodes, many disks)."""
    M = mods(pkg)
    api = M.api
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"n{i}", cpu="32", memory="64Gi", labels={HOST: f"n{i}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = []
    for i in range(n_pods):
        vols = [api.Volume(name=f"v{s}", disk_id=f"d{rng.randrange(40)}",
                           disk_kind=rng.choice(["gce-pd", "aws-ebs", "iscsi"]),
                           read_only=rng.random() < 0.4)
                for s in range(rng.randrange(1, 4))]
        pods.append(M.tu.make_pod(f"v{i:03d}", cpu="100m", volumes=vols))
    return m, pods, M.PriorityContext(m)


def ties(pkg: str, n_nodes: int = 9, n_pods: int = 40):
    """Identical nodes and identical pods: every step is a tie among many
    nodes, so the round-robin rotation decides each pick."""
    M = mods(pkg)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"n{i}", cpu="64", memory="128Gi", labels={HOST: f"n{i}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = [M.tu.make_pod(f"p{i:03d}", cpu="10m", memory="16Mi") for i in range(n_pods)]
    return m, pods, M.PriorityContext(m)


def few_feasible(pkg: str, n_pods: int = 12):
    """n_feasible in {0, 1}: pinned pods fit exactly one node, oversized
    pods fit none."""
    M = mods(pkg)
    m = {}
    for i in range(4):
        node = M.tu.make_node(f"n{i}", cpu="2", memory="4Gi", labels={HOST: f"n{i}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = []
    for i in range(n_pods):
        if i % 3 == 0:
            pods.append(M.tu.make_pod(f"big{i:02d}", cpu="16"))
        elif i % 3 == 1:
            pods.append(M.tu.make_pod(f"pin{i:02d}", cpu="500m", node_selector={HOST: "n2"}))
        else:
            pods.append(M.tu.make_pod(f"any{i:02d}", cpu="500m"))
    return m, pods, M.PriorityContext(m)


def many_zones(pkg: str, n_zones: int = 16, seed: int = 3, n_nodes: int = 64, n_pods: int = 80):
    """A zone key spanning ``n_zones`` zones (more than the kernel keeps in
    registers), services and a ReplicaSet so the zone spread score decides
    ties, uneven capacities, some existing pods."""
    M = mods(pkg)
    api, tu = M.api, M.tu
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        name = f"n{i:03d}"
        node = tu.make_node(name, cpu=rng.choice(["4", "8", "16"]), memory="32Gi",
                            labels={HOST: name, ZONE: f"z{(i * 7) % n_zones}"})
        info = M.NodeInfo(node)
        for e in range(rng.randrange(3)):
            info.add_pod(tu.make_pod(f"ex-{i}-{e}", cpu="100m", node_name=name,
                                     labels={"app": rng.choice(["web", "db"])}))
        m[name] = info
    pods = [tu.make_pod(f"p{i:03d}", cpu=rng.choice(["100m", "500m"]), memory="128Mi",
                        labels={"app": rng.choice(["web", "db", "cache"])})
            for i in range(n_pods)]
    svcs = [api.Service(meta=api.ObjectMeta(name=a), selector={"app": a}) for a in ("web", "db")]
    rs = api.ReplicaSet(meta=api.ObjectMeta(name="rs-cache"),
                        selector=api.LabelSelector.from_match_labels({"app": "cache"}))
    return m, pods, M.PriorityContext(m, services=svcs, replicasets=[rs])


def host_ports(pkg: str, n_ports: int = 200, seed: int = 4, n_nodes: int = 16, n_pods: int = None,
               wide: int = 0):
    """``n_ports`` distinct host ports over the batch (every pod its own,
    a few pods repeating one), on few nodes so ports collide; ``wide``
    adds, fourth in the batch, a pod with that many ports of its own."""
    M = mods(pkg)
    rng = random.Random(seed)
    m = {}
    for i in range(n_nodes):
        node = M.tu.make_node(f"n{i:02d}", cpu="64", memory="128Gi", pods=200,
                              labels={HOST: f"n{i:02d}", ZONE: f"z{i % 3}"})
        m[node.meta.name] = M.NodeInfo(node)
    pods = [M.tu.make_pod(f"p{i:03d}", cpu="100m", labels={"app": "web"},
                          host_ports=[9000 + i])
            for i in range(n_ports)]
    for i in range(n_pods or n_ports // 4):
        pods.insert(rng.randrange(len(pods)), M.tu.make_pod(
            f"r{i:03d}", cpu="100m", host_ports=[9000 + rng.randrange(n_ports)]))
    if wide:
        pods.insert(3, M.tu.make_pod("wide", cpu="100m",
                                     host_ports=list(range(20000, 20000 + wide))))
    return m, pods, M.PriorityContext(m)


CASES = {
    "many_zones": many_zones,
    "host_ports": host_ports,
    "plain": plain,
    "mixed": mixed,
    "terms_only": terms_only,
    "volumes_only": volumes_only,
    "ties": ties,
    "few_feasible": few_feasible,
}


def oracle_batch(pkg: str, pods, node_info_map, pctx, algorithm):
    """Sequential oracle with cache feedback, in package ``pkg``."""
    M = mods(pkg)
    work = {n: i.clone() for n, i in node_info_map.items()}
    wctx = M.PriorityContext(
        work, services=pctx.services, replicasets=pctx.replicasets,
        hard_pod_affinity_weight=pctx.hard_pod_affinity_weight,
        pvcs=pctx.pvcs, pvs=pctx.pvs)
    out = []
    for pod in pods:
        try:
            res = algorithm.schedule(pod, work, wctx)
            out.append(res.node_name)
            work[res.node_name].add_pod(pod)
        except M.gs.FitError:
            out.append(None)
    return out


def record_resource_widths(monkeypatch) -> list:
    """Wrap the port backend's ``from_reference``: every segment it carries
    to the device appends the set {``len(r_sel)`` (4 for None), the device
    ``node_alloc``, ``g_request`` and ``requested`` widths}, one value when
    the carry cut every resource axis to ``r_sel``."""
    backend = importlib.import_module(f"{PORT}.ops.backend")
    carry, widths = backend.from_reference, []

    def recording(static, init, device, **kw):
        s, st = carry(static, init, device, **kw)
        r_sel = static.get("r_sel")
        widths.append({4 if r_sel is None else len(r_sel), s.node_alloc.shape[1],
                       s.g_request.shape[1], st.requested.shape[1]})
        return s, st

    monkeypatch.setattr(backend, "from_reference", recording)
    return widths


def tensorize(pkg: str, case: str, **kw):
    """(BatchStatic, InitialState) of one case through package ``pkg``'s
    own tensorizer, default weights, with a HostBatchState."""
    M = mods(pkg)
    m, pods, pctx = CASES[case](pkg, **kw)
    tz = M.snapshot.Tensorizer(pad_multiple=128)
    static = tz.build_static(pods, m, pctx)
    host_state = M.snapshot.HostBatchState(m)
    init = tz.initial_state(static, m, pctx, pods, host_state=host_state)
    return static, init


def refresh_segment(g: int, n: int, t: int = 4, pv: int = 0, use_terms: bool = True,
                    use_ports: bool = False, seed: int = 0, r: int = 4):
    """A seeded synthetic segment for the frontier refresh at any shape:
    (static, init) dicts of numpy arrays under the tensorizer's field names
    (``carry.from_reference`` takes them), one pod.  Every component of the
    monotone plane fires somewhere: columns that do not exist, full pod
    slots, resources near their allocatable, zero requests, taken host
    ports, own required anti-affinity terms with ``dm > 0`` and matching
    ones with ``downer > 0``; ``still_ok`` starts partly dead."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i32 = np.int32
    t = t if use_terms else 0

    def bits(shape, p):
        return rng.random(shape) < p

    alloc = rng.integers(500, 4000, (n, r)).astype(i32)
    alloc[bits((n, r), 0.02)] = 0
    requested = np.maximum(alloc - rng.integers(0, 4000, (n, r)), 0).astype(i32)
    alloc_pods = rng.integers(1, 12, n).astype(i32)
    g_request = rng.integers(100, 1500, (g, r)).astype(i32)
    g_request[bits((g, r), 0.5)] = 0
    static = dict(
        n_pad=n, num_zones=1, weights={}, terms=t, use_vols=False, use_ports=use_ports,
        v_state=1,
        node_exists=bits(n, 0.92), node_alloc=alloc, node_alloc_pods=alloc_pods,
        node_zone=np.zeros(n, i32), static_ok=bits((g, n), 0.85),
        node_aff_raw=np.zeros((g, n), i32), taint_intol_raw=np.zeros((g, n), i32),
        static_score=np.zeros((g, n), i32), interpod_raw=np.zeros((g, n), i32),
        g_request=g_request, g_nonzero=g_request[:, :2].copy(),
        g_ports=bits((g, pv), 3.0 / max(pv, 1)), g_has_spread=np.zeros(g, bool),
        spread_inc=np.zeros((g, g), i32),
        term_matches_sig=bits((t, g), 0.3), sym_w=rng.integers(0, 3, t).astype(i32),
        own_w=np.zeros((g, t), i32), own_ra=bits((g, t), 0.1), own_raa=bits((g, t), 0.25),
        own_all=bits((g, t), 0.2), is_raa=bits(t, 0.6), self_match=bits(t, 0.5),
        node_domain=rng.integers(0, 4, (t, n)).astype(i32), dom_valid=bits((t, n), 0.9),
        vol_limits=np.zeros(1, i32), group_of_pod=np.zeros(1, i32),
        pod_vol_ids=np.zeros((1, 1), i32), pod_vol_valid=np.zeros((1, 1), bool),
        pod_vol_ro_ok=np.zeros((1, 1), bool), pod_vol_kind=np.zeros((1, 1), i32),
        pod_vol_count_only=np.zeros((1, 1), bool))
    init = dict(
        requested=requested, nonzero_requested=requested[:, :2].copy(),
        pod_count=rng.integers(0, alloc_pods + 1).astype(i32),
        ports_used=bits((n, pv), 0.05), spread_counts=np.zeros((g, n), i32), round_robin=0,
        dm=(rng.integers(0, 3, (t, n)) * bits((t, n), 0.2)).astype(i32),
        downer=bits((t, n), 0.1).astype(i32), total_match=np.zeros(t, i32),
        vol_any=np.zeros((1, n), bool), vol_ns=np.zeros((1, n), bool), nk=np.zeros((1, n), i32),
        still_ok=bits((g, n), 0.9))
    return static, init
