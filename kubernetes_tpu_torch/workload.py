"""Seeded cluster and pending-pod generators for drives of the batch path:
the scheduler-throughput harness's ``plain`` and ``mixed`` workloads
(fake nodes plus a flood of pending pods, in the shape of the reference's
``test/integration/scheduler_perf``).

``plain``: four homogeneous RC-style templates.  ``mixed``: adds ~20%
affinity-bearing pods (soft zone co-location and required hostname
anti-affinity), ~10% disk-volume pods, node selectors, and
toleration-bearing pods for tainted capacity.
"""

from __future__ import annotations

import random
from typing import Optional

from .api import (
    Affinity,
    LabelSelector,
    ObjectMeta,
    PodAffinityTerm,
    Service,
    Taint,
    Toleration,
    Volume,
    WeightedPodAffinityTerm,
)
from .store.store import object_key
from .testutil import make_node, make_pod

ZONE = "failure-domain.beta.kubernetes.io/zone"


def make_nodes(n_nodes: int, rng: random.Random, workload: str):
    nodes = []
    for i in range(n_nodes):
        labels = {
            "kubernetes.io/hostname": f"node-{i:05d}",
            ZONE: f"zone-{i % 3}",
        }
        taints = []
        if workload == "mixed":
            if rng.random() < 0.3:
                labels["disk"] = rng.choice(["ssd", "hdd"])
            if rng.random() < 0.1:
                taints.append(Taint(key="dedicated", value="special", effect="NoSchedule"))
        nodes.append(
            make_node(
                f"node-{i:05d}",
                cpu=rng.choice(["8", "16", "32"]),
                memory=rng.choice(["16Gi", "32Gi", "64Gi"]),
                pods=110,
                labels=labels,
                taints=taints,
            )
        )
    return nodes


def make_services():
    return [
        Service(meta=ObjectMeta(name=app), selector={"app": app})
        for app in ("web", "api", "db")
    ]


def make_pods(n_pods: int, rng: random.Random, workload: str):
    plain_templates = [
        dict(cpu="100m", memory="128Mi", labels={"app": "web"}),
        dict(cpu="250m", memory="256Mi", labels={"app": "api"}),
        dict(cpu="500m", memory="512Mi", labels={"app": "db"}),
        dict(cpu="1", memory="1Gi", labels={"app": "batch"}),
    ]
    if workload == "plain":
        return [
            make_pod(f"pod-{i:06d}", **plain_templates[i % len(plain_templates)])
            for i in range(n_pods)
        ]

    soft = Affinity(
        pod_affinity_preferred=[
            WeightedPodAffinityTerm(
                weight=10,
                term=PodAffinityTerm(
                    selector=LabelSelector.from_match_labels({"app": "web"}),
                    topology_key=ZONE,
                ),
            )
        ]
    )
    anti = Affinity(
        pod_anti_affinity_required=[
            PodAffinityTerm(
                selector=LabelSelector.from_match_labels({"app": "lonely"}),
                topology_key="kubernetes.io/hostname",
            )
        ]
    )
    pods = []
    for i in range(n_pods):
        r = rng.random()
        if r < 0.10:
            pods.append(
                make_pod(f"soft-{i:06d}", cpu="100m", memory="128Mi",
                         labels={"app": "web"}, affinity=soft)
            )
        elif r < 0.20:
            pods.append(
                make_pod(f"lonely-{i:06d}", cpu="100m", memory="128Mi",
                         labels={"app": "lonely"}, affinity=anti)
            )
        elif r < 0.30:
            pods.append(
                make_pod(
                    f"vol-{i:06d}", cpu="100m", memory="128Mi", labels={"app": "api"},
                    volumes=[Volume(name="v", disk_id=f"pd-{rng.randrange(2 * n_pods)}",
                                    disk_kind=rng.choice(["gce-pd", "aws-ebs"]))],
                )
            )
        elif r < 0.35:
            pods.append(
                make_pod(f"ssd-{i:06d}", cpu="250m", memory="256Mi",
                         labels={"app": "db"}, node_selector={"disk": "ssd"})
            )
        elif r < 0.40:
            pods.append(
                make_pod(
                    f"tol-{i:06d}", cpu="200m", memory="128Mi", labels={"app": "batch"},
                    tolerations=[Toleration(key="dedicated", operator="Exists")],
                )
            )
        else:
            pods.append(
                make_pod(f"pod-{i:06d}", **plain_templates[i % len(plain_templates)])
            )
    return pods


def create_cluster(cs, n_nodes: int, total_pods: int, workload: str, seed: int):
    """Create the churn preset's nodes (and, for ``mixed``, its services)
    through the clientset ``cs`` (in-process or over the wire), each kind
    in one ``create_many``, in the order and from the seed the reference
    harness (``bench.py`` ``_run_churn_timed``) uses.  Returns the pods to
    arrive, not yet created."""
    rng = random.Random(seed)
    kinds = [(cs.nodes, make_nodes(n_nodes, rng, workload))]
    if workload == "mixed":
        kinds.append((cs.services, make_services()))
    for client, objs in kinds:
        failed = sum(d is None for d in client.create_many(objs))
        if failed:
            raise RuntimeError(f"{failed} of {len(objs)} {client.kind} creates failed")
    return make_pods(total_pods, rng, workload)


def _churn_cluster(n_nodes: int, total_pods: int, workload: str, seed: int):
    """An in-process store seeded by ``create_cluster``, plus the pods to
    arrive."""
    from .client import Clientset
    from .store import Store

    cs = Clientset(Store(event_log_window=max(200_000, 2 * (n_nodes + total_pods))))
    return cs, create_cluster(cs, n_nodes, total_pods, workload, seed)


def run_churn(n_nodes: int = 5_000, total_pods: int = 20_000, waves: int = 10,
              workload: str = "mixed", seed: int = 0, device=None,
              lazy_ingest: bool = True, backend_kw: dict | None = None) -> dict:
    """Steady-state arrival load through the port's ``Scheduler`` (the
    reference harness's churn preset, ``bench.py`` ``_run_churn_timed``):
    an arrival thread creates one wave of pods in one ``create_many`` txn
    the moment the previous wave left the queue, and the scheduler serves
    each wave with one ``run_batch_loop`` call on ``BatchBackend``, events
    on and the event sink running.

    ``device`` is the backend's: None means the card and raises without
    one; ``"cpu"`` runs the plain scan.  ``backend_kw`` goes to the
    ``BatchBackend`` (``frontier_mesh=True, mesh_devices=4`` runs the
    frontier loop on a 4-shard node-axis mesh).  ``lazy_ingest`` (the default)
    runs the serving ingest path: lazy decode, watch frames, columnar
    LIST and the frame confirm; False runs the eager path (typed decode of
    every event, per-event delivery) for the run and restores the default
    after.  Returns bound/unbound counts from the final store state, wall
    seconds and pods/s, e2e p50/p99 in ms, per-wave phases (pump,
    tensorize, dispatch, device_wait, commit and prep seconds, the
    informers' decode and apply seconds, frames, frame events, lazy
    promotions and confirm fallbacks) with the wave's kernel ms, the
    backend's stats, the recorded drain batches, the final binding map and
    the round-robin counter (the inputs of ``oracle_replay_waves``), and
    the counter as each drained batch started (``drain_rr``, held against
    the replay's ``round_robin_before``)."""
    from .api import lazy
    from .store import frames

    saved = lazy.ENABLED, frames.ENABLED
    lazy.ENABLED = frames.ENABLED = lazy_ingest
    try:
        return _run_churn(n_nodes, total_pods, waves, workload, seed, device, backend_kw or {})
    finally:
        lazy.ENABLED, frames.ENABLED = saved


def _run_churn(n_nodes, total_pods, waves, workload, seed, device, backend_kw) -> dict:
    import threading
    import time

    from .api import lazy
    from .ops.backend import BatchBackend
    from .scheduler import GenericScheduler, Scheduler

    algo = GenericScheduler()
    # the scheduler and the backend share one algorithm: the backend writes
    # the round-robin counter after every segment
    backend = BatchBackend(algorithm=algo, device=device, **backend_kw)
    cs, all_pods = _churn_cluster(n_nodes, total_pods, workload, seed)
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=True)
    sched.start()
    sched.broadcaster.start()

    per_wave = total_pods // waves
    pump_acc = [0.0]
    orig_pump = sched.pump

    def timed_pump():
        t = time.perf_counter()
        n = orig_pump()
        pump_acc[0] += time.perf_counter() - t
        return n

    sched.pump = timed_pump

    ingest_keys = ("decode_s", "promotions", "apply_s", "frames", "frame_events", "parse_s")

    def ingest_counters() -> dict:
        """Cumulative ingest counters: the informers' decode and apply
        seconds (the part of pump_s spent on watch events), frames, frame
        events, lazy promotions and the confirm's fallbacks."""
        out = dict(zip(ingest_keys, sched._ingest_stats()))
        out["confirm_fallbacks"] = sched.metrics.confirm_fallbacks.value
        return out

    # wave-drain detection feeds the arrival thread: wave w+1 is created
    # the moment wave w left the queue, so creation overlaps scheduling
    drained = [0]
    drain_batches: list[list[str]] = []
    drain_rr: list[int] = []  # the round-robin counter as each drained batch starts
    wave_drained = [threading.Event() for _ in range(waves)]
    orig_drain = sched.queue.drain

    def recording_drain(max_n=None):
        out = orig_drain(max_n)
        if out:
            drain_batches.append([p.meta.key for p in out])
            drain_rr.append(algo._round_robin)
        drained[0] += len(out)
        for w in range(waves):
            if drained[0] >= (w + 1) * per_wave:
                wave_drained[w].set()
        return out

    sched.queue.drain = recording_drain
    stop_arrivals = threading.Event()

    def arrivals():
        for w in range(waves):
            cs.pods.create_many_nowait(all_pods[w * per_wave:(w + 1) * per_wave])
            while not wave_drained[w].wait(timeout=0.1):
                if stop_arrivals.is_set():
                    return

    arr = threading.Thread(target=arrivals, daemon=True, name="churn-arrivals")
    bound = 0
    phase_timers: list[dict] = []
    t0 = time.perf_counter()
    arr.start()
    try:
        for _ in range(waves):
            pump_before = pump_acc[0]
            ingest_before = ingest_counters()
            b = sched.run_batch_loop(min_batch=per_wave, max_wait=30.0,
                                     max_waves=1, poll_interval=0.002)
            bound += b
            ph = {k: sched.last_batch_phases.get(k, 0.0)
                  for k in ("tensorize_s", "dispatch_s", "device_wait_s",
                            "commit_s", "prep_s", "kernel_ms")}
            ph["pump_s"] = pump_acc[0] - pump_before
            # the wave's frontier segments and, under a mesh, its per-shard
            # attribution
            ph["frontier"] = sched.last_batch_phases.get("frontier", [])
            ph["mesh"] = sched.last_batch_phases.get("mesh")
            ph["round_robin"] = algo._round_robin
            ingest_after = ingest_counters()
            ph.update({k: ingest_after[k] - ingest_before[k] for k in ingest_after})
            ph["bound"] = b
            phase_timers.append(ph)
        elapsed = time.perf_counter() - t0
    finally:
        stop_arrivals.set()
        arr.join(timeout=10)
        sched.broadcaster.stop(drain=True)
    pods_final, _ = cs.pods.list()
    assignments = {p.meta.key: p.spec.node_name or None for p in pods_final}
    m = sched.metrics

    def _pq(h, q):
        v = h.quantile(q)
        return v / 1e3 if v != float("inf") else None

    events, _ = cs.events.list()
    return {
        "nodes": n_nodes,
        "pods": total_pods,
        "waves": waves,
        "device": str(backend.device),
        "lazy_ingest": lazy.ENABLED,
        "bound": bound,
        "unbound": sum(1 for node in assignments.values() if node is None),
        "drained": drained[0],
        "wall_s": elapsed,
        "pods_per_sec": bound / elapsed if elapsed > 0 else 0.0,
        "e2e_scheduling_ms": {"p50": _pq(m.e2e_scheduling_latency, 0.5),
                              "p99": _pq(m.e2e_scheduling_latency, 0.99)},
        "phase_timers": phase_timers,
        "backend": dict(backend.stats),
        "node_cache": dict(backend.device_node_cache.stats),
        "mesh_gauges": {g.name: g.value for g in (m.mesh_shards, m.mesh_worst_shard_upload_fraction,
                                                  m.mesh_shard_alive_skew)},
        "scheduled_events": sum(e.count for e in events if e.reason == "Scheduled"),
        "drain_batches": drain_batches,
        "drain_rr": drain_rr,
        "assignments": assignments,
        "round_robin": algo._round_robin,
    }


def run_wire_churn(url: str, n_nodes: int = 5_000, total_pods: int = 20_000,
                   waves: int = 10, workload: str = "mixed", seed: int = 0,
                   wave_deadline_s: float = 60.0, on_wave=None, crash=None,
                   before_wave=None, kubeconfig: Optional[str] = None) -> dict:
    """The client side of a daemon run: the churn preset driven over the
    wire against the apiserver at ``url``, served by whatever scheduler
    watches it (``python -m kubernetes_tpu_torch.scheduler``).

    Creates the seeded nodes and services, then each wave of pods in one
    ``create_many``; the next wave is created when every pod of the last
    one is bound or carries a ``FailedScheduling`` event, as this client's
    own threaded informers see it over the wire, within
    ``wave_deadline_s`` a wave (else ``TimeoutError``).  Returns the
    bound and unbound counts of the final LIST, the wall seconds of the
    waves and pods/s, the client-observed create→bind p50 and p99 in ms,
    each wave's seconds (and of it the ``create_many`` call's seconds,
    and the wave's create→bind p99), the final binding map and each wave's
    pod keys in creation order.
    ``before_wave(w)`` and ``on_wave(w)``, when given, are called before
    wave ``w`` and after it settled (outside the timed waves).

    ``crash=(w, fn)``: as soon as wave ``w``'s creates are acknowledged,
    while the scheduler drains and binds it, ``fn()`` runs (inside the
    timed wave): the crash drill's LIST, kill and restart of the
    apiserver.  Its return value is the result's ``crash``, with
    ``pending_at_crash``, the wave's pods not yet bound as this client saw
    it when the drill began.

    ``kubeconfig``: connect as that document says (its CA pin and client
    certificate; ``url`` overrides its server), as ``daemon
    .remote_clientset`` does."""
    import threading
    import time

    from .client import Handler, InformerFactory
    from .daemon import remote_clientset

    cs = remote_clientset(url, kubeconfig=kubeconfig, timeout=120.0)
    pods = create_cluster(cs, n_nodes, total_pods, workload, seed)
    cv = threading.Condition()
    created_at: dict[str, float] = {}
    bound_at: dict[str, float] = {}
    pending: set[str] = set()  # the current wave's keys still waiting

    def settle(key: str) -> None:
        pending.discard(key)
        if not pending:
            cv.notify_all()

    def on_pod(pod) -> None:
        if pod.spec.node_name:
            with cv:
                if pod.meta.key not in bound_at:
                    bound_at[pod.meta.key] = time.perf_counter()
                    settle(pod.meta.key)

    def on_event(ev) -> None:
        if ev.reason == "FailedScheduling":
            with cv:
                settle(ev.involved_key)

    factory = InformerFactory(cs)
    factory.informer("Pod").add_handler(Handler(on_add=on_pod,
                                                on_update=lambda old, new: on_pod(new)))
    factory.informer("Event").add_handler(Handler(on_add=on_event,
                                                  on_update=lambda old, new: on_event(new)))
    factory.start_all()
    per_wave = total_pods // waves
    wave_s: list[float] = []
    create_s: list[float] = []
    wave_p99_ms: list = []
    crashed = None
    try:
        t0 = time.perf_counter()
        for w in range(waves):
            batch = pods[w * per_wave:(w + 1) * per_wave]
            if before_wave is not None:
                t_cb = time.perf_counter()
                before_wave(w)
                t0 += time.perf_counter() - t_cb
            t_wave = time.perf_counter()
            with cv:
                for p in batch:
                    created_at[p.meta.key] = t_wave
                    pending.add(p.meta.key)
            cs.pods.create_many_nowait(batch)
            create_s.append(time.perf_counter() - t_wave)
            if crash is not None and crash[0] == w:
                with cv:
                    at_crash = len(pending)
                crashed = crash[1]()
                crashed["pending_at_crash"] = at_crash
            with cv:
                while pending:
                    left = t_wave + wave_deadline_s - time.perf_counter()
                    if left <= 0:
                        raise TimeoutError(
                            f"wave {w}: {len(pending)} pods neither bound nor marked "
                            f"FailedScheduling after {wave_deadline_s} s")
                    cv.wait(timeout=left)
            wave_s.append(time.perf_counter() - t_wave)
            with cv:
                lat = sorted(bound_at[p.meta.key] - t_wave for p in batch
                             if p.meta.key in bound_at)
            wave_p99_ms.append(lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3
                               if lat else None)
            if on_wave is not None:
                t_cb = time.perf_counter()
                on_wave(w)
                t0 += time.perf_counter() - t_cb  # keep the callback off the wall
        wall = time.perf_counter() - t0
    finally:
        factory.stop_all()
    items, _ = cs.store.list("Pod")
    assignments = {object_key(d["metadata"].get("namespace", ""), d["metadata"]["name"]):
                   (d.get("spec") or {}).get("nodeName") or None for d in items}
    lat_ms = sorted((bound_at[k] - created_at[k]) * 1e3 for k in bound_at if k in created_at)

    def pct(q: float):
        return lat_ms[min(len(lat_ms) - 1, int(q * len(lat_ms)))] if lat_ms else None

    bound = sum(1 for n in assignments.values() if n)
    return {
        "nodes": n_nodes, "pods": total_pods, "waves": waves,
        "bound": bound, "unbound": len(assignments) - bound,
        "wall_s": wall, "pods_per_sec": bound / wall if wall > 0 else 0.0,
        "create_to_bind_ms": {"p50": pct(0.5), "p99": pct(0.99)},
        "wave_s": wave_s, "create_s": create_s, "wave_c2b_p99_ms": wave_p99_ms,
        "assignments": assignments,
        # each wave's pod keys in creation order: the per-wave oracle
        # replay's drain batches
        "wave_keys": [[p.meta.key for p in pods[w * per_wave:(w + 1) * per_wave]]
                      for w in range(waves)],
        "crash": crashed if crash is not None else None,
    }


def hollow_fleet(cs, nodes: list, **kubelet_kw):
    """A ``HollowFleet`` over ``cs`` whose kubelet *i* runs ``nodes[i]``:
    its name, cpu, memory, pod slots and labels (``make_nodes``'s cluster
    as kubelets register it).  Taints are not carried: registration sets
    none, as the JAX kubelet's does."""
    from .kubelet import HollowFleet, HollowKubelet

    fleet = HollowFleet(cs, 0)
    fleet.kubelets = [
        HollowKubelet(cs, n.meta.name, pod_index=fleet.index,
                      cpu=str(n.status.capacity["cpu"]),
                      memory=str(n.status.capacity["memory"]),
                      pods=n.status.capacity["pods"].value(),
                      labels=dict(n.meta.labels), **kubelet_kw)
        for n in nodes]
    return fleet


def run_hollow_fleet(url: str, n_nodes: int, workload: str, seed: int, first: int, count: int,
                     stop, results) -> None:
    """A fleet process: the kubelets of nodes ``first .. first+count-1`` of
    the seeded cluster (``make_nodes``), over the wire to ``url``, at the
    kubelet's defaults.  It registers them, puts ``("ready", first,
    seconds)`` on ``results``, then ticks the fleet and waits a second, as
    ``python -m kubernetes_tpu_torch.kubelet`` does, until ``stop`` is set; then it
    puts its report: each tick's seconds and the ticks' summed counters
    (``rejected`` included).  A tick is ``HollowFleet.tick_all``'s, which
    stops between two kubelets once ``stop`` is set, so a long tick does
    not hold the process.  A tick that raises ends the process with a
    nonzero exit code, after the report.  Start it with a ``spawn``
    context."""
    import time

    from .daemon import remote_clientset

    nodes = make_nodes(n_nodes, random.Random(seed), workload)[first:first + count]
    cs = remote_clientset(url, timeout=120.0)
    fleet = hollow_fleet(cs, nodes)
    t = time.perf_counter()
    fleet.register_all()
    results.put(("ready", first, time.perf_counter() - t))
    ticks: list[float] = []
    totals: dict = {}
    try:
        while not stop.is_set():
            t = time.perf_counter()
            fleet.tick_all(stop.is_set, totals)
            ticks.append(time.perf_counter() - t)
            stop.wait(1.0)
    finally:
        fleet.informer.stop()
        results.put(("done", first, {"ticks": ticks, "totals": totals}))


def overcommitted_nodes(pods: list, nodes: list) -> list:
    """Names of the nodes whose bound pods (wire dicts) request more cpu,
    memory or pod slots than the node's allocatable."""
    from .api.quantity import Quantity

    alloc = {n["metadata"]["name"]: (n.get("status") or {}).get("allocatable") or {}
             for n in nodes}
    used: dict[str, list] = {}
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        if not node:
            continue
        u = used.setdefault(node, [Quantity(0), Quantity(0), 0])
        for c in (p.get("spec") or {}).get("containers") or []:
            req = (c.get("resources") or {}).get("requests") or {}
            u[0] += Quantity(req.get("cpu", 0))
            u[1] += Quantity(req.get("memory", 0))
        u[2] += 1
    return sorted(n for n, (cpu, mem, count) in used.items()
                  if Quantity(alloc[n].get("cpu", 0)) < cpu
                  or Quantity(alloc[n].get("memory", 0)) < mem
                  or Quantity(alloc[n].get("pods", 0)).value() < count)


def oracle_replay_waves(drain_batches: list, final_assignments: dict,
                        n_nodes: int, total_pods: int, workload: str,
                        seed: int, algorithm=None, skip: frozenset = frozenset()) -> dict:
    """Per-wave oracle parity for a churn run: replay the recorded drain
    batches, in drain order, through the per-pod CPU oracle
    (``Scheduler(backend=None).run_pending``) on an identically seeded
    cluster, and compare each wave's bindings with the run's final map.
    Exact by prefix closure (pod i's placement depends only on the initial
    cluster and the pods placed before it) as long as no key was drained
    twice; a requeue re-decides under other queue state, so the replay
    then reports itself skipped.  ``algorithm`` replaces the default
    ``GenericScheduler`` (a policy's, say); the keys in ``skip`` are
    replayed but not compared (a pod whose bind failed and was decided
    again)."""
    from .scheduler import GenericScheduler, Scheduler

    flat = [k for b in drain_batches for k in b]
    if len(set(flat)) != len(flat):
        return {"mode": "skipped (requeues present)",
                "checked": 0, "mismatches": -1, "round_robin": None}
    cs, pods = _churn_cluster(n_nodes, total_pods, workload, seed)
    pods_by_key = {p.meta.key: p for p in pods}
    sched = Scheduler(cs, algorithm=algorithm or GenericScheduler(), backend=None,
                      emit_events=False)
    sched.start()
    checked = mismatches = 0
    sample = []
    rr_before = []
    for batch in drain_batches:
        rr_before.append(sched.algorithm._round_robin)
        for key in batch:
            cs.pods.create(pods_by_key[key])
        sched.pump()
        sched.run_pending()
        sched.pump()
        pods_now, _ = cs.pods.list()
        got = {p.meta.key: p.spec.node_name or None for p in pods_now}
        for key in batch:
            if key in skip:
                continue
            checked += 1
            if got.get(key) != final_assignments.get(key):
                mismatches += 1
                if len(sample) < 5:
                    sample.append((key, got.get(key), final_assignments.get(key)))
    return {"mode": "exact per-wave replay", "checked": checked,
            "mismatches": mismatches, "sample": sample,
            "round_robin": sched.algorithm._round_robin,
            "round_robin_before": rr_before}


def oracle_replay_state(objects: dict, arrivals: list, round_robin: int,
                        algorithm=None) -> dict:
    """The per-pod CPU oracle over a cluster given as it was read back:
    ``objects`` maps a kind to its wire dicts (nodes, services, the bound
    pods; whatever the scheduler's informers would list), ``arrivals`` are
    the pods to schedule, in arrival order, and ``round_robin`` is the
    live scheduler's tie-break counter before them.  The oracle
    (``Scheduler(backend=None).run_pending``) starts on that state, the
    arrivals come in one store txn, and it schedules them one by one.
    Returns each arrival's node (None if unbound) and the final counter."""
    from .client import Clientset
    from .scheduler import GenericScheduler, Scheduler
    from .store import Store

    total = sum(len(v) for v in objects.values()) + len(arrivals)
    cs = Clientset(Store(event_log_window=max(200_000, 2 * total)))
    for kind, items in objects.items():
        cs.store.create_many(kind, items)
    sched = Scheduler(cs, algorithm=algorithm or GenericScheduler(), backend=None,
                      emit_events=False)
    sched.algorithm._round_robin = round_robin
    sched.start()
    cs.store.create_many("Pod", arrivals)
    sched.pump()
    sched.run_pending()
    sched.pump()
    keys = {object_key(d["metadata"].get("namespace", ""), d["metadata"]["name"])
            for d in arrivals}
    items, _ = cs.store.list("Pod")
    return {"assignments": {k: (d.get("spec") or {}).get("nodeName") or None
                            for d in items
                            if (k := object_key(d["metadata"].get("namespace", ""),
                                                d["metadata"]["name"])) in keys},
            "round_robin": sched.algorithm._round_robin}


def preemption_nodes(n_nodes: int):
    """The preemption preset's nodes (``bench.py`` ``run_preemption``):
    ``node-%05d`` at 8 CPU / 32 Gi / 110 pods over 3 zones."""
    return [make_node(f"node-{i:05d}", cpu="8", memory="32Gi", pods=110,
                      labels={"kubernetes.io/hostname": f"node-{i:05d}", ZONE: f"zone-{i % 3}"})
            for i in range(n_nodes)]


def preemption_pods(n_fillers: int, n_preemptors: int, seed: int = 0,
                    odd_share: float = 0.0) -> tuple[list, list]:
    """(fillers, preemptors): fillers of 2 CPU / 256 Mi at priority 0 (four
    fill a node's CPU) and preemptors of the same size at priority 100.  A
    seeded ``odd_share`` of the preemptors carries host port 8080 or a
    required zone affinity to the fillers: the branch-and-bound path of
    the cohort pass, not the vectorized one."""
    rng = random.Random(seed)
    fillers = [make_pod(f"filler-{i:06d}", cpu="2", memory="256Mi", labels={"app": "filler"})
               for i in range(n_fillers)]
    follow = Affinity(pod_affinity_required=[PodAffinityTerm(
        selector=LabelSelector.from_match_labels({"app": "filler"}), topology_key=ZONE)])
    preemptors = []
    for i in range(n_preemptors):
        r = rng.random()
        p = make_pod(f"vip-{i:06d}", cpu="2", memory="256Mi", labels={"app": "vip"},
                     host_ports=[8080] if r < odd_share / 2 else None,
                     affinity=follow if odd_share / 2 <= r < odd_share else None)
        p.spec.priority = 100
        preemptors.append(p)
    return fillers, preemptors


def run_preemption(n_nodes: int = 2_000, n_fillers: int = None, n_preemptors: int = None,
                   device=None, seed: int = 0, odd_share: float = 0.0,
                   backend_cls=None) -> dict:
    """The priority-preemption preset (``bench.py`` ``run_preemption``)
    through the port's ``Scheduler`` on ``BatchBackend``: priority-0
    fillers fill every node's CPU in one batch; one batch of priority-100
    preemptors then fails wholesale, the cohort pass evicts a victim set
    for each, and the follow-up batch binds the preemptors into the freed
    space.  Defaults: 4 fillers a node and half as many preemptors as
    nodes.

    ``device`` is the backend's (None: the card); ``backend_cls`` replaces
    ``BatchBackend`` (a checking subclass, say).  Returns the counts
    (attempts, victims, preemptors bound after, fillers bound and
    evicted), **evictions per second** (victims over the cohort pass's
    seconds: attempts would also count grants without an eviction), the
    cohort split (``Scheduler.last_cohort_phases``: state build,
    per-preemptor ranking, evictions with pump and snapshot),
    ``preemption_latency`` p50/p99 in ms, the three batches' seconds and
    the backend's stats."""
    import time

    from .client import Clientset
    from .ops.backend import BatchBackend
    from .scheduler import GenericScheduler, Scheduler
    from .store import Store

    n_fillers = 4 * n_nodes if n_fillers is None else n_fillers
    n_preemptors = n_nodes // 2 if n_preemptors is None else n_preemptors
    fillers, preemptors = preemption_pods(n_fillers, n_preemptors, seed, odd_share)
    cs = Clientset(Store(event_log_window=max(200_000, 4 * (n_nodes + n_fillers))))
    cs.nodes.create_many(preemption_nodes(n_nodes))
    algo = GenericScheduler()
    backend = (backend_cls or BatchBackend)(algorithm=algo, device=device)
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=True)
    sched.start()
    sched.broadcaster.start()
    try:
        cs.pods.create_many(fillers)
        sched.pump()
        t = time.perf_counter()
        fill_bound, _ = sched.schedule_pending_batch()
        fill_s = time.perf_counter() - t
        cs.pods.create_many(preemptors)
        sched.pump()
        t0 = time.perf_counter()
        wave_bound, wave_failed = sched.schedule_pending_batch()  # fails -> cohort
        wave_s = time.perf_counter() - t0
        cohort = dict(sched.last_cohort_phases)
        # read here: the follow-up batch may run a cohort of its own
        m = sched.metrics
        attempts, victims = int(m.preemption_attempts.value), int(m.preemption_victims.value)
        sched.pump()
        t = time.perf_counter()
        bound_after, _ = sched.schedule_pending_batch()  # into the freed space
        follow_s = time.perf_counter() - t
        total_s = time.perf_counter() - t0
    finally:
        sched.broadcaster.stop(drain=True)
    final = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}

    def _pq(h, q):
        v = h.quantile(q)
        return v / 1e3 if v != float("inf") else None

    cohort_s = cohort.get("total_s", 0.0)
    return {
        "nodes": n_nodes, "fillers": n_fillers, "preemptors": n_preemptors,
        "fill_bound": fill_bound, "fill_s": fill_s,
        "wave_bound": wave_bound, "wave_failed": wave_failed, "wave_s": wave_s,
        "attempts": attempts, "victims": victims,
        "preemptor_bound_after": bound_after, "follow_s": follow_s,
        "evictions_per_sec": victims / cohort_s if cohort_s > 0 else 0.0,
        "cohort": cohort,
        "preempt_and_bind_s": total_s,
        "preemption_latency_ms": {"p50": _pq(m.preemption_latency, 0.5),
                                  "p99": _pq(m.preemption_latency, 0.99)},
        "fillers_bound": sum(1 for p in fillers if final.get(p.meta.name)),
        "fillers_evicted": sum(1 for p in fillers if p.meta.name not in final),
        "preemptors_bound": sum(1 for p in preemptors if final.get(p.meta.name)),
        "backend": dict(backend.stats),
        "round_robin": algo._round_robin,
    }


def run_wire_preemption(url: str, n_nodes: int = 1_000, n_fillers: int = None,
                        n_preemptors: int = None, deadline_s: float = 120.0) -> dict:
    """The client side of the preemption preset against a scheduler daemon:
    over the wire, create the nodes and the fillers and wait until every
    filler is bound, then create the preemptors and wait until every one
    is bound (the daemon preempts by default), each within ``deadline_s``
    (else ``TimeoutError``).  Returns the seconds of each wait, the
    preemptors bound, and the fillers left bound and evicted."""
    import time

    from .client import Clientset, RemoteStore

    n_fillers = 4 * n_nodes if n_fillers is None else n_fillers
    n_preemptors = n_nodes // 2 if n_preemptors is None else n_preemptors
    fillers, preemptors = preemption_pods(n_fillers, n_preemptors)
    cs = Clientset(RemoteStore(url, timeout=120.0))
    cs.nodes.create_many(preemption_nodes(n_nodes))

    def bound_names() -> dict:
        items, _ = cs.store.list("Pod")
        return {d["metadata"]["name"]: (d.get("spec") or {}).get("nodeName") or None
                for d in items}

    def wait_bound(pods: list, what: str) -> tuple[float, dict]:
        t = time.perf_counter()
        while True:
            got = bound_names()
            if all(got.get(p.meta.name) for p in pods):
                return time.perf_counter() - t, got
            if time.perf_counter() - t > deadline_s:
                left = sum(1 for p in pods if not got.get(p.meta.name))
                raise TimeoutError(f"{left} {what} not bound after {deadline_s} s")
            time.sleep(0.2)

    cs.pods.create_many(fillers)
    fill_s, _ = wait_bound(fillers, "fillers")
    cs.pods.create_many(preemptors)
    preempt_s, got = wait_bound(preemptors, "preemptors")
    return {
        "nodes": n_nodes, "fillers": n_fillers, "preemptors": n_preemptors,
        "fill_s": fill_s, "preempt_and_bind_s": preempt_s,
        "preemptors_bound": sum(1 for p in preemptors if got.get(p.meta.name)),
        "fillers_bound": sum(1 for p in fillers if got.get(p.meta.name)),
        "fillers_evicted": sum(1 for p in fillers if p.meta.name not in got),
    }


def overload_node(i: int, pods_per_node: int = 200):
    """``node-%05d`` of the overload preset: 8 CPU, distinct memory, a
    generous pod cap (so the surge can outlast the SLO windows), three
    zones."""
    return make_node(f"node-{i:05d}", cpu="8", memory=f"{16_384 + i}Mi", pods=pods_per_node,
                     labels={"kubernetes.io/hostname": f"node-{i:05d}", ZONE: f"zone-{i % 3}"})


# the overload preset's tiers: (priority, share of the surge)
OVERLOAD_TIERS = {"batch": (0, 0.5), "standard": (5, 0.3), "critical": (9, 0.2)}


def run_overload(n_nodes: int = 320, surge_mult: float = 3.0, surge_pods_cap: int = 60_000,
                 max_surge_s: float = 20.0, goodput_deadline_s: float = 5.0, seed: int = 0,
                 fast_window_s: float = 0.5, slow_window_s: float = 1.5,
                 step_hold_s: float = 0.5, device=None, backend_cls=None) -> dict:
    """The overload-control surge preset (``bench.py`` ``run_overload``):
    arrivals at ``surge_mult`` times the measured drain rate through the
    apiserver's create path, and what the degradation ladder does about
    it.  Phases:

    1. **calibrate**: two batches of 768 pods created in the store and
       served by ``run_batch_loop``; the second's rate is the drain rate.
    2. **surge**: six arrival threads pace 25-pod ``create_many`` calls
       over HTTP through one ``RemoteStore`` a tier (batch priority 0,
       standard 5, critical 9 at 50/30/20%, interleaved by largest
       deficit so the mix stays constant) at ``surge_mult`` times the
       drain rate, for at most ``max_surge_s`` of wall time: chunks not
       started by then are never created (creators that fall behind the
       pace do not stretch the surge).  The ladder
       (``overload_slos`` over the queue-depth gauge, scraped every 0.1 s)
       engages; rung 2 sheds the interpod score plane and rung 3
       throttles the batch tier at the apiserver (429 + Retry-After).  A
       pod's e2e is its create attempt to its bind as the scheduler sees
       it.
    3. **recover**: arrivals stop; the time until the ladder is back at
       rung 0 with an empty queue.
    4. **tail**: 300 pods at rung 0, replayed through the per-pod oracle
       from the live bound state and round-robin counter: the tail must
       equal it exactly.

    ``device`` is the backend's (None: the card); ``backend_cls`` replaces
    ``BatchBackend`` (a checking subclass, say).  Returns the drain rate,
    each tier's arrivals, rejected, bound, goodput (bound within
    ``goodput_deadline_s``) and e2e p50/p99 ms, the rung timeline, the
    transitions, ``score_plane_sheds``, the 429 counts and the tail's
    parity."""
    import collections
    import threading
    import time

    from .apiserver.server import APIServer
    from .client import Clientset
    from .client.remote import RemoteStore, RetryExhaustedError
    from .ops.backend import BatchBackend
    from .scheduler import GenericScheduler, Scheduler
    from .store import Store
    from .utils import timeseries as timeseries_mod
    from .utils.overload import AdmissionThrottle, DegradationLadder, overload_slos

    store = Store(event_log_window=400_000)
    server = APIServer(store)
    server.start()
    cs = Clientset(store)
    pods_per_node = 200
    cs.nodes.create_many([overload_node(i, pods_per_node) for i in range(n_nodes)])
    algo = GenericScheduler()
    backend = (backend_cls or BatchBackend)(algorithm=algo, device=device)
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=False)
    sched.start()

    t_create: dict[str, float] = {}
    t_bind: dict[str, float] = {}
    rejected: set[str] = set()
    drain_batches: list[list[str]] = []
    orig_drain = sched.queue.drain

    def recording_drain(max_n=None):
        out = orig_drain(max_n)
        if out:
            drain_batches.append([p.meta.name for p in out])
        return out

    sched.queue.drain = recording_drain
    orig_spb = sched.schedule_pending_batch

    def stamping_spb(max_batch=None):
        # probe only the pods this wave drained: a full LIST a wave would
        # hold the store lock against the HTTP handlers
        mark = len(drain_batches)
        r = orig_spb(max_batch)
        now = time.perf_counter()
        for batch in drain_batches[mark:]:
            for n in batch:
                if n not in t_bind:
                    try:
                        if cs.pods.get(n).spec.node_name:
                            t_bind[n] = now
                    except Exception:  # noqa: BLE001 - deleted meanwhile
                        pass
        return r

    sched.schedule_pending_batch = stamping_spb
    stop = threading.Event()
    serve = threading.Thread(target=lambda: sched.run_batch_loop(
        min_batch=32, max_wait=0.05, poll_interval=0.002, max_batch=384, stop=stop),
        daemon=True)
    serve.start()

    def tmpl(name: str, prio: int = 0):
        p = make_pod(name, cpu="10m", memory="16Mi")
        if prio:
            p.spec.priority = prio
        return p

    def wait_all_bound(names, timeout) -> bool:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if all(n in t_bind for n in names):
                return True
            time.sleep(0.02)
        return False

    ladder = ts_store = None
    clients: dict = {}
    tiers = {t: {"prio": p, "frac": f} for t, (p, f) in OVERLOAD_TIERS.items()}
    try:
        # -- calibrate: the drain rate (the first batch warms the path)
        cal_rate = None
        for attempt in range(2):
            names = [f"cal{attempt}-{i:05d}" for i in range(768)]
            t0 = time.perf_counter()
            for n in names:
                t_create[n] = t0
            cs.pods.create_many_nowait([tmpl(n) for n in names])
            if not wait_all_bound(names, 120):
                raise RuntimeError("overload calibration never drained")
            cal_rate = len(names) / (max(t_bind[n] for n in names) - t0)

        # -- the ladder and the throttle (absent while calibrating)
        pending_threshold = max(32.0, cal_rate * 0.5)
        ts_store = timeseries_mod.enable(sched.metrics.registry, interval_s=0.1,
                                         capacity=4_096)
        ladder = DegradationLadder(
            slos=overload_slos(pending_threshold=pending_threshold,
                               fast_window_s=fast_window_s, slow_window_s=slow_window_s,
                               recovery_evals=2),
            step_hold_s=step_hold_s, recover_hold_s=1.0)
        sched.attach_overload(ladder)
        ladder.attach(ts_store)
        server.admission_throttle = AdmissionThrottle(ladder, retry_after_s=0.75)

        # -- the surge, sized by duration: the gauge breaches only once
        # its windowed means sustain past the slow window
        arrival_rate = surge_mult * cal_rate
        slot_budget = n_nodes * pods_per_node - 2 * 768 - 600
        surge_s_target = min(max_surge_s, slot_budget / arrival_rate)
        surge_pods = min(surge_pods_cap, max(900, int(arrival_rate * surge_s_target)))
        per_tier_chunks = {}
        for tname, cfg in tiers.items():
            n = int(surge_pods * cfg["frac"])
            rs = RemoteStore(server.url, max_retries=2, retry_seed=seed + cfg["prio"])
            clients[tname] = rs
            pods = [tmpl(f"{tname}-{i:05d}", cfg["prio"]) for i in range(n)]
            cfg["names"] = [p.meta.name for p in pods]
            per_tier_chunks[tname] = (Clientset(rs), [pods[i:i + 25] for i in range(0, n, 25)])
        # largest-deficit interleave: one chunk schedule keeps the tier mix
        # constant over the whole surge
        schedule = []
        emitted = {t: 0 for t in tiers}
        for k in range(sum(len(c) for _, c in per_tier_chunks.values())):
            pick = max((t for t in tiers if emitted[t] < len(per_tier_chunks[t][1])),
                       key=lambda t: tiers[t]["frac"] * (k + 1) - emitted[t])
            rcs, chunks = per_tier_chunks[pick]
            schedule.append((rcs, chunks[emitted[pick]]))
            emitted[pick] += 1
        next_idx = [0]
        idx_lock = threading.Lock()
        surge_t0 = time.perf_counter()
        surge_stop = surge_t0 + max_surge_s

        def worker():
            while True:
                with idx_lock:
                    k = next_idx[0]
                    if k >= len(schedule):
                        return
                    next_idx[0] = k + 1
                rcs, chunk = schedule[k]
                target = surge_t0 + (k * 25) / arrival_rate
                now = time.perf_counter()
                if max(now, target) > surge_stop:
                    return
                if target > now:
                    time.sleep(target - now)
                stamp = time.perf_counter()
                for p in chunk:
                    t_create[p.meta.name] = stamp
                try:
                    rcs.pods.create_many(chunk)
                except RetryExhaustedError:
                    rejected.update(p.meta.name for p in chunk)  # shed load

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        surge_end = time.perf_counter()

        # -- recovery: back at rung 0 with an empty queue.  The windowed
        # means lag the queue, so a ladder that engages at all may do so
        # after the last arrival: wait out the windows before reading a
        # ladder that never left rung 0 as settled
        recovery_s = None
        settle = surge_end + 3 * slow_window_s + step_hold_s
        while time.perf_counter() < surge_end + 180:
            now = time.perf_counter()
            if (ladder.rung == 0 and len(sched.queue) == 0
                    and (ladder.max_rung_seen > 0 or now > settle)):
                recovery_s = now - surge_end
                break
            time.sleep(0.05)
        # the pods whose create was attempted are the arrivals
        for cfg in tiers.values():
            cfg["names"] = [n for n in cfg["names"] if n in t_create]
        accepted = [n for cfg in tiers.values() for n in cfg["names"] if n not in rejected]
        wait_all_bound(accepted, 60)

        # -- the tail at rung 0; the oracle replays it from the live state
        # and the live round-robin counter (integer scores tie often)
        tail_mark = len(drain_batches)
        rr_at_tail = algo._round_robin
        rung_at_tail = ladder.rung
        tail_names = [f"tail-{i:05d}" for i in range(300)]
        t0 = time.perf_counter()
        for n in tail_names:
            t_create[n] = t0
        cs.pods.create_many_nowait([tmpl(n) for n in tail_names])
        tail_bound = wait_all_bound(tail_names, 60)
        live_map = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}
    finally:
        stop.set()
        sched.queue.close()
        serve.join(timeout=30)
        timeseries_mod.disable()
        server.stop()

    cs_o = Clientset(Store())
    cs_o.nodes.create_many([overload_node(i, pods_per_node) for i in range(n_nodes)])
    tail_set = set(tail_names)
    cs_o.pods.create_many_nowait([make_pod(n, cpu="10m", memory="16Mi", node_name=node)
                                  for n, node in live_map.items()
                                  if node and n not in tail_set])
    algo_o = GenericScheduler()
    algo_o._round_robin = rr_at_tail
    sched_o = Scheduler(cs_o, algorithm=algo_o, emit_events=False)
    sched_o.start()
    for batch in drain_batches[tail_mark:]:
        cs_o.pods.create_many_nowait([tmpl(n) for n in batch if n in tail_set])
        sched_o.pump()
        sched_o.run_pending()
    oracle_tail = {p.meta.name: p.spec.node_name for p in cs_o.pods.list()[0]
                   if p.meta.name in tail_set}
    live_tail = {n: live_map.get(n) for n in tail_names}

    def tier_stats(cfg):
        names = cfg["names"]
        e2e = sorted(t_bind[n] - t_create[n] for n in names if n in t_bind)
        good = sum(1 for n in names
                   if n in t_bind and t_bind[n] - t_create[n] <= goodput_deadline_s)
        return {"arrivals": len(names), "rejected": sum(1 for n in names if n in rejected),
                "bound": len(e2e), "goodput": good / max(len(names), 1),
                "e2e_ms": {"p50": e2e[len(e2e) // 2] * 1e3 if e2e else None,
                           "p99": e2e[int(len(e2e) * 0.99)] * 1e3 if e2e else None}}

    throttle = server.admission_throttle.stats()
    return {
        "nodes": n_nodes, "drain_pods_per_s": cal_rate, "surge_mult": surge_mult,
        "arrival_pods_per_s": arrival_rate, "surge_pods": surge_pods,
        "surge_s": surge_end - surge_t0, "pending_threshold": pending_threshold,
        "goodput_deadline_s": goodput_deadline_s,
        "tiers": {t: tier_stats(cfg) for t, cfg in tiers.items()},
        "rung_timeline": [(t - surge_t0, r) for t, r in ladder.history()],
        "max_rung": ladder.max_rung_seen, "transitions": ladder.transitions,
        "engaged": ladder.max_rung_seen > 0,
        "recovered": ladder.max_rung_seen > 0 and recovery_s is not None,
        "recovery_s": recovery_s,
        "degradation_transitions_total": sched.metrics.degradation_transitions.value,
        "score_plane_sheds": sched.metrics.score_plane_sheds.value,
        "preemption_sheds": sched.metrics.preemption_sheds.value,
        "admission": {"admitted": throttle["admitted"], "throttled": throttle["throttled"],
                      "throttled_by_tier": {str(k): v for k, v in
                                            throttle["throttled_by_tier"].items()},
                      "server_429": server.admission_throttled.value,
                      "retry_after_honored": {t: clients[t].metrics.retry_after_honored.value
                                              for t in tiers}},
        "tail": {"pods": len(tail_names), "rung": rung_at_tail,
                 "bound": sum(1 for v in live_tail.values() if v),
                 "all_bound": tail_bound,
                 "exact_parity": live_tail == oracle_tail,
                 "mismatches": sum(1 for n in tail_names
                                   if live_tail.get(n) != oracle_tail.get(n)),
                 "occupancy_parity": (collections.Counter(live_tail.values())
                                      == collections.Counter(oracle_tail.values()))},
        "stats": dict(backend.stats),
    }
