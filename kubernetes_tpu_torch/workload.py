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
              workload: str = "mixed", seed: int = 0, device=None) -> dict:
    """Steady-state arrival load through the port's ``Scheduler`` (the
    reference harness's churn preset, ``bench.py`` ``_run_churn_timed``):
    an arrival thread creates one wave of pods in one ``create_many`` txn
    the moment the previous wave left the queue, and the scheduler serves
    each wave with one ``run_batch_loop`` call on ``BatchBackend``, events
    on and the event sink running.

    ``device`` is the backend's: None means the card and raises without
    one; ``"cpu"`` runs the plain scan.  Returns bound/unbound counts from
    the final store state, wall seconds and pods/s, e2e p50/p99 in ms,
    per-wave phase seconds (pump, tensorize, dispatch, device_wait,
    commit, prep, and the informers' decode and apply seconds) with the
    wave's kernel ms, the backend's stats, the
    recorded drain batches, the final binding map and the round-robin
    counter (the inputs of ``oracle_replay_waves``)."""
    import threading
    import time

    from .ops.backend import BatchBackend
    from .scheduler import GenericScheduler, Scheduler

    algo = GenericScheduler()
    # the scheduler and the backend share one algorithm: the backend writes
    # the round-robin counter after every segment
    backend = BatchBackend(algorithm=algo, device=device)
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

    def informer_seconds():
        """Cumulative (decode, apply) seconds over the scheduler's informers:
        the part of pump_s spent applying watch events."""
        infs = sched.informers.informers()
        return (sum(i.stats["decode_s"] for i in infs),
                sum(i.stats["apply_s"] for i in infs))

    # wave-drain detection feeds the arrival thread: wave w+1 is created
    # the moment wave w left the queue, so creation overlaps scheduling
    drained = [0]
    drain_batches: list[list[str]] = []
    wave_drained = [threading.Event() for _ in range(waves)]
    orig_drain = sched.queue.drain

    def recording_drain(max_n=None):
        out = orig_drain(max_n)
        if out:
            drain_batches.append([p.meta.key for p in out])
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
            inf_before = informer_seconds()
            b = sched.run_batch_loop(min_batch=per_wave, max_wait=30.0,
                                     max_waves=1, poll_interval=0.002)
            bound += b
            ph = {k: sched.last_batch_phases.get(k, 0.0)
                  for k in ("tensorize_s", "dispatch_s", "device_wait_s",
                            "commit_s", "prep_s", "kernel_ms")}
            ph["pump_s"] = pump_acc[0] - pump_before
            inf_after = informer_seconds()
            ph["decode_s"] = inf_after[0] - inf_before[0]
            ph["apply_s"] = inf_after[1] - inf_before[1]
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
        "bound": bound,
        "unbound": sum(1 for node in assignments.values() if node is None),
        "drained": drained[0],
        "wall_s": elapsed,
        "pods_per_sec": bound / elapsed if elapsed > 0 else 0.0,
        "e2e_scheduling_ms": {"p50": _pq(m.e2e_scheduling_latency, 0.5),
                              "p99": _pq(m.e2e_scheduling_latency, 0.99)},
        "phase_timers": phase_timers,
        "backend": dict(backend.stats),
        "scheduled_events": sum(e.count for e in events if e.reason == "Scheduled"),
        "drain_batches": drain_batches,
        "assignments": assignments,
        "round_robin": algo._round_robin,
    }


def run_wire_churn(url: str, n_nodes: int = 5_000, total_pods: int = 20_000,
                   waves: int = 10, workload: str = "mixed", seed: int = 0,
                   wave_deadline_s: float = 60.0) -> dict:
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
    each wave's seconds and the final binding map."""
    import threading
    import time

    from .client import Clientset, Handler, InformerFactory, RemoteStore

    cs = Clientset(RemoteStore(url, timeout=120.0))
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
    try:
        t0 = time.perf_counter()
        for w in range(waves):
            batch = pods[w * per_wave:(w + 1) * per_wave]
            t_wave = time.perf_counter()
            with cv:
                for p in batch:
                    created_at[p.meta.key] = t_wave
                    pending.add(p.meta.key)
            cs.pods.create_many_nowait(batch)
            with cv:
                while pending:
                    left = t_wave + wave_deadline_s - time.perf_counter()
                    if left <= 0:
                        raise TimeoutError(
                            f"wave {w}: {len(pending)} pods neither bound nor marked "
                            f"FailedScheduling after {wave_deadline_s} s")
                    cv.wait(timeout=left)
            wave_s.append(time.perf_counter() - t_wave)
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
        "wave_s": wave_s, "assignments": assignments,
    }


def oracle_replay_waves(drain_batches: list, final_assignments: dict,
                        n_nodes: int, total_pods: int, workload: str,
                        seed: int) -> dict:
    """Per-wave oracle parity for a churn run: replay the recorded drain
    batches, in drain order, through the per-pod CPU oracle
    (``Scheduler(backend=None).run_pending``) on an identically seeded
    cluster, and compare each wave's bindings with the run's final map.
    Exact by prefix closure (pod i's placement depends only on the initial
    cluster and the pods placed before it) as long as no key was drained
    twice; a requeue re-decides under other queue state, so the replay
    then reports itself skipped."""
    from .scheduler import GenericScheduler, Scheduler

    flat = [k for b in drain_batches for k in b]
    if len(set(flat)) != len(flat):
        return {"mode": "skipped (requeues present)",
                "checked": 0, "mismatches": -1, "round_robin": None}
    cs, pods = _churn_cluster(n_nodes, total_pods, workload, seed)
    pods_by_key = {p.meta.key: p for p in pods}
    sched = Scheduler(cs, algorithm=GenericScheduler(), backend=None, emit_events=False)
    sched.start()
    checked = mismatches = 0
    sample = []
    for batch in drain_batches:
        for key in batch:
            cs.pods.create(pods_by_key[key])
        sched.pump()
        sched.run_pending()
        sched.pump()
        pods_now, _ = cs.pods.list()
        got = {p.meta.key: p.spec.node_name or None for p in pods_now}
        for key in batch:
            checked += 1
            if got.get(key) != final_assignments.get(key):
                mismatches += 1
                if len(sample) < 5:
                    sample.append((key, got.get(key), final_assignments.get(key)))
    return {"mode": "exact per-wave replay", "checked": checked,
            "mismatches": mismatches, "sample": sample,
            "round_robin": sched.algorithm._round_robin}
