"""The hollow fleet's parity: the port's ``HollowFleet`` and
``HollowWatcherFleet`` against the JAX package's, and the
``DynamicKubeletConfig`` gate.

- A seeded ``mixed`` cluster of 50 nodes registers itself through each
  package's fleet (``workload.hollow_fleet`` in the port, its counterpart
  built the same way in the JAX package), the 10% tainted nodes get their
  taints after registering, and 400 ``mixed`` pods bind: through the JAX
  package's sequential scheduler, and through the port's batch scheduler
  on ``device="cpu"``.  Then 5 ``tick_all`` rounds run on one fake clock.
  Bindings, per-pod phase, pod IP and host IP, and per-node conditions
  must be equal.
- A ``HollowWatcherFleet`` on each package's store converges on the same
  caches with no dropped client.
- With the gate on, both packages' kubelets apply the same ConfigMap
  override and roll it back alike.

Exact: no tolerance applies."""

from __future__ import annotations

import importlib
import random

import pytest

from tests.torch_kubelet_pkg import FakeClock, both, pkg

N_NODES, N_PODS, SEED = 50, 400, 11


def _seeded():
    """The port's seeded nodes, services and pods, as wire dicts."""
    from kubernetes_tpu_torch import workload

    rng = random.Random(SEED)
    nodes = workload.make_nodes(N_NODES, rng, "mixed")
    services = workload.make_services()
    pods = workload.make_pods(N_PODS, rng, "mixed")
    return ([n.to_dict() for n in nodes], [s.to_dict() for s in services],
            [p.to_dict() for p in pods])


def _fleet(P, cs, nodes, clock):
    if P.name == "port":
        from kubernetes_tpu_torch.workload import hollow_fleet

        return hollow_fleet(cs, nodes, clock=clock)
    fleet = P.HollowFleet(cs, 0)
    fleet.kubelets = [
        P.HollowKubelet(cs, n.meta.name, pod_index=fleet.index, clock=clock,
                        cpu=str(n.status.capacity["cpu"]),
                        memory=str(n.status.capacity["memory"]),
                        pods=n.status.capacity["pods"].value(), labels=dict(n.meta.labels))
        for n in nodes]
    return fleet


def _scheduler(P, cs):
    sched_mod = importlib.import_module(f"{P.root}.scheduler")
    if P.name == "jax":
        return sched_mod.Scheduler(cs, emit_events=False)
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    algo = sched_mod.GenericScheduler()
    return sched_mod.Scheduler(cs, algorithm=algo, emit_events=False,
                               backend=BatchBackend(algorithm=algo, device="cpu"))


@pytest.mark.timeout(300)
def test_fleet_runs_the_bound_pods_alike():
    node_docs, service_docs, pod_docs = _seeded()

    def scenario(P):
        api = P.types
        cs = P.Clientset(P.Store())
        clock = FakeClock(100.0)
        nodes = [api.Node.from_dict(d) for d in node_docs]
        fleet = _fleet(P, cs, nodes, clock)
        fleet.register_all()
        for n in nodes:
            if n.spec.taints:
                def taint(cur, taints=n.spec.taints):
                    cur.spec.taints = list(taints)
                    return cur

                cs.nodes.guaranteed_update(n.meta.name, taint, "")
        for d in service_docs:
            cs.services.create(api.Service.from_dict(d))
        sched = _scheduler(P, cs)
        sched.start()
        cs.pods.create_many([api.Pod.from_dict(d) for d in pod_docs])
        sched.pump()
        if P.name == "jax":
            bound = sched.run_pending()
        else:
            bound = sched.schedule_pending_batch()[0]
        sched.pump()
        assert bound == N_PODS
        ticks = []
        for _ in range(5):
            ticks.append(fleet.tick_all())
            clock.advance(1.0)
        fleet.informer.stop()
        pods = {p.meta.key: (p.spec.node_name, p.status.phase, p.status.pod_ip,
                             p.status.host_ip, p.status.reason)
                for p in cs.pods.list()[0]}
        assert all(v[1] == "Running" for v in pods.values())
        assert len({(v[0], v[2]) for v in pods.values()}) == len(pods)  # unique per node
        conds = {n.meta.name: sorted((c.type, c.status) for c in n.status.conditions)
                 for n in cs.nodes.list()[0]}
        taints = {n.meta.name: [t.to_dict() for t in n.spec.taints]
                  for n in cs.nodes.list()[0]}
        return pods, conds, taints, ticks, sched.algorithm._round_robin

    pods, conds, taints, ticks, _ = both(scenario)
    assert sum(t["started"] for t in ticks) == N_PODS
    assert sum(1 for t in taints.values() if t) >= 1


def test_port_fleet_takes_each_nodes_resources_and_labels():
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.store import Store

    nodes = workload.make_nodes(20, random.Random(3), "mixed")
    cs = Clientset(Store())
    fleet = workload.hollow_fleet(cs, nodes)
    fleet.register_all()
    fleet.informer.stop()
    got = {n.meta.name: n for n in cs.nodes.list()[0]}
    for want in nodes:
        n = got[want.meta.name]
        assert n.meta.labels == want.meta.labels
        for r in ("cpu", "memory", "pods"):
            assert n.status.allocatable[r].milli_value() == want.status.allocatable[r].milli_value()
        assert not n.spec.taints


@pytest.mark.timeout(120)
def test_watcher_fleet_converges_with_no_dropped_clients():
    def scenario(P):
        store = P.Store()
        cs = P.Clientset(store)
        fanout = importlib.import_module(f"{P.root}.utils.fanout")
        tracker = fanout.WatchFanoutTracker()
        fleet = P.hollow.HollowWatcherFleet(store, 40, kind="Pod", frames=True,
                                            tracker=tracker)
        rng = random.Random(5)
        for w in range(5):
            cs.pods.create_many([P.make_pod(f"w{w}-{i}") for i in range(30)])
            for name in rng.sample([f"w{w}-{i}" for i in range(30)], 5):
                cs.pods.delete(name)
            fleet.pump_all()
        head = store.revision if hasattr(store, "revision") else cs.pods.list()[1]
        fleet.pump_all()
        want = {p.meta.key for p in cs.pods.list()[0]}
        caches = [w.cache for w in fleet.watchers]
        dropped = sum(1 for w in fleet.watchers if w.gaps or set(w.cache) != want)
        out = (fleet.converged(head), dropped, len(want), caches[0] == caches[-1],
               sorted(caches[0].items()))
        fleet.stop_all()
        assert out[0] == 40 and dropped == 0
        return out

    both(scenario)


def test_dynamic_kubelet_config_applies_a_configmap_alike():
    """``DynamicKubeletConfig`` on: a ConfigMap ``kubelet-config-<node>`` in
    kube-system overrides the kubelet's tunables at heartbeat cadence, an
    invalid value falls back to the boot value, and deleting the ConfigMap
    rolls every tunable back.  Off (the default), the ConfigMap is
    ignored."""

    def scenario(P):
        api = P.api
        cs = P.Clientset(P.Store())
        clock = FakeClock()
        k = P.HollowKubelet(cs, "n1", clock=clock, pod_start_latency=0.5)
        k.register()
        cms = cs.client_for("ConfigMap")
        cms.create(api.ConfigMap(meta=api.ObjectMeta(name="kubelet-config-n1",
                                                     namespace="kube-system"),
                                 data={"podStartLatency": "2.5", "heartbeatInterval": "30"}))
        seen = []

        def look():
            seen.append((k.pod_start_latency, k.heartbeat_interval, k.memory_pressure_fraction))

        k.tick()
        look()  # gate off: nothing applied
        gates = P.features.DEFAULT_FEATURE_GATES
        gates.set_from_map({"DynamicKubeletConfig": True})
        try:
            k.tick()
            look()

            def bad(cur):
                cur.data = {"podStartLatency": "fast", "memoryPressureFraction": "0.8"}
                return cur

            cms.guaranteed_update("kubelet-config-n1", bad, "kube-system")
            clock.advance(5.0)
            k.tick()
            look()  # within the boot heartbeat interval: not polled yet
            clock.advance(5.0)
            k.tick()
            look()
            cms.delete("kubelet-config-n1", "kube-system")
            clock.advance(10.0)
            k.tick()
            look()
        finally:
            gates.set_from_map({"DynamicKubeletConfig": False})
        assert seen[0] == (0.5, 10.0, 0.95) and seen[1] == (2.5, 30.0, 0.95)
        assert seen[3] == (0.5, 10.0, 0.8) and seen[4] == (0.5, 10.0, 0.95)
        return seen

    both(scenario)


def test_heartbeat_is_one_write_until_another_writer_changes_the_node():
    """The port's kubelet heartbeats with one CAS write on the Node its
    last heartbeat wrote; after another writer changed the node (a
    conflict) it reads the node once and writes it, as the JAX kubelet
    does on every heartbeat.  The node ends as the JAX kubelet leaves it."""
    from tests.torch_kubelet_pkg import FakeClock, both, pkg

    def scenario(P):
        store = P.Store()
        cs = P.Clientset(store)
        clock = FakeClock()
        k = P.HollowKubelet(cs, "n1", clock=clock)
        k.register()
        reads = []
        get = store.get

        def counted(*a, **kw):
            reads.append(a[:1])
            return get(*a, **kw)

        store.get = counted
        for _ in range(3):
            clock.advance(10.0)
            k.tick()
        steady = len(reads)

        def _label(n):
            n.meta.labels["other"] = "writer"
            return n

        cs.nodes.guaranteed_update("n1", _label, "")
        reads.clear()
        clock.advance(10.0)
        k.tick()
        after_conflict = len(reads)
        node = cs.nodes.get("n1")
        ready = node.status.condition("Ready")
        return (steady, after_conflict), (node.meta.labels.get("other"), ready.status,
                                          ready.heartbeat_time)

    assert both(lambda P: scenario(P)[1]) == ("writer", "True", 40.0)
    # three heartbeats read the node three times in the JAX kubelet, once
    # (the first: nothing written yet) in the port's; after the conflict
    # both read it once
    assert scenario(pkg("jax"))[0] == (3, 1)
    assert scenario(pkg("port"))[0] == (1, 1)


def test_heartbeat_overdue_heartbeats_only_the_late_kubelets():
    """``HollowFleet.heartbeat_overdue()`` heartbeats the kubelets whose
    last heartbeat is twice their interval old, and only them."""
    from tests.torch_kubelet_pkg import FakeClock, pkg

    P = pkg("port")
    cs = P.Clientset(P.Store())
    clock = FakeClock()
    fleet = P.HollowFleet(cs, 4, clock=clock)
    fleet.register_all()
    clock.advance(12.0)
    fleet.kubelets[0].tick()  # heartbeats at 12 s; the rest last beat at 0 s
    clock.advance(10.0)
    assert fleet.heartbeat_overdue() == 3
    assert fleet.heartbeat_overdue() == 0
    beats = {n.meta.name: n.status.condition("Ready").heartbeat_time for n in cs.nodes.list()[0]}
    assert beats == {"hollow-00000": 12.0, "hollow-00001": 22.0, "hollow-00002": 22.0,
                     "hollow-00003": 22.0}


def test_tick_all_heartbeats_overdue_kubelets_between_kubelets_and_stops():
    """A tick of 120 kubelets that takes 1 s a kubelet: after every 50
    kubelets, those whose heartbeat is 20 s old (twice the 10 s interval)
    heartbeat before their turn, so none waits the whole 120 s tick.  A
    ``stop`` that turns true ends the tick between two kubelets."""
    from tests.torch_kubelet_pkg import FakeClock, pkg

    P = pkg("port")
    cs = P.Clientset(P.Store())
    clock = FakeClock()
    fleet = P.HollowFleet(cs, 120, clock=clock)
    fleet.register_all()
    for k in fleet.kubelets:
        k.tick()  # every kubelet heartbeats at 0 s
    beats: dict = {}
    for k in fleet.kubelets:
        def slow_tick(k=k, tick=k.tick):
            clock.advance(1.0)
            return tick()

        def heartbeat(force=False, k=k, hb=k._heartbeat):
            before = k._last_heartbeat
            hb(force)
            if k._last_heartbeat != before:
                beats.setdefault(k.node_name, []).append(clock())

        k.tick, k._heartbeat = slow_tick, heartbeat
    counters: dict = {}
    total = fleet.tick_all(counters=counters)
    assert total == {"started": 0, "observed": 0, "restarts": 0, "evicted": 0}
    assert set(total) <= set(counters)
    # kubelet i ticks at i + 1 s and heartbeats there once 10 s have gone
    # by; the passes run at 50 s and 100 s, for those last seen 20 s before
    assert beats["hollow-00000"] == [50.0, 100.0]
    assert beats["hollow-00009"] == [10.0, 50.0, 100.0]
    assert beats["hollow-00030"] == [31.0, 100.0]
    assert beats["hollow-00080"] == [50.0, 81.0]
    assert beats["hollow-00119"] == [50.0, 100.0, 120.0]
    # no heartbeat is older than 20 s plus 50 kubelets' ticks
    assert max(b - a for bs in beats.values() for a, b in zip([0.0] + bs, bs)) <= 70.0
    seen = []
    for k in fleet.kubelets:
        k.tick = lambda k=k: seen.append(k.node_name) or {}
    fleet.tick_all(stop=lambda: len(seen) >= 3)
    assert seen == ["hollow-00000", "hollow-00001", "hollow-00002"]
