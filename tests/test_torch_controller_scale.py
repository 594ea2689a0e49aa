"""The port's controllers at cluster scale, held to the JAX package.

Four controllers of the JAX package read the whole cluster on every
event of one object, which a 5000-node cluster (500 heartbeats a second)
turns into a LIST of the cluster every few milliseconds.  The port reads
its informers' caches instead, as the reference's listers do, and its
node-ipam reserves a range before writing it and remembers exhaustion.
Each scenario here runs through both packages and their stores must end
equal; the port must also make no wire read a sync (counted on its
store), and node-ipam must hand out distinct ranges under concurrent
workers."""

from __future__ import annotations

import importlib
import threading
import time

import pytest

from tests.torch_kubelet_pkg import pkg
from tests.torch_twin import ROOTS, dump


def _mod(P, name):
    return importlib.import_module(f"{ROOTS[P.name]}.{name}")


class Counting:
    """Counts a store's reads (get, list) while ``on``."""

    def __init__(self, store):
        self.store, self.on, self.reads = store, False, []
        for name in ("get", "list"):
            orig = getattr(store, name)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                if self.on:
                    self.reads.append((_name, a[0] if a else kw.get("kind")))
                return _orig(*a, **kw)

            setattr(store, name, wrapped)


def _heartbeat(cs, name, beat):
    def _mutate(n):
        n.meta.annotations["beat"] = str(beat)
        return n

    cs.nodes.guaranteed_update(name, _mutate, "")


def _both(scenario):
    jax_out, jax_store = scenario(pkg("jax"))
    port_out, port_store = scenario(pkg("port"))
    assert port_out == jax_out
    assert dump(port_store) == dump(jax_store)
    return port_out


def test_ttl_reads_the_cache_and_stamps_like_the_jax_controller():
    counts = {}

    def scenario(P):
        store = P.Store()
        cs = P.Clientset(store)
        ctrl = _mod(P, "controllers.ttl").TTLController(cs)
        for i in range(120):
            cs.nodes.create(P.make_node(f"n{i:03d}"))
        ctrl.reconcile_all()
        reads = Counting(store)
        for beat in range(3):
            for i in range(0, 120, 7):
                _heartbeat(cs, f"n{i:03d}", beat)
            reads.on = True
            ctrl.reconcile_all()
            reads.on = False
        counts[P.name] = [r for r in reads.reads if r[1] == "Node" and r[0] == "list"]
        ttl = {n.meta.name: n.meta.annotations.get("node.alpha.kubernetes.io/ttl")
               for n in cs.nodes.list()[0]}
        return ttl, store

    ttl = _both(scenario)
    assert set(ttl.values()) == {"15"}
    assert counts["port"] == [] and counts["jax"]  # the JAX controller LISTs a sync


def test_endpoints_read_pods_from_the_cache():
    counts = {}

    def scenario(P):
        api = P.api
        store = P.Store()
        cs = P.Clientset(store)
        ctrl = _mod(P, "controllers.endpoint").EndpointController(cs)
        cs.services.create(api.Service(meta=api.ObjectMeta(name="web", namespace="default"),
                                       selector={"app": "web"},
                                       ports=[api.ServicePort(port=80, target_port=8080)]))
        pods = []
        for i in range(12):
            p = P.make_pod(f"w{i:02d}", labels={"app": "web"}, node_name="n0")
            p.status.phase = "Running"
            p.status.pod_ip = f"10.8.0.{i + 2}"
            if i % 4 == 0:
                p.status.conditions = [{"type": "Ready", "status": "False"}]
            pods.append(cs.pods.create(p))
        ctrl.reconcile_all()
        reads = Counting(store)
        cs.pods.delete("w03", "default")

        def _unready(p):
            p.status.conditions = [{"type": "Ready", "status": "False"}]
            return p

        cs.pods.guaranteed_update("w05", _unready, "default")
        reads.on = True
        ctrl.reconcile_all()
        reads.on = False
        counts[P.name] = [r for r in reads.reads if r == ("list", "Pod")]
        eps = cs.endpoints.get("web", "default")
        return ([a.ip for s in eps.subsets for a in s.addresses],
                [a.ip for s in eps.subsets for a in s.not_ready_addresses]), store

    ready, not_ready = _both(scenario)
    assert "10.8.0.5" not in ready + not_ready and "10.8.0.7" in not_ready
    assert counts["port"] == [] and counts["jax"]


def test_attach_detach_reads_the_node_and_its_pods_from_the_caches():
    counts = {}

    def scenario(P):
        api = P.api
        store = P.Store()
        cs = P.Clientset(store)
        vol = _mod(P, "controllers.volume")
        ctrl = vol.AttachDetachController(cs)
        for i in range(4):
            cs.nodes.create(P.make_node(f"n{i}"))
        cs.persistentvolumes.create(api.PersistentVolume(
            meta=api.ObjectMeta(name="pv0", namespace=""),
            capacity={"storage": api.Quantity("1Gi")}, phase="Bound",
            claim_ref="default/c0"))
        cs.persistentvolumeclaims.create(api.PersistentVolumeClaim(
            meta=api.ObjectMeta(name="c0", namespace="default"),
            request_storage=api.Quantity("1Gi"), phase="Bound", volume_name="pv0"))
        p = P.make_pod("p0", node_name="n1")
        p.spec.volumes = [api.Volume(name="v", pvc_name="c0")]
        cs.pods.create(p)
        ctrl.reconcile_all()
        reads = Counting(store)
        for beat in range(3):
            for i in range(4):
                _heartbeat(cs, f"n{i}", beat)
            reads.on = True
            ctrl.reconcile_all()
            reads.on = False
        counts[P.name] = [r for r in reads.reads if r == ("get", "Node")]
        return {n.meta.name: n.status.volumes_attached for n in cs.nodes.list()[0]}, store

    attached = _both(scenario)
    assert attached == {"n0": [], "n1": ["pv0"], "n2": [], "n3": []}
    assert counts["port"] == [] and counts["jax"]


def test_node_ipam_remembers_exhaustion_until_a_range_returns():
    scans = {}

    def scenario(P):
        store = P.Store()
        cs = P.Clientset(store)
        ipam = _mod(P, "controllers.ipam")
        # a /22 of /24s: four ranges for six nodes
        ctrl = ipam.NodeIpamController(cs, cluster_cidr="10.8.0.0/22", node_cidr_mask=24)
        net = ctrl.network
        calls = [0]

        class Counted:
            def subnets(self, **kw):
                calls[0] += 1
                return net.subnets(**kw)

        ctrl.network = Counted()
        for i in range(6):
            cs.nodes.create(P.make_node(f"n{i}"))
        ctrl.reconcile_all()
        first = calls[0]
        for beat in range(5):
            for i in range(6):
                _heartbeat(cs, f"n{i}", beat)
            ctrl.reconcile_all()
        scans[P.name] = calls[0] - first
        cidr = {n.meta.name: n.spec.pod_cidr for n in cs.nodes.list()[0]}
        freed = next(name for name, c in cidr.items() if c)
        cs.nodes.delete(freed)
        ctrl.reconcile_all()
        for name in cidr:  # the waiting nodes' next heartbeats
            if name != freed:
                _heartbeat(cs, name, "after")
        ctrl.reconcile_all()
        after = {n.meta.name: n.spec.pod_cidr for n in cs.nodes.list()[0]}
        return (cidr, freed, after), store

    cidr, freed, after = _both(scenario)
    assert sorted(c for c in cidr.values() if c) == [f"10.8.{i}.0/24" for i in range(4)]
    assert sum(1 for c in after.values() if c) == 4 and cidr[freed] in after.values()
    assert scans["port"] == 0 and scans["jax"] >= 10  # two waiting nodes, five beats


@pytest.mark.timeout(60)
def test_node_ipam_workers_never_share_a_range():
    P = pkg("port")
    store = P.Store()
    cs = P.Clientset(store)
    ctrl = _mod(P, "controllers.ipam").NodeIpamController(cs)
    ctrl.informers.start_all()
    ctrl.run_workers(8)
    try:
        for i in range(96):
            cs.nodes.create(P.make_node(f"n{i:03d}"))

        def done():
            nodes = cs.nodes.list()[0]
            return all(n.spec.pod_cidr for n in nodes)

        deadline = time.monotonic() + 30
        while not done() and time.monotonic() < deadline:
            time.sleep(0.05)
        cidrs = [n.spec.pod_cidr for n in cs.nodes.list()[0]]
        assert all(cidrs) and len(set(cidrs)) == 96
    finally:
        ctrl.stop()
        ctrl.informers.stop_all()
        assert threading.active_count() < 50


@pytest.mark.timeout(60)
def test_replicaset_writes_in_parallel_with_the_jax_names():
    """A sync's creates go out in slow-start batches (1, 2, 4, ...) and
    its deletes together, where the JAX controller writes one at a time;
    the pods and their names are the JAX controller's."""
    def scenario(P):
        api = P.api
        store = P.Store()
        cs = P.Clientset(store)
        rs_mod = _mod(P, "controllers.replicaset")
        ctrl = rs_mod.ReplicaSetController(cs)
        rs_mod._suffix = __import__("itertools").count(1)
        in_flight, peak = [0], [0]
        lock = threading.Lock()
        create, delete = store.create, store.delete

        def slow(fn):
            def wrapped(*a, **kw):
                with lock:
                    in_flight[0] += 1
                    peak[0] = max(peak[0], in_flight[0])
                time.sleep(0.01)
                try:
                    return fn(*a, **kw)
                finally:
                    with lock:
                        in_flight[0] -= 1
            return wrapped

        store.create, store.delete = slow(create), slow(delete)
        cs.replicasets.create(api.ReplicaSet(
            meta=api.ObjectMeta(name="web", namespace="default"), replicas=40,
            selector=api.LabelSelector.from_match_labels({"app": "web"}),
            template=api.PodTemplateSpec(labels={"app": "web"},
                                         spec=api.PodSpec(containers=[api.Container(name="c")]))))
        ctrl.reconcile_all()
        up = sorted(p.meta.name for p in cs.pods.list()[0])

        def _scale(r):
            r.replicas = 8
            return r

        cs.replicasets.guaranteed_update("web", _scale, "default")
        ctrl.reconcile_all()
        down = sorted(p.meta.name for p in cs.pods.list()[0])
        ctrl.stop()
        return (up, down), store, peak[0]

    jax_out, jax_store, jax_peak = scenario(pkg("jax"))
    port_out, port_store, port_peak = scenario(pkg("port"))
    assert port_out == jax_out and dump(port_store) == dump(jax_store)
    assert port_out[0] == [f"web-{i:06d}" for i in range(1, 41)] and len(port_out[1]) == 8
    assert jax_peak == 1 and port_peak >= 4
