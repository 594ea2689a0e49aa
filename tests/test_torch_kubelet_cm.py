"""Twins of ``tests/test_kubelet_cm.py`` on the port's ``kubelet.cm``,
``kubelet.pleg`` and ``HollowKubelet``: the cgroup ledger, node
admission, accounted eviction, PLEG relist events and image GC.

Each twin runs the JAX test's scenario through both packages (``both``)
on the same inputs and the same fake clock, asserts what the JAX test
asserts on each, and holds the outcomes equal: pod phases and reasons,
ledger sums, shares, admission rejections, node conditions and tick
counters.  Exact: no tolerance applies."""

from __future__ import annotations

import os
import signal
import time

import pytest

from tests.torch_kubelet_pkg import FakeClock, both


def _guaranteed(P, name, cpu="500m", mem="512Mi"):
    p = P.make_pod(name, cpu=cpu, memory=mem)
    for c in p.spec.containers:
        c.resources.limits = dict(c.resources.requests)
    return p


def _cs(P):
    return P.Clientset(P.Store())


# -- ContainerManager --------------------------------------------------------

def test_cgroup_tree_shape_and_shares():
    def scenario(P):
        cm = P.cm.ContainerManager(cpu="4", memory="8Gi", max_pods=10)
        out = {"root": cm.root.name, "children": sorted(cm.root.children)}
        assert out["children"] == ["besteffort", "burstable"]
        g = _guaranteed(P, "g1")
        cm.add_pod(g)
        assert g.meta.key in cm.root.children
        out["g"] = (cm.root.children[g.meta.key].memory_limit,
                    cm.root.children[g.meta.key].cpu_shares)
        assert out["g"] == (512 << 20, P.cm.milli_cpu_to_shares(500))
        b = P.make_pod("b1", cpu="250m", memory="128Mi")
        cm.add_pod(b)
        assert b.meta.key in cm.root.children["burstable"].children
        out["burstable"] = cm.root.children["burstable"].cpu_shares
        assert out["burstable"] == P.cm.milli_cpu_to_shares(250)
        e = P.make_pod("e1")
        cm.add_pod(e)
        assert e.meta.key in cm.root.children["besteffort"].children
        out["besteffort"] = cm.root.children["besteffort"].cpu_shares
        assert out["besteffort"] == 2
        cm.remove_pod(b.meta.key)
        out["after"] = (cm.root.children["burstable"].cpu_shares, cm.reserved_cpu)
        assert out["after"] == (2, 500)
        return out

    both(scenario)


def test_admission_rejects_over_allocatable():
    def scenario(P):
        cm = P.cm.ContainerManager(cpu="1", memory="1Gi", max_pods=2,
                                   system_reserved_cpu="200m",
                                   system_reserved_memory="256Mi")
        assert (cm.allocatable_cpu, cm.allocatable_memory) == (800, 768 << 20)
        cm.add_pod(P.make_pod("a", cpu="500m", memory="256Mi"))
        rejected = []
        for pod in (P.make_pod("b", cpu="400m", memory="64Mi"),
                    P.make_pod("c", cpu="100m", memory="600Mi")):
            with pytest.raises(P.cm.AdmissionRejected) as e:
                cm.admit(pod)
            rejected.append(e.value.resource)
        cm.add_pod(P.make_pod("d", cpu="100m", memory="64Mi"))
        with pytest.raises(P.cm.AdmissionRejected) as e:
            cm.admit(P.make_pod("e"))
        rejected.append(e.value.resource)
        assert rejected == ["cpu", "memory", "pods"]
        return rejected, cm.allocatable_cpu, cm.allocatable_memory

    both(scenario)


def test_usage_rolls_up_the_tree():
    def scenario(P):
        cm = P.cm.ContainerManager(cpu="4", memory="8Gi", max_pods=10)
        g, b = _guaranteed(P, "g1"), P.make_pod("b1", cpu="100m", memory="64Mi")
        cm.add_pod(g)
        cm.add_pod(b)
        cm.charge_usage({g.meta.key: 100 << 20, b.meta.key: 50 << 20})
        out = (cm.node_usage(), cm.qos_usage("Guaranteed"), cm.qos_usage("Burstable"))
        assert out == (150 << 20, 100 << 20, 50 << 20)
        return out

    both(scenario)


def test_kubelet_rejects_pod_over_allocatable():
    def scenario(P):
        cs = _cs(P)
        kubelet = P.HollowKubelet(cs, "n1", cpu="1", memory="1Gi", pod_start_latency=0.0)
        kubelet.register()
        cs.pods.create(P.make_pod("fits", cpu="600m", node_name="n1"))
        kubelet.tick()
        kubelet.tick()
        assert cs.pods.get("fits").status.phase == P.types.RUNNING
        cs.pods.create(P.make_pod("toobig", cpu="600m", node_name="n1"))
        r = kubelet.tick()
        got = cs.pods.get("toobig")
        assert (r["rejected"], got.status.phase, got.status.reason) == (1, "Failed", "OutOfcpu")
        return r, got.status.phase, got.status.reason

    both(scenario)


def test_eviction_from_accounted_pressure():
    def scenario(P):
        cs = _cs(P)
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", cpu="8", memory="1Gi", pod_start_latency=0.0,
                                  clock=clock, memory_pressure_fraction=0.5)
        kubelet.register()
        cs.pods.create(P.make_pod("hog", cpu="100m", memory="64Mi", node_name="n1"))
        cs.pods.create(_guaranteed(P, "calm", cpu="100m", mem="64Mi"))
        hog = cs.pods.get("hog")
        kubelet.tick()
        clock.advance(1)
        kubelet.tick()
        assert cs.pods.get("hog").status.phase == P.types.RUNNING
        assert hog.meta.key in kubelet.cm.known()
        kubelet.runtime.pod_memory_usage[hog.meta.key] = 600 << 20
        clock.advance(1)
        r = kubelet.tick()
        assert r["evicted"] == 1
        assert cs.pods.get("hog").status.reason == "Evicted"
        assert kubelet.cm.node_usage() < 512 << 20
        assert hog.meta.key not in kubelet.cm.known()
        node = cs.nodes.get("n1")
        return (r, kubelet.cm.node_usage(),
                node.status.condition(P.types.NODE_MEMORY_PRESSURE).status)

    both(scenario)


# -- PLEG --------------------------------------------------------------------

class _FakeSandboxes:
    """ProcessSandboxManager's contract: known() keeps a killed sandbox's
    entry until remove() reaps it."""

    def __init__(self):
        self.live: set[str] = set()
        self.entries: set[str] = set()
        self.created: list[str] = []

    def create(self, key):
        self.live.add(key)
        self.entries.add(key)
        self.created.append(key)

    def exists(self, key):
        return key in self.live

    def known(self):
        return set(self.entries)

    def remove(self, key):
        self.live.discard(key)
        self.entries.discard(key)

    def kill_out_of_band(self, key):
        self.live.discard(key)


def test_pleg_detects_out_of_band_sandbox_death():
    def scenario(P):
        cs = _cs(P)
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        sandboxes = _FakeSandboxes()
        kubelet.sandboxes = sandboxes
        kubelet.pleg.sandboxes = sandboxes
        kubelet.register()
        cs.pods.create(P.make_pod("p1", node_name="n1"))
        kubelet.tick()
        clock.advance(2)
        kubelet.tick()
        assert cs.pods.get("p1").status.phase == P.types.RUNNING
        assert sandboxes.exists("default/p1")
        clock.advance(2)
        kubelet.tick()
        sandboxes.kill_out_of_band("default/p1")
        clock.advance(2)
        r = kubelet.tick()
        assert r["sandbox_restarts"] == 1
        assert sandboxes.exists("default/p1")
        assert kubelet.pleg.stats["events"] >= 1
        return r, dict(kubelet.pleg.stats), sandboxes.created

    both(scenario)


def test_pleg_emits_container_restart_events():
    def scenario(P):
        cs = _cs(P)
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        kubelet.register()
        pod = P.make_pod("p1", node_name="n1")
        cs.pods.create(pod)
        ticks = []
        for _ in range(3):
            ticks.append(kubelet.tick())
            clock.advance(2)
        kubelet.runtime.inject_exit("default/p1", pod.spec.containers[0].name, 1)
        ticks.append(kubelet.tick())
        events = kubelet.pleg.relist(force=True)
        assert kubelet.pleg.stats["events"] >= 1
        st = cs.pods.get("p1").status
        return (ticks, [(e.type, e.pod_key) for e in events], dict(kubelet.pleg.stats),
                st.phase, [s.restart_count for s in st.container_statuses])

    both(scenario)


# -- ImageManager ------------------------------------------------------------

def test_image_pull_ref_and_gc():
    def scenario(P):
        clock = FakeClock()
        im = P.cm.ImageManager(disk_capacity=2 << 30, high_threshold=0.5,
                               low_threshold=0.3, clock=clock)
        p1 = P.make_pod("p1")
        p1.spec.containers[0].image = "nginx:1.13"
        assert im.ensure_pulled(p1) == ["nginx:1.13"]
        assert im.ensure_pulled(p1) == []
        for i in range(8):
            p = P.make_pod(f"filler-{i}")
            p.spec.containers[0].image = f"filler:{i}"
            im.ensure_pulled(p)
            im.release(p.meta.key)
            clock.advance(1.0)
        assert im.disk_used() > int(2 << 30) * 0.5
        res = im.garbage_collect()
        assert res["freed"] > 0 and not res["over"]
        assert "nginx:1.13" in im.images()
        assert im.stats["removed"] >= 1
        return res, sorted(im.images()), dict(im.stats), im.disk_used()

    both(scenario)


def test_image_gc_reports_over_when_everything_referenced():
    def scenario(P):
        im = P.cm.ImageManager(disk_capacity=1 << 30, high_threshold=0.5, low_threshold=0.3)
        for i in range(6):
            p = P.make_pod(f"p{i}")
            p.spec.containers[0].image = f"app:{i}"
            im.ensure_pulled(p)
        res = im.garbage_collect()
        assert res["over"] and res["freed"] == 0
        return res

    both(scenario)


def test_kubelet_image_gc_sets_disk_pressure():
    def scenario(P):
        cs = _cs(P)
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        kubelet.images = P.cm.ImageManager(disk_capacity=32 << 20, high_threshold=0.5,
                                           low_threshold=0.3, clock=clock)
        kubelet.register()
        p = P.make_pod("p1", node_name="n1")
        p.spec.containers[0].image = "huge:latest"
        cs.pods.create(p)
        kubelet.tick()
        clock.advance(1)
        kubelet.tick()
        assert cs.pods.get("p1").status.phase == P.types.RUNNING
        clock.advance(31)
        kubelet.tick()
        cond = cs.nodes.get("n1").status.condition(P.types.NODE_DISK_PRESSURE)
        assert cond is not None and cond.status == "True"
        return cond.status

    both(scenario)


@pytest.mark.timeout(60)
def test_pleg_real_pause_process_killed_out_of_band():
    def scenario(P):
        mgr = P.runtime.ProcessSandboxManager()
        assert mgr.enabled, "the pause binary did not build"
        cs = _cs(P)
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        kubelet.sandboxes = mgr
        kubelet.pleg.sandboxes = mgr
        kubelet.register()
        cs.pods.create(P.make_pod("p1", node_name="n1"))
        try:
            for _ in range(3):
                kubelet.tick()
                clock.advance(2)
            assert mgr.exists("default/p1")
            pid = mgr._procs["default/p1"].pid
            os.kill(pid, signal.SIGKILL)
            deadline = time.time() + 5
            while mgr.exists("default/p1") and time.time() < deadline:
                time.sleep(0.05)
            assert not mgr.exists("default/p1")
            clock.advance(2)
            r = kubelet.tick()
            assert r["sandbox_restarts"] == 1
            assert mgr.exists("default/p1")
            assert mgr._procs["default/p1"].pid != pid
            return r
        finally:
            mgr.remove_all()

    both(scenario)


def test_admission_reserves_within_one_tick():
    def scenario(P):
        cs = _cs(P)
        kubelet = P.HollowKubelet(cs, "n1", cpu="4", memory="8Gi", pod_start_latency=5.0)
        kubelet.register()
        for i in range(10):
            cs.pods.create(P.make_pod(f"big-{i}", cpu="1500m", node_name="n1"))
        r = kubelet.tick()
        assert (r["observed"], r["rejected"]) == (2, 8)
        assert kubelet.cm.reserved_cpu == 3000
        failed = sorted(p.meta.name for p in cs.pods.list()[0]
                        if p.status.phase == P.types.FAILED)
        assert len(failed) == 8
        assert all(cs.pods.get(n).status.reason == "OutOfcpu" for n in failed)
        kubelet.tick()
        assert kubelet.cm.reserved_cpu == 3000
        return r, failed

    both(scenario)


def test_node_reports_reserved_aware_allocatable():
    def scenario(P):
        cs = _cs(P)
        kubelet = P.HollowKubelet(cs, "n1", cpu="4", memory="8Gi",
                                  system_reserved_cpu="500m", kube_reserved_cpu="500m",
                                  system_reserved_memory="1Gi")
        kubelet.register()
        node = cs.nodes.get("n1")
        out = (node.status.capacity["cpu"].milli_value(),
               node.status.allocatable["cpu"].milli_value(),
               node.status.allocatable["memory"].value())
        assert out == (4000, 3000, 7 << 30)
        return out

    both(scenario)
