"""Twins of ``tests/test_network.py`` on the port's ``kubelet.network``
(``KubenetPlugin``, the kubenet-shaped IPAM) and its use by
``HollowKubelet``: leases, release and reuse, exhaustion, the node's
allocated podCIDR, host-network pods, restart recovery, and the zlib hash
fallback base when the node has no podCIDR.

Each twin runs the JAX test's scenario through both packages (``both``)
on the same fake clock and holds the outcomes equal: the pod IPs, byte
for byte, lease maps and plugin counters.  Exact."""

from __future__ import annotations

import random

import pytest

from tests.torch_kubelet_pkg import FakeClock, both, pkg


def _cidr(cidr):
    def mutate(n):
        n.spec.pod_cidr = cidr
        return n

    return mutate


def test_lease_release_reuse():
    def scenario(P):
        net = P.network.KubenetPlugin("n1", "10.244.3.0/24")
        a, b = net.setup_pod("default/a"), net.setup_pod("default/b")
        assert (a, b) == ("10.244.3.2", "10.244.3.3")
        assert net.setup_pod("default/a") == a
        net.teardown_pod("default/a")
        c = net.setup_pod("default/c")
        assert c == "10.244.3.2" and net.pod_ip("default/a") is None
        return a, b, c, sorted(net.leased())

    both(scenario)


def test_exhaustion_is_a_hard_error():
    def scenario(P):
        net = P.network.KubenetPlugin("n1", "10.244.3.0/24")
        ips = [net.setup_pod(f"default/p{i}") for i in range(253)]
        with pytest.raises(P.network.NetworkSetupError):
            net.setup_pod("default/one-too-many")
        assert net.stats["exhausted"] == 1
        return ips, dict(net.stats)

    both(scenario)


def test_kubelet_uses_allocated_pod_cidr_and_recycles():
    def scenario(P):
        cs = P.Clientset(P.Store())
        clock = FakeClock()
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        kubelet.register()
        cs.nodes.guaranteed_update("n1", _cidr("10.200.7.0/24"), "")
        cs.pods.create(P.make_pod("p1", node_name="n1"))
        kubelet.tick()
        clock.advance(1)
        kubelet.tick()
        pod = cs.pods.get("p1")
        assert pod.status.phase == P.types.RUNNING
        assert pod.status.pod_ip.startswith("10.200.7.")
        leased_ip = pod.status.pod_ip
        cs.pods.delete("p1")
        clock.advance(1)
        kubelet.tick()
        assert kubelet.network.pod_ip("default/p1") is None
        cs.pods.create(P.make_pod("p2", node_name="n1"))
        clock.advance(1)
        kubelet.tick()
        clock.advance(1)
        kubelet.tick()
        assert cs.pods.get("p2").status.pod_ip == leased_ip
        return leased_ip, cs.pods.get("p2").status.host_ip

    both(scenario)


def test_host_network_pod_bypasses_plugin():
    def scenario(P):
        cs = P.Clientset(P.Store())
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0)
        kubelet.register()
        p = P.make_pod("hostnet", node_name="n1")
        p.spec.host_network = True
        cs.pods.create(p)
        kubelet.tick()
        kubelet.tick()
        pod = cs.pods.get("hostnet")
        out = (pod.status.phase, pod.status.pod_ip, kubelet.network is None)
        assert out == ("Running", "n1", True)
        return out

    both(scenario)


def test_restart_recovery_adopts_existing_leases():
    def scenario(P):
        cs = P.Clientset(P.Store())
        clock = FakeClock()
        k1 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        k1.register()
        cs.nodes.guaranteed_update("n1", _cidr("10.200.9.0/24"), "")
        cs.pods.create(P.make_pod("p1", node_name="n1"))
        k1.tick()
        clock.advance(1)
        k1.tick()
        ip1 = cs.pods.get("p1").status.pod_ip
        assert ip1 == "10.200.9.2"
        k2 = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock)
        clock.advance(1)
        k2.tick()
        cs.pods.create(P.make_pod("p2", node_name="n1"))
        clock.advance(1)
        k2.tick()
        clock.advance(1)
        k2.tick()
        ip2 = cs.pods.get("p2").status.pod_ip
        assert ip2 and ip2 != ip1
        return ip1, ip2

    both(scenario)


def test_cidr_arriving_after_first_probe_still_wins():
    def scenario(P):
        cs = P.Clientset(P.Store())
        kubelet = P.HollowKubelet(cs, "n1", pod_start_latency=0.0)
        kubelet.register()
        assert not kubelet._network().has_cidr
        cs.nodes.guaranteed_update("n1", _cidr("10.201.1.0/24"), "")
        cs.pods.create(P.make_pod("p1", node_name="n1"))
        kubelet.tick()
        kubelet.tick()
        ip = cs.pods.get("p1").status.pod_ip
        assert ip.startswith("10.201.1.")
        return ip

    both(scenario)


def test_adopt_rejects_bridge_and_out_of_range_octets():
    def scenario(P):
        p = P.network.KubenetPlugin("n1", "10.200.9.0/24")
        got = [p.adopt("default/p1", ip)
               for ip in ("10.200.9.1", "10.200.9.0", "10.200.9.255", "10.200.9.2")]
        assert got == [False, False, False, True]
        assert p.pod_ip("default/p1") == "10.200.9.2"
        return got

    both(scenario)


def test_hash_fallback_base_gives_the_jax_addresses():
    """With no podCIDR on the node the plugin leases from a base hashed
    from the node name (zlib): the port's addresses must equal the JAX
    plugin's, byte for byte, for seeded node names."""
    rng = random.Random(13)
    names = [f"hollow-{rng.randrange(100000):05d}" for _ in range(200)] + ["n1", "", "a" * 63]
    J, T = pkg("jax"), pkg("port")
    for name in names:
        j, t = J.network.KubenetPlugin(name, ""), T.network.KubenetPlugin(name, "")
        assert not t.has_cidr
        jips = [j.setup_pod(f"default/p{i}") for i in range(5)]
        tips = [t.setup_pod(f"default/p{i}") for i in range(5)]
        assert tips == jips
