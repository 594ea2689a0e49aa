"""Twins of ``tests/test_proxy.py`` on the port's ``proxy/``: the proxier's
rule sync and routing, the userspace proxier's real TCP relays, the two
health servers and the hollow proxy over the control plane.

Each JAX test runs through both packages (``tests/torch_twin``): both pass
its assertions and leave equal stores.  Beside them, one seeded world of
Services and Endpoints goes through each package's ``Proxier`` and
``HollowProxyFleet``, with changes applied in steps: the rule tables, the
routes picked (round robin, ClientIP affinity with expiry, NodePort) and
the local endpoint counts must be equal after every step."""

from __future__ import annotations

import importlib
import random

import pytest

from tests.torch_twin import cases, twin

NAME = "test_proxy"
ROOTS = ("kubernetes_tpu", "kubernetes_tpu_torch")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)


def _mods(root: str):
    m = {k: importlib.import_module(f"{root}.{v}") for k, v in {
        "api": "api", "cluster": "api.cluster", "proxier": "proxy.proxier",
        "hollow": "proxy.hollow", "clientset": "client.clientset", "store": "store.store",
        "testutil": "testutil"}.items()}
    return m


def _world(m, rng: random.Random, n_svc: int = 12):
    """Seeded Services (ClusterIP, NodePort, LoadBalancer, headless, named
    multi-port, ClientIP affinity) and Endpoints (ready and not-ready
    addresses on four nodes)."""
    api, cl = m["api"], m["cluster"]
    services, endpoints = [], []
    for i in range(n_svc):
        kind = rng.choice(["ClusterIP", "NodePort", "LoadBalancer", "headless"])
        ports = [api.ServicePort(name="" if j == 0 and rng.random() < 0.5 else f"p{j}",
                                 port=80 + j, target_port=8080 + j,
                                 node_port=30000 + 10 * i + j if kind in ("NodePort",
                                                                          "LoadBalancer") else 0)
                 for j in range(rng.randint(1, 2))]
        services.append(api.Service(
            meta=api.ObjectMeta(name=f"s{i}", namespace="default"), selector={"app": f"s{i}"},
            ports=ports, cluster_ip="None" if kind == "headless" else f"10.0.1.{i + 1}",
            type="ClusterIP" if kind == "headless" else kind,
            session_affinity=rng.choice(["None", "ClientIP"])))
        subsets = []
        for sp in ports:
            ready = [cl.EndpointAddress(ip=f"10.8.{i}.{k}", node_name=f"n{rng.randrange(4)}")
                     for k in range(rng.randint(0, 4))]
            waiting = [cl.EndpointAddress(ip=f"10.9.{i}.{k}") for k in range(rng.randint(0, 2))]
            subsets.append(cl.EndpointSubset(addresses=ready, not_ready_addresses=waiting,
                                             ports=[cl.EndpointPort(name=sp.name,
                                                                    port=sp.target_port)]))
        endpoints.append(cl.Endpoints(meta=api.ObjectMeta(name=f"s{i}", namespace="default"),
                                      subsets=subsets))
    return services, endpoints


def _table(rules: dict) -> list:
    return sorted((k, r.kind, r.vip, r.port, r.protocol, str(r.service),
                   [(e.ip, e.port, e.is_local) for e in r.endpoints])
                  for k, r in rules.items())


def _proxier_scenario(root: str, seed: int) -> list:
    m = _mods(root)
    rng = random.Random(seed)
    clock = [0.0]
    p = m["proxier"].Proxier(node_name="n1", clock=lambda: clock[0])
    services, endpoints = _world(m, rng)
    for s in services:
        p.on_service_update(s)
    for e in endpoints:
        p.on_endpoints_update(e)
    out = []
    for step in range(6):
        out.append(_table(p.sync()))
        picks = []
        for s in services:
            if s.cluster_ip == "None":
                continue
            for sp in s.ports:
                for c in range(4):
                    ep = p.route(s.cluster_ip, sp.port, client_ip=f"1.1.1.{c % 2}")
                    picks.append(None if ep is None else (ep.ip, ep.port))
                if sp.node_port:
                    ep = p.route_node_port(sp.node_port, client_ip="2.2.2.2")
                    picks.append(None if ep is None else (ep.ip, ep.port))
        out.append(picks)
        out.append([p.local_endpoint_count("default", s.meta.name) for s in services])
        # a step of changes: an Endpoints replaced, a Service deleted, time
        # past the affinity timeout now and then
        i = rng.randrange(len(services))
        e2 = _world(m, random.Random(seed * 100 + step))[1][i]
        e2.meta.name = endpoints[i].meta.name
        p.on_endpoints_update(e2)
        if rng.random() < 0.3:
            gone = services.pop(rng.randrange(len(services)))
            p.on_service_update(None, key=gone.meta.key)
        clock[0] += rng.choice([5.0, 11000.0])
    out.append(p.syncs)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proxier_rules_and_routes_equal_the_jax_package(seed):
    jax_out, port_out = (_proxier_scenario(r, seed) for r in ROOTS)
    assert port_out == jax_out
    assert any(port_out[0])  # the world holds rules


def _fleet_scenario(root: str, seed: int) -> list:
    """A ``HollowProxyFleet`` of five nodes over a store that the Services
    and Endpoints reach through the informers; changes in steps."""
    m = _mods(root)
    rng = random.Random(seed)
    cs = m["clientset"].Clientset(m["store"].Store())
    services, endpoints = _world(m, rng, n_svc=6)
    for s in services:
        cs.services.create(s)
    fleet = m["hollow"].HollowProxyFleet(cs, [f"n{i}" for i in range(5)])
    for e in endpoints:
        cs.endpoints.create(e)
    fleet.start()
    out = []
    for step in range(4):
        fleet.tick_all()
        out.append([_table(hp.proxier.rules) for hp in fleet.proxies])
        out.append([hp.proxier.syncs for hp in fleet.proxies])
        e2 = _world(m, random.Random(seed * 100 + step), n_svc=6)[1][rng.randrange(6)]
        cs.endpoints.update(e2) if rng.random() < 0.7 else cs.endpoints.delete(
            e2.meta.name, "default")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_hollow_proxy_fleet_equals_the_jax_package(seed):
    jax_out, port_out = (_fleet_scenario(r, seed) for r in ROOTS)
    assert port_out == jax_out


def test_fleet_metrics_read_the_rule_tables():
    """``FleetMetrics`` sums what the proxiers hold and counts the ones
    whose rule set is not the first one's; its digest is the one computed
    from the rule rows."""
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.proxy.hollow import FleetMetrics, HollowProxyFleet, digest, rule_rows
    from kubernetes_tpu_torch.store.store import Store

    m = _mods("kubernetes_tpu_torch")
    cs = Clientset(Store())
    services, endpoints = _world(m, random.Random(3), n_svc=6)
    for s in services:
        cs.services.create(s)
    for e in endpoints:
        cs.endpoints.create(e)
    fleet = HollowProxyFleet(cs, ["n0", "n1", "n2"])
    fleet.start()
    fm = FleetMetrics(fleet)
    v = fm.values()
    rules = fleet.proxies[0].proxier.rules
    assert v["proxiers"] == 3 and v["rules"] == 3 * len(rules) and v["syncs_total"] == 3
    assert v["rule_endpoints"] == 3 * sum(len(r.endpoints) for r in rules.values())
    assert v["rule_sets_differing"] == 0
    assert v["rule_set_digest"] == digest(rule_rows(rules))
    # one proxier behind the others: it differs until it syncs
    cs.endpoints.delete(endpoints[0].meta.name, "default")
    fleet.informers.pump_all()
    for hp in fleet.proxies[1:]:
        hp.proxier.sync()
    assert fm.values()["rule_sets_differing"] == 2
    fleet.proxies[0].proxier.sync()
    assert fm.values()["rule_sets_differing"] == 0
    text = fm.expose()
    assert "hollow_proxy_rules " in text and "hollow_proxy_syncs_total 6.0" in text


def test_fleet_endpoints_cache_drops_deleted_endpoints():
    """A deleted Endpoints object leaves the fleet's shared cache once the
    proxiers fold the deletion; the others stay, and a re-created one is
    read again."""
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.proxy.hollow import HollowProxyFleet
    from kubernetes_tpu_torch.store.store import Store

    m = _mods("kubernetes_tpu_torch")
    cs = Clientset(Store())
    services, endpoints = _world(m, random.Random(4), n_svc=6)
    for s in services:
        cs.services.create(s)
    for e in endpoints:
        cs.endpoints.create(e)
    fleet = HollowProxyFleet(cs, ["n0", "n1", "n2"])
    fleet.start()
    cache = fleet.proxies[0].proxier._eps_cache
    assert all(hp.proxier._eps_cache is cache for hp in fleet.proxies)
    assert len(cache) == len(endpoints)
    before = [_table(hp.proxier.rules) for hp in fleet.proxies]
    for e in endpoints[:4]:
        cs.endpoints.delete(e.meta.name, "default")
    fleet.tick_all()
    assert len(cache) == len(endpoints) - 4
    cs.endpoints.create(endpoints[0])
    fleet.tick_all()
    assert len(cache) == len(endpoints) - 3
    assert all(_table(hp.proxier.rules) != b for hp, b in zip(fleet.proxies, before))
