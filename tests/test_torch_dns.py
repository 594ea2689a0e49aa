"""Twins of ``tests/test_dns.py`` on the port's ``dns/``: the record schema
(A for a ClusterIP, per-pod A and SRV for a headless Service, the pod
echo records), the UDP wire protocol and the name → VIP → backend path.

Each JAX test runs through both packages (``tests/torch_twin``).  Beside
them, one seeded cluster of Services and Endpoints is served by each
package's ``DNSServer`` over UDP: the answer datagrams to the same query
datagrams (A, SRV, ANY, misses, a compressed name) must be equal byte for
byte, before and after a round of changes, and a malformed datagram must
leave both serving with equal counters."""

from __future__ import annotations

import importlib
import random
import socket

import pytest

from tests.torch_twin import cases, twin

NAME = "test_dns"
ROOTS = ("kubernetes_tpu", "kubernetes_tpu_torch")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path)


def _cluster(root: str, cs, rng: random.Random, n_svc: int = 8) -> list:
    api = importlib.import_module(f"{root}.api")
    cl = importlib.import_module(f"{root}.api.cluster")
    names = []
    for i in range(n_svc):
        headless = rng.random() < 0.4
        ports = [api.ServicePort(name=rng.choice(["http", "grpc", ""]), port=80 + i,
                                 target_port=8080, protocol=rng.choice(["TCP", "UDP"]))]
        ns = rng.choice(["default", "team-a"])
        cs.services.create(api.Service(
            meta=api.ObjectMeta(name=f"svc-{i}", namespace=ns),
            selector={"app": f"a{i}"}, ports=ports,
            cluster_ip="None" if headless else f"10.0.3.{i + 1}"))
        names.append(f"{ns}/svc-{i}")
    for key in names:
        ns, name = key.split("/")
        addrs = [cl.EndpointAddress(ip=f"10.8.{rng.randrange(8)}.{k + 2}",
                                    target_pod=f"{ns}/{name}-{k}" if rng.random() < 0.8 else "")
                 for k in range(rng.randint(0, 3))]
        cs.endpoints.create(cl.Endpoints(
            meta=api.ObjectMeta(name=name, namespace=ns),
            subsets=[cl.EndpointSubset(addresses=addrs,
                                       ports=[cl.EndpointPort(name="http", port=8080)])]))
    return names


def _queries(root: str, names: list) -> list:
    server = importlib.import_module(f"{root}.dns.server")
    out = []
    for i, key in enumerate(names):
        ns, name = key.split("/")
        base = f"{name}.{ns}.svc.cluster.local"
        for qname, qt in ((base, server.QTYPE_A), (base, server.QTYPE_ANY),
                          (f"{name}-0.{base}", server.QTYPE_A),
                          (f"_http._tcp.{base}", server.QTYPE_SRV),
                          (f"_grpc._udp.{base}", server.QTYPE_SRV),
                          (f"ghost-{i}.{ns}.svc.cluster.local", server.QTYPE_A)):
            out.append(server.build_query(qname, qt, txid=0x4000 + len(out)))
    out.append(server.build_query("10-8-1-2.default.pod.cluster.local", server.QTYPE_A))
    return out


def _serve(root: str, seed: int) -> dict:
    cs_mod = importlib.import_module(f"{root}.client.clientset")
    store = importlib.import_module(f"{root}.store.store")
    dns = importlib.import_module(f"{root}.dns")
    rng = random.Random(seed)
    cs = cs_mod.Clientset(store.Store())
    names = _cluster(root, cs, rng)
    records = dns.DNSRecordStore(cs)
    records.start()
    srv = dns.DNSServer(records)
    srv.start()
    out = {"answers": []}
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(5)

            def ask(datagrams):
                got = []
                for q in datagrams:
                    s.sendto(q, srv.address)
                    got.append(s.recvfrom(4096)[0])
                return got

            out["answers"].append(ask(_queries(root, names)))
            # changes: a Service deleted, an Endpoints emptied
            ns, name = names[0].split("/")
            cs.services.delete(name, ns)
            ns, name = names[1].split("/")
            ep = cs.endpoints.get(name, ns)
            ep.subsets = []
            cs.endpoints.update(ep)
            records.pump()
            out["answers"].append(ask(_queries(root, names)))
            # one question whose name is cut short: dropped, no answer
            s.sendto(b"\x00\x01\x01\x00\x00\x01" + b"\x00" * 6 + b"\x09abc", srv.address)
            out["after_junk"] = ask(_queries(root, names[2:3]))
        out["names"] = records.all_names()
        out["stats"] = dict(srv.stats)
    finally:
        srv.stop()
    return out


@pytest.mark.timeout(60)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_answers_over_udp_equal_the_jax_package(seed):
    jax_out, port_out = (_serve(r, seed) for r in ROOTS)
    assert port_out == jax_out
    assert port_out["stats"]["malformed"] == 1 and port_out["stats"]["nxdomain"] > 0
    assert port_out["stats"]["queries"] > port_out["stats"]["nxdomain"]


def test_dns_entry_needs_an_apiserver():
    """``python -m kubernetes_tpu_torch.dns`` with neither ``--apiserver``
    nor ``--kubeconfig`` leaves through the parser, as the JAX daemon does."""
    main = importlib.import_module("kubernetes_tpu_torch.dns.__main__").main
    with pytest.raises(SystemExit) as e:
        main(["--port", "0"])
    assert e.value.code == 2
