"""The port's binary wire codec (``kubernetes_tpu_torch.api.wire``), the
durable store's record format, against the JAX package's codec.

The same seeded objects (pods and nodes of a mixed cluster, the admission
chain's kinds, and seeded JSON-shaped documents with negative and large
integers, floats, unicode, repeated short and long strings) encode to the
same bytes in both packages, and each package decodes the other's bytes
back to the object.  Tolerance: exact byte equality."""

import importlib
import json

import numpy as np
import pytest

from tests import torch_port_cases as cases

JAX, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"


def _wire(pkg):
    return importlib.import_module(f"{pkg}.api.wire")


def _cluster_docs(pkg, seed):
    m, pods, _ = cases.mixed(pkg, seed=seed, n_nodes=8, n_pods=30)
    return [ni.node.to_dict() for ni in m.values()] + [p.to_dict() for p in pods]


def _kind_docs(pkg):
    api = importlib.import_module(f"{pkg}.api")
    c = importlib.import_module(f"{pkg}.api.cluster")
    Q, M = api.Quantity, api.ObjectMeta
    sel = api.LabelSelector.from_match_labels({"app": "web"})
    return [o.to_dict() for o in (
        c.Namespace(meta=M(name="tenant-a", labels={"team": "x"})),
        c.Secret(meta=M(name="s", namespace="tenant-a"), data={"k": "dmFs"}),
        c.ServiceAccount(meta=M(name="sa", namespace="tenant-a"), secrets=["s"]),
        c.ResourceQuota(meta=M(name="q", namespace="tenant-a"),
                        hard={"pods": Q("10"), "requests.cpu": Q("4")}, scopes=["NotBestEffort"]),
        c.LimitRange(meta=M(name="lr", namespace="tenant-a"), limits=[c.LimitRangeItem(
            default_request={"cpu": Q("100m"), "memory": Q("128Mi")}, max={"cpu": Q("2")})]),
        c.PodPreset(meta=M(name="pp", namespace="tenant-a"), selector=sel, env={"A": "1"},
                    volumes=[{"name": "cache"}]),
        c.StorageClass(meta=M(name="std"), provisioner="p", is_default=True,
                       parameters={"type": "ssd"}),
        c.PriorityClass(meta=M(name="high"), value=1000, description="d"),
        c.PodSecurityPolicy(meta=M(name="psp"), privileged=True,
                            run_as_user={"rule": "MustRunAs", "min": 1, "max": 9}),
        c.NetworkPolicy(meta=M(name="np", namespace="default"), pod_selector=sel, ingress=[
            c.NetworkPolicyIngressRule(ports=[c.NetworkPolicyPort(port=80),
                                              c.NetworkPolicyPort(protocol="UDP", port="dns")],
                                       from_peers=[c.NetworkPolicyPeer(pod_selector=sel)])]),
    )]


def _random_doc(rng, depth=0):
    """A seeded JSON-shaped value: every type tag of the codec."""
    pick = rng.integers(0, 9 if depth < 3 else 6)
    if pick == 0:
        return None
    if pick == 1:
        return bool(rng.integers(0, 2))
    if pick == 2:
        return int(rng.integers(-(2 ** 62), 2 ** 62))
    if pick == 3:
        return float(rng.normal() * 10 ** int(rng.integers(-5, 6)))
    if pick == 4:  # short strings repeat and intern
        return ["a", "Pending", "ünïcødé", "", "kube-system"][int(rng.integers(0, 5))]
    if pick == 5:  # long strings intern from their second occurrence
        return "x" * int(rng.integers(60, 70)) + str(int(rng.integers(0, 3)))
    if pick in (6, 7):
        return [_random_doc(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]
    return {f"k{int(rng.integers(0, 12))}": _random_doc(rng, depth + 1)
            for _ in range(int(rng.integers(0, 6)))}


def _docs(pkg, seed):
    rng = np.random.default_rng(seed)
    return (_cluster_docs(pkg, seed) + _kind_docs(pkg)
            + [_random_doc(rng) for _ in range(40)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encodings_are_byte_equal_to_the_jax_codec(seed):
    port, jax = _docs(PORT, seed), _docs(JAX, seed)
    assert json.dumps(port) == json.dumps(jax)  # the same documents
    for p, j in zip(port, jax):
        assert _wire(PORT).encode(p) == _wire(JAX).encode(j)
    # one document holding all of them: the key table spans every kind
    assert _wire(PORT).encode({"items": port}) == _wire(JAX).encode({"items": jax})


@pytest.mark.parametrize("seed", [0, 1])
def test_each_package_decodes_the_others_bytes(seed):
    for doc in _docs(PORT, seed):
        for enc, dec in ((PORT, JAX), (JAX, PORT), (PORT, PORT)):
            assert _wire(dec).decode(_wire(enc).encode(doc)) == doc


def test_quantities_encode_through_their_json_form_and_garbage_is_refused():
    from kubernetes_tpu.api import Quantity as JQ
    from kubernetes_tpu_torch.api import Quantity

    doc = {"cpu": Quantity("250m"), "memory": Quantity("1Gi")}
    assert _wire(PORT).encode(doc) == _wire(JAX).encode({"cpu": JQ("250m"),
                                                         "memory": JQ("1Gi")})
    assert _wire(PORT).decode(_wire(PORT).encode(doc)) == {"cpu": "250m", "memory": "1Gi"}
    with pytest.raises(TypeError):
        _wire(PORT).encode({"bad": object()})
    with pytest.raises(ValueError, match="magic"):
        _wire(PORT).decode(b"json{}")
