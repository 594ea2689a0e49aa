"""The port's ``pki`` against the JAX package's, and the committed test PKI.

- ``create_cluster_pki``: the same files, subjects, issuers, SANs, EKUs,
  basic constraints, key types and file modes from each package (a twin of
  ``tests/test_selfhosted.py::test_pki_phase``, which needs
  ``cryptography``, as these do to read a certificate).
- ``write_kubeconfig``/``load_kubeconfig``: the same document, mode 0600,
  and the same ``ValueError`` on each document that is not one.
- The fixture set (``kubernetes_tpu_torch/testing/pki``): the expected
  subjects and SANs, each leaf signed by its CA (the second CA's client by
  the second CA only), valid at least five more years, every file marked a
  test key, readable by the standard ``ssl`` module alone; and the mint
  script makes the same set again.  Exact throughout."""

from __future__ import annotations

import datetime
import json
import os
import ssl
import stat

import pytest

from kubernetes_tpu_torch.testing import pki as fixture

FILES = sorted(["ca.crt", "ca.key", "apiserver.crt", "apiserver.key"]
               + [f"{n}.{e}" for n in ("admin", "kube-scheduler", "kube-controller-manager",
                                       "kubelet-cp") for e in ("crt", "key")])


def _x509():
    return pytest.importorskip("cryptography.x509")


def _describe(path: str) -> dict:
    """What a certificate says, in plain values (serials and keys aside)."""
    x509 = _x509()
    from cryptography.hazmat.primitives.asymmetric import ec

    with open(path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    out = {"subject": cert.subject.rfc4514_string(), "issuer": cert.issuer.rfc4514_string(),
           "curve": cert.public_key().curve.name
           if isinstance(cert.public_key(), ec.EllipticCurvePublicKey) else None,
           "days": (cert.not_valid_after_utc - cert.not_valid_before_utc).days}
    for ext in cert.extensions:
        v = ext.value
        if isinstance(v, x509.BasicConstraints):
            out["ca"] = (v.ca, ext.critical)
        elif isinstance(v, x509.ExtendedKeyUsage):
            out["eku"] = sorted(o.dotted_string for o in v)
        elif isinstance(v, x509.SubjectAlternativeName):
            out["dns"] = v.get_values_for_type(x509.DNSName)
            out["ip"] = [str(i) for i in v.get_values_for_type(x509.IPAddress)]
    return out


def _cluster_pki(pki_mod, root: str) -> dict:
    paths = pki_mod.create_cluster_pki(root, node_name="cp")
    d = paths["dir"]
    return {"files": sorted(os.listdir(d)),
            "modes": {f: stat.S_IMODE(os.stat(os.path.join(d, f)).st_mode) & 0o077
                      for f in os.listdir(d)},
            "certs": {f: _describe(os.path.join(d, f)) for f in os.listdir(d)
                      if f.endswith(".crt")},
            "keys": sorted(k for k in paths if k not in ("dir",))}


def test_cluster_pki_equals_the_jax_packages(tmp_path):
    _x509()
    from kubernetes_tpu import pki as jax_pki
    from kubernetes_tpu_torch import pki as port_pki

    old = os.umask(0o022)
    try:
        jax_out = _cluster_pki(jax_pki, str(tmp_path / "jax"))
        port_out = _cluster_pki(port_pki, str(tmp_path / "port"))
    finally:
        os.umask(old)
    assert port_out == jax_out
    assert port_out["files"] == FILES
    # keys are private from birth; certificates are not
    assert all(m == 0 for f, m in port_out["modes"].items() if f.endswith(".key"))
    certs = port_out["certs"]
    assert certs["ca.crt"]["subject"] == certs["ca.crt"]["issuer"] == "CN=kubernetes"
    assert certs["admin.crt"]["subject"] == "CN=kubernetes-admin,O=system:masters"
    assert certs["kube-scheduler.crt"]["subject"] == "CN=system:kube-scheduler"
    assert certs["kubelet-cp.crt"]["subject"] == "CN=system:node:cp,O=system:nodes"
    assert "kubernetes.default.svc" in certs["apiserver.crt"]["dns"]
    assert certs["apiserver.crt"]["eku"] == ["1.3.6.1.5.5.7.3.1"]  # serverAuth
    assert certs["admin.crt"]["eku"] == ["1.3.6.1.5.5.7.3.2"]  # clientAuth
    assert {c["curve"] for c in certs.values()} == {"secp256r1"}


def test_kubeconfig_documents_equal_the_jax_packages(tmp_path):
    from kubernetes_tpu import pki as jax_pki
    from kubernetes_tpu_torch import pki as port_pki

    docs = []
    for mod, sub in ((jax_pki, "jax"), (port_pki, "port")):
        d = tmp_path / sub
        d.mkdir()
        path = mod.write_kubeconfig(str(d), "kube-scheduler", "https://127.0.0.1:1",
                                    fixture.path("ca.crt"),
                                    client_cert=fixture.path("kube-scheduler.crt"),
                                    client_key=fixture.path("kube-scheduler.key"), token="t")
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        assert os.path.basename(path) == "kube-scheduler.kubeconfig"
        docs.append((open(path).read(), mod.load_kubeconfig(path)))
    assert docs[1] == docs[0]
    assert docs[1][1]["client-certificate"] == fixture.path("kube-scheduler.crt")

    bad = {"yaml": "apiVersion: v1\nclusters: []\n", "list": "[1, 2]",
           "no-server": json.dumps({"certificate-authority": "ca.crt"})}
    for name, text in bad.items():
        p = tmp_path / f"{name}.kubeconfig"
        p.write_text(text)
        errors = []
        for mod in (jax_pki, port_pki):
            with pytest.raises(ValueError) as exc:
                mod.load_kubeconfig(str(p))
            errors.append(str(exc.value))
        assert errors[1] == errors[0] and str(p) in errors[1]


def test_the_committed_test_pki():
    x509 = _x509()
    names = sorted(os.path.relpath(os.path.join(dp, f), fixture.DIR)
                   for dp, _, fs in os.walk(fixture.DIR) for f in fs
                   if f.endswith((".crt", ".key")))
    assert names == sorted(["ca.crt", "ca.key", "apiserver.crt", "apiserver.key",
                            "admin.crt", "admin.key", "kube-scheduler.crt", "kube-scheduler.key",
                            "outsider.crt", "outsider.key", "other/ca.crt", "other/ca.key",
                            "other/client.crt", "other/client.key"])
    for name in names:
        with open(fixture.path(name)) as f:
            assert f.read().startswith(fixture.HEADER), name
    described = {n: _describe(fixture.path(n)) for n in names if n.endswith(".crt")}
    assert described["ca.crt"]["subject"] == described["ca.crt"]["issuer"] == "CN=kubernetes"
    assert described["ca.crt"]["ca"] == (True, True)
    assert described["apiserver.crt"]["dns"] == ["localhost"]
    assert described["apiserver.crt"]["ip"] == ["127.0.0.1"]
    want = {"admin.crt": "CN=kubernetes-admin,O=system:masters",
            "kube-scheduler.crt": "CN=system:kube-scheduler", "outsider.crt": "CN=outsider",
            "other/client.crt": "CN=kubernetes-admin,O=system:masters"}
    for name, subject in want.items():
        assert described[name]["subject"] == subject
        assert described[name]["eku"] == ["1.3.6.1.5.5.7.3.2"]
    assert described["other/ca.crt"]["subject"] == "CN=other-ca"

    # each leaf verifies against its own CA and not the other
    def load(n):
        with open(fixture.path(n), "rb") as f:
            return x509.load_pem_x509_certificate(f.read())

    ca, other = load("ca.crt"), load("other/ca.crt")
    for n in ("apiserver.crt", "admin.crt", "kube-scheduler.crt", "outsider.crt"):
        load(n).verify_directly_issued_by(ca)
        with pytest.raises(Exception):
            load(n).verify_directly_issued_by(other)
    load("other/client.crt").verify_directly_issued_by(other)
    with pytest.raises(Exception):
        load("other/client.crt").verify_directly_issued_by(ca)
    # valid at least five more years
    horizon = datetime.datetime.now(datetime.timezone.utc) + datetime.timedelta(days=5 * 366)
    for n in described:
        cert = load(n)
        assert cert.not_valid_before_utc <= datetime.datetime.now(datetime.timezone.utc)
        assert cert.not_valid_after_utc >= horizon, n


def test_the_test_pki_loads_with_the_ssl_module_alone():
    """What a TLS control plane reads from the set needs nothing but
    ``ssl``: the serving pair, the client CA, a client pair."""
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(*fixture.pair("apiserver"))
    server.load_verify_locations(fixture.path("ca.crt"))
    client = ssl.create_default_context(cafile=fixture.path("ca.crt"))
    for name in fixture.CLIENTS:
        client.load_cert_chain(*fixture.pair(name))
    client.load_cert_chain(fixture.path("other/client.crt"), fixture.path("other/client.key"))
    assert server.cert_store_stats()["x509_ca"] == 1


def test_the_mint_script_makes_the_same_set(tmp_path):
    _x509()
    from kubernetes_tpu_torch.testing.pki import mint

    written = mint.mint(str(tmp_path))
    rel = sorted(os.path.relpath(p, tmp_path) for p in written)
    assert rel == sorted(os.path.relpath(os.path.join(dp, f), fixture.DIR)
                         for dp, _, fs in os.walk(fixture.DIR) for f in fs
                         if f.endswith((".crt", ".key")))
    for name in rel:
        if name.endswith(".crt"):
            new, old = _describe(str(tmp_path / name)), _describe(fixture.path(name))
            assert new == old, name
        assert open(tmp_path / name).read().startswith(fixture.HEADER)
