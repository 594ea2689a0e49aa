"""Cluster PKI: the kubeadm certs + kubeconfig phases.

Capability of ``cmd/kubeadm/app/phases/certs`` and ``phases/kubeconfig``:
one self-signed cluster CA, a serving certificate for the apiserver
(SANs for loopback + the cluster DNS names), and per-component CLIENT
certificates whose Subject carries the component identity the way the
reference encodes it (CN = user, O = group — ``system:kube-scheduler``,
``system:kube-controller-manager``, ``system:node:<name>``/
``system:nodes``, ``kubernetes-admin``/``system:masters``).  The
kubeconfig phase writes one JSON connection document per component
(server URL + CA + client cert/key paths) consumed by
``daemon.remote_clientset(kubeconfig=...)``.

Everything is generated with the ``cryptography`` library, imported
inside the functions that mint (no openssl shell-outs), and keys and
kubeconfig documents are written 0600 from birth like the reference's.
Reading a kubeconfig needs nothing beyond the standard library, so a
daemon that is handed certificates never needs ``cryptography``.
``create_ca``/``issue_cert`` take ``days`` (the port's addition) so a
long-lived test PKI can be minted.
"""

from __future__ import annotations

import datetime
import ipaddress
import json
import os
from typing import Optional

CERT_DAYS = 365


def _write(path: str, data: bytes, private: bool = False) -> str:
    if private:
        # 0600 from birth — chmod-after-write leaves the key world-readable
        # for a window (and forever, if interrupted between the two calls)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        return path
    with open(path, "wb") as f:
        f.write(data)
    return path


def _key_pem(key) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def _new_key():
    from cryptography.hazmat.primitives.asymmetric import ec

    # ECDSA P-256: small certs, fast handshakes; the reference default is
    # RSA-2048 but the contract is "X.509 chain", not the key algorithm
    return ec.generate_private_key(ec.SECP256R1())


def _name(cn: str, org: Optional[str] = None):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, cn)]
    if org:
        attrs.insert(0, x509.NameAttribute(NameOID.ORGANIZATION_NAME, org))
    return x509.Name(attrs)


def create_ca(pki_dir: str, cn: str = "kubernetes",
              days: int = CERT_DAYS * 10) -> tuple[str, str]:
    """Self-signed cluster CA -> (ca.crt, ca.key) paths."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization

    os.makedirs(pki_dir, exist_ok=True)
    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(cn))
        .issuer_name(_name(cn))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    crt = _write(os.path.join(pki_dir, "ca.crt"),
                 cert.public_bytes(serialization.Encoding.PEM))
    keyf = _write(os.path.join(pki_dir, "ca.key"), _key_pem(key), private=True)
    return crt, keyf


def issue_cert(pki_dir: str, name: str, cn: str, org: Optional[str] = None,
               dns_sans: tuple = (), ip_sans: tuple = (),
               server: bool = False, days: int = CERT_DAYS) -> tuple[str, str]:
    """CA-signed leaf -> (<name>.crt, <name>.key).  ``server=True`` adds
    serverAuth EKU + the SANs; client certs get clientAuth EKU."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import ExtendedKeyUsageOID

    with open(os.path.join(pki_dir, "ca.crt"), "rb") as f:
        ca_cert = x509.load_pem_x509_certificate(f.read())
    with open(os.path.join(pki_dir, "ca.key"), "rb") as f:
        ca_key = serialization.load_pem_private_key(f.read(), password=None)

    key = _new_key()
    now = datetime.datetime.now(datetime.timezone.utc)
    eku = [ExtendedKeyUsageOID.SERVER_AUTH if server
           else ExtendedKeyUsageOID.CLIENT_AUTH]
    draft = (
        x509.CertificateBuilder()
        .subject_name(_name(cn, org))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(x509.ExtendedKeyUsage(eku), critical=False)
    )
    sans = [x509.DNSName(d) for d in dns_sans]
    sans += [x509.IPAddress(ipaddress.ip_address(i)) for i in ip_sans]
    if sans:
        draft = draft.add_extension(
            x509.SubjectAlternativeName(sans), critical=False)
    cert = draft.sign(ca_key, hashes.SHA256())
    crt = _write(os.path.join(pki_dir, f"{name}.crt"),
                 cert.public_bytes(serialization.Encoding.PEM))
    keyf = _write(os.path.join(pki_dir, f"{name}.key"), _key_pem(key),
                  private=True)
    return crt, keyf


# the reference's component identities (kubeadm phases/certs/certs.go)
COMPONENTS = {
    "admin": ("kubernetes-admin", "system:masters"),
    "kube-scheduler": ("system:kube-scheduler", None),
    "kube-controller-manager": ("system:kube-controller-manager", None),
}


def create_cluster_pki(cluster_dir: str, node_name: str = "control-plane",
                       advertise_ip: str = "127.0.0.1") -> dict:
    """The full certs phase: CA + apiserver serving cert + component
    client certs + the kubelet's node client cert.  Returns a path map."""
    pki_dir = os.path.join(cluster_dir, "pki")
    ca_crt, ca_key = create_ca(pki_dir)
    paths = {"ca": ca_crt, "ca_key": ca_key, "dir": pki_dir}
    paths["apiserver"], paths["apiserver_key"] = issue_cert(
        pki_dir, "apiserver", "kube-apiserver", server=True,
        dns_sans=("localhost", "kubernetes", "kubernetes.default",
                  "kubernetes.default.svc", "kubernetes.default.svc.cluster.local"),
        ip_sans=(advertise_ip,),
    )
    for name, (cn, org) in COMPONENTS.items():
        paths[name], paths[f"{name}_key"] = issue_cert(pki_dir, name, cn, org)
    kubelet_name = f"kubelet-{node_name}"
    paths["kubelet"], paths["kubelet_key"] = issue_cert(
        pki_dir, kubelet_name, f"system:node:{node_name}", "system:nodes")
    return paths


def write_kubeconfig(cluster_dir: str, component: str, server: str,
                     ca: str, client_cert: Optional[str] = None,
                     client_key: Optional[str] = None,
                     token: Optional[str] = None) -> str:
    """The kubeconfig phase: one connection document per component
    (kubeadm ``phases/kubeconfig``).  JSON, not YAML-kubeconfig — the
    fields carry the same facts: server, CA pin, client identity."""
    path = os.path.join(cluster_dir, f"{component}.kubeconfig")
    doc = {"server": server, "certificate-authority": os.path.abspath(ca)}
    if client_cert:
        doc["client-certificate"] = os.path.abspath(client_cert)
        doc["client-key"] = os.path.abspath(client_key)
    if token:
        doc["token"] = token
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, indent=2)
    return path


def load_kubeconfig(path: str) -> dict:
    """Parse a connection kubeconfig document.  Raises ValueError (not a
    raw json/KeyError traceback) on files that are not this format —
    e.g. the YAML clusters/contexts file ``kubectl config`` maintains."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path} is not a connection kubeconfig (JSON): {e}. "
            "Files written by 'kubectl config set-*' are a different "
            "format; pass a kubeconfig generated by 'cluster up' / "
            "kubeadm-style init instead.") from e
    if not isinstance(doc, dict) or "server" not in doc:
        raise ValueError(
            f"{path}: connection kubeconfig must be a JSON object with "
            "a 'server' field")
    return doc
