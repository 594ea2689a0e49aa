"""A fixed test PKI, committed so that ``chip_smoke.py`` and the tests can
start a TLS control plane without minting certificates (minting needs
``cryptography``, which a card's machine need not have).  TEST KEYS ONLY:
every file here is public, and nothing they sign should be trusted.

    python -m kubernetes_tpu_torch.testing.pki.mint   # make the set again

The set, each certificate valid 20 years from when it was minted:

- ``ca.crt``/``ca.key``: the cluster CA (CN ``kubernetes``);
- ``apiserver.crt``/``.key``: the serving certificate, SANs ``localhost``
  and ``127.0.0.1``;
- ``admin``: ``kubernetes-admin`` in ``system:masters``;
- ``kube-scheduler``: ``system:kube-scheduler``;
- ``outsider``: ``outsider``, in no group;
- ``other/ca.crt``/``.key`` and ``other/client.crt``/``.key``: a second CA
  and a client certificate (``kubernetes-admin`` in ``system:masters``) it
  signed, which the cluster CA does not."""

from __future__ import annotations

import os

DIR = os.path.dirname(os.path.abspath(__file__))

# name -> (CN, O) of the client certificates the cluster CA signed
CLIENTS = {
    "admin": ("kubernetes-admin", "system:masters"),
    "kube-scheduler": ("system:kube-scheduler", None),
    "outsider": ("outsider", None),
}
SERVER_SANS = {"dns": ("localhost",), "ip": ("127.0.0.1",)}
VALID_DAYS = 7305
HEADER = ("# TEST KEY: part of the fixed test PKI of kubernetes_tpu_torch "
          "(kubernetes_tpu_torch/testing/pki).\n"
          "# It is public: never use it to secure anything.  Mint a cluster's own "
          "with kubernetes_tpu_torch.pki.\n")


def path(name: str) -> str:
    """The fixture file ``name`` (``"ca.crt"``, ``"admin.key"``,
    ``"other/client.crt"``, ...)."""
    return os.path.join(DIR, name)


def pair(name: str) -> tuple[str, str]:
    """(certificate, key) paths of ``name``."""
    return path(f"{name}.crt"), path(f"{name}.key")
