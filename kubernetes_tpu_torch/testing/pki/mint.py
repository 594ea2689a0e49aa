"""Mint the fixed test PKI of ``kubernetes_tpu_torch/testing/pki`` again,
with the port's own ``pki`` module (needs ``cryptography``):

    python -m kubernetes_tpu_torch.testing.pki.mint [DIR]

Every file written starts with a comment saying it is a test key; PEM
readers skip text before the ``-----BEGIN`` line."""

from __future__ import annotations

import os
import sys
import tempfile

from . import CLIENTS, DIR, HEADER, SERVER_SANS, VALID_DAYS


def _stamp(src: str, dst: str) -> None:
    with open(src) as f:
        body = f.read()
    with open(dst, "w") as f:
        f.write(HEADER + body)


def mint(out_dir: str = DIR) -> list[str]:
    from ... import pki

    written = []
    with tempfile.TemporaryDirectory() as tmp:
        made = [pki.create_ca(tmp, days=VALID_DAYS)]
        made.append(pki.issue_cert(tmp, "apiserver", "kube-apiserver", server=True,
                                   dns_sans=SERVER_SANS["dns"], ip_sans=SERVER_SANS["ip"],
                                   days=VALID_DAYS))
        for name, (cn, org) in CLIENTS.items():
            made.append(pki.issue_cert(tmp, name, cn, org, days=VALID_DAYS))
        other = os.path.join(tmp, "other")
        made.append(pki.create_ca(other, cn="other-ca", days=VALID_DAYS))
        made.append(pki.issue_cert(other, "client", "kubernetes-admin", "system:masters",
                                   days=VALID_DAYS))
        os.makedirs(os.path.join(out_dir, "other"), exist_ok=True)
        for crt, key in made:
            for src in (crt, key):
                dst = os.path.join(out_dir, os.path.relpath(src, tmp))
                _stamp(src, dst)
                written.append(dst)
    return written


if __name__ == "__main__":
    for p in mint(sys.argv[1] if len(sys.argv) > 1 else DIR):
        print(p)
