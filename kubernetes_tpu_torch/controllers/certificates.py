"""Certificates controller: approve + sign CSRs.

Capability of ``pkg/controller/certificates`` (CSR signing/approving for
kubelet TLS bootstrap).  The signer issues an opaque certificate payload
for approved CSRs; the approver (optional, mirroring
``gke-certificates-controller``'s auto-approval of node client certs)
auto-approves CSRs from known bootstrap users."""

from __future__ import annotations

import hashlib

from ..api.cluster import CertificateSigningRequest
from ..store.store import NotFoundError
from .base import Controller


class CertificateController(Controller):
    name = "certificates"

    def __init__(self, clientset, informers=None, auto_approve_users: set[str] | None = None, **kw):
        super().__init__(clientset, informers, **kw)
        self.auto_approve_users = auto_approve_users or set()
        self.watch("CertificateSigningRequest", key_fn=lambda csr: csr.meta.name)

    def sync(self, key: str) -> None:
        try:
            csr = self.clientset.certificatesigningrequests.get(key)
        except NotFoundError:
            return
        if csr.denied or (csr.approved and csr.certificate):
            return

        def _update(cur: CertificateSigningRequest) -> CertificateSigningRequest:
            if not cur.approved and not cur.denied:
                if cur.username in self.auto_approve_users:
                    cur.conditions.append({
                        "type": "Approved", "reason": "AutoApproved",
                        "message": f"bootstrap user {cur.username}",
                    })
            if cur.approved and not cur.certificate:
                # opaque issued-cert payload (the reference calls a real
                # x509 signer; the capability is the state machine)
                digest = hashlib.sha256(cur.request.encode()).hexdigest()[:32]
                cur.certificate = f"signed:{cur.username}:{digest}"
            return cur

        self.clientset.certificatesigningrequests.guaranteed_update(key, _update)
