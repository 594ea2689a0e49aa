"""ServiceAccount + token controllers.

Capability of ``pkg/controller/serviceaccount``: ensure every namespace
has a "default" ServiceAccount (``serviceaccounts_controller.go``), and
mint a token Secret for each ServiceAccount that lacks one
(``tokens_controller.go``, tokens signed by ``pkg/serviceaccount`` — here
the HMAC minter from the auth stack)."""

from __future__ import annotations

from ..api.cluster import Secret, ServiceAccount
from ..api.meta import ObjectMeta
from ..auth.authn import ServiceAccountTokenMinter
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller


class ServiceAccountController(Controller):
    name = "serviceaccount"

    def __init__(self, clientset, informers=None,
                 minter: ServiceAccountTokenMinter | None = None, **kw):
        super().__init__(clientset, informers, **kw)
        self.minter = minter or ServiceAccountTokenMinter()
        self.watch("Namespace", key_fn=lambda ns: f"ns/{ns.meta.name}")
        self.watch("ServiceAccount", key_fn=lambda sa: f"sa/{sa.meta.key}")

    def sync(self, key: str) -> None:
        what, _, rest = key.partition("/")
        if what == "ns":
            self._ensure_default_sa(rest)
        elif what == "sa":
            namespace, name = rest.split("/", 1)
            self._ensure_token(namespace, name)

    def _ensure_default_sa(self, namespace: str) -> None:
        try:
            ns = self.clientset.namespaces.get(namespace)
        except NotFoundError:
            return
        if ns.phase == "Terminating":
            return
        try:
            self.clientset.serviceaccounts.get("default", namespace)
        except NotFoundError:
            try:
                self.clientset.serviceaccounts.create(
                    ServiceAccount(meta=ObjectMeta(name="default", namespace=namespace)))
            except AlreadyExistsError:
                pass

    def _ensure_token(self, namespace: str, name: str) -> None:
        try:
            sa = self.clientset.serviceaccounts.get(name, namespace)
        except NotFoundError:
            return
        if sa.secrets:
            return
        secret_name = f"{name}-token"
        token = self.minter.mint(namespace, name)
        try:
            self.clientset.secrets.create(Secret(
                meta=ObjectMeta(name=secret_name, namespace=namespace),
                type="kubernetes.io/service-account-token",
                data={"token": token},
            ))
        except AlreadyExistsError:
            pass

        def _link(cur: ServiceAccount) -> ServiceAccount:
            if secret_name not in cur.secrets:
                cur.secrets.append(secret_name)
            return cur

        self.clientset.serviceaccounts.guaranteed_update(name, _link, namespace)
