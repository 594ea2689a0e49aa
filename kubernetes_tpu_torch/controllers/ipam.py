"""IPAM: node pod-CIDR allocation + bootstrap token housekeeping.

Capabilities of three reference pieces grouped here:

- ``NodeIpamController`` (``pkg/controller/node/ipam``): carve the
  cluster CIDR into fixed-size per-node ranges and assign each node a
  ``spec.podCIDR``; released when the node goes away.
- ``BootstrapSigner`` (``pkg/controller/bootstrap/bootstrapsigner.go``):
  keep the ``kube-public/cluster-info`` ConfigMap signed with every
  active bootstrap token (HMAC stands in for JWS — the capability is a
  discovery document joiners can verify with nothing but their token).
- ``TokenCleaner`` (``tokencleaner.go``): delete expired bootstrap
  token Secrets.
"""

from __future__ import annotations

import hashlib
import hmac
import ipaddress
import logging
import threading

from ..api import types as api
from ..api.cluster import ConfigMap, Secret
from ..api.meta import ObjectMeta
from ..store.store import AlreadyExistsError, NotFoundError
from .base import Controller

logger = logging.getLogger("kubernetes_tpu_torch.controllers.ipam")

BOOTSTRAP_TOKEN_PREFIX = "bootstrap-token-"
CLUSTER_INFO = "cluster-info"
KUBE_PUBLIC = "kube-public"
KUBE_SYSTEM = "kube-system"


class NodeIpamController(Controller):
    """reference ``pkg/controller/node/ipam`` range allocator.

    A range is reserved under ``_mu`` before it is written (the reference's
    ``CidrSet.AllocateNext``), so two workers never hand out one range;
    and once the cluster CIDR is exhausted, a node's sync returns at once
    until a range comes back (a node deleted or its range dropped), where
    the JAX controller scans every range against every node again on each
    of the node's updates."""

    name = "node-ipam"

    def __init__(self, clientset, informers=None,
                 cluster_cidr: str = "10.8.0.0/14", node_cidr_mask: int = 24, **kw):
        super().__init__(clientset, informers, **kw)
        self.network = ipaddress.ip_network(cluster_cidr)
        self.node_cidr_mask = node_cidr_mask
        # in-flight allocations (the reference's CidrSet): the informer
        # cache lags our own writes within a sync burst, so the
        # controller's view of "used" must include what IT just assigned.
        # Guarded by _mu: sync() runs on worker threads while _release()
        # fires on the informer thread (ktpu-analyze RL303).
        self._mu = threading.Lock()
        self._allocated: set[str] = set()
        # no free range was left at the last scan; cleared when one returns
        self._exhausted = False
        from ..client.informer import Handler

        self.informers.informer("Node").add_handler(Handler(
            on_add=lambda n: self.queue.add(n.meta.name),
            on_update=self._updated,
            on_delete=self._release,
        ))

    def _updated(self, old: api.Node, new: api.Node) -> None:
        if old is not None and old.spec.pod_cidr and old.spec.pod_cidr != new.spec.pod_cidr:
            with self._mu:
                self._exhausted = False  # a range left this node
        self.queue.add(new.meta.name)

    def _release(self, node: api.Node) -> None:
        # node gone: its range returns to the pool (docstring contract)
        if node.spec.pod_cidr:
            with self._mu:
                self._allocated.discard(node.spec.pod_cidr)
                self._exhausted = False

    def _reserve(self) -> "str | None":
        """The first free range, reserved; None when none is left."""
        with self._mu:
            if self._exhausted:
                return None
            used = set(self._allocated)
            used |= {n.spec.pod_cidr for n in self.informer("Node").list() if n.spec.pod_cidr}
            for subnet in self.network.subnets(new_prefix=self.node_cidr_mask):
                cidr = str(subnet)
                if cidr not in used:
                    self._allocated.add(cidr)
                    return cidr
            self._exhausted = True
        logger.error("node-ipam: cluster CIDR %s exhausted", self.network)
        return None

    def sync(self, key: str) -> None:
        node = self.informer("Node").get(key)
        if node is None or node.spec.pod_cidr:
            return  # gone, or already allocated (CIDRs are sticky)
        cidr = self._reserve()
        if cidr is None:
            return

        def _assign(cur: api.Node) -> api.Node:
            if not cur.spec.pod_cidr:  # lost race: keep first writer's
                cur.spec.pod_cidr = cidr
            return cur

        got = None
        try:
            got = self.clientset.nodes.guaranteed_update(key, _assign, "")
        except NotFoundError:
            pass
        finally:
            if got is None or got.spec.pod_cidr != cidr:  # lost races must not leak
                with self._mu:
                    self._allocated.discard(cidr)
                    self._exhausted = False


def sign_cluster_info(payload: str, token_secret: str) -> str:
    return hmac.new(token_secret.encode(), payload.encode(), hashlib.sha256).hexdigest()


def parse_token_expiration(raw) -> float:
    """Epoch-seconds or RFC3339; malformed values mean ALREADY EXPIRED —
    a broken token must fail closed, not crash the auth path."""
    if raw is None or raw == "inf":
        return float("inf")
    try:
        return float(raw)
    except (TypeError, ValueError):
        pass
    try:
        from datetime import datetime

        return datetime.fromisoformat(str(raw).replace("Z", "+00:00")).timestamp()
    except ValueError:
        return float("-inf")


def _bootstrap_tokens(secrets) -> list[tuple[str, str, float]]:
    """[(token_id, token_secret, expiration)] from bootstrap Secrets."""
    out = []
    for s in secrets:
        if not s.meta.name.startswith(BOOTSTRAP_TOKEN_PREFIX):
            continue
        data = s.data
        tid = data.get("token-id", s.meta.name[len(BOOTSTRAP_TOKEN_PREFIX):])
        out.append((tid, data.get("token-secret", ""),
                    parse_token_expiration(data.get("expiration"))))
    return out


class BootstrapSignerController(Controller):
    """Signs kube-public/cluster-info with every live bootstrap token."""

    name = "bootstrapsigner"

    def __init__(self, clientset, informers=None, cluster_info_payload: str = "", **kw):
        super().__init__(clientset, informers, **kw)
        self.payload = cluster_info_payload
        self.watch("Secret", key_fn=self._secret_key)

    def _secret_key(self, secret):
        if secret.meta.namespace == KUBE_SYSTEM and secret.meta.name.startswith(
            BOOTSTRAP_TOKEN_PREFIX
        ):
            return "sign"
        return None

    def sync(self, key: str) -> None:
        secrets = [
            s for s in self.informer("Secret").list() if s.meta.namespace == KUBE_SYSTEM
        ]
        payload = self.payload
        if not payload:
            # a signer started without its own payload (the default
            # controller set) signs the EXISTING discovery document —
            # it must never clobber what cluster init published
            try:
                payload = self.clientset.configmaps.get(
                    CLUSTER_INFO, KUBE_PUBLIC
                ).data.get("kubeconfig", "")
            except NotFoundError:
                return  # nothing to sign yet
        now = self.clock()
        sigs = {
            f"jws-kubeconfig-{tid}": sign_cluster_info(payload, tok)
            for tid, tok, exp in _bootstrap_tokens(secrets)
            if tok and exp > now
        }
        body = {"kubeconfig": payload, **sigs}

        try:
            def _update(cur: ConfigMap) -> ConfigMap:
                cur.data = dict(body)
                return cur

            self.clientset.configmaps.guaranteed_update(CLUSTER_INFO, _update, KUBE_PUBLIC)
        except NotFoundError:
            try:
                self.clientset.configmaps.create(ConfigMap(
                    meta=ObjectMeta(name=CLUSTER_INFO, namespace=KUBE_PUBLIC),
                    data=dict(body),
                ))
            except AlreadyExistsError:
                pass


class TokenCleanerController(Controller):
    """Deletes expired bootstrap token Secrets (tokencleaner.go)."""

    name = "tokencleaner"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.informers.informer("Secret")

    def sync(self, key: str) -> None:  # tick-driven
        pass

    def tick(self) -> int:
        self.informers.pump_all()
        now = self.clock()
        deleted = 0
        for s in list(self.informer("Secret").list()):
            if s.meta.namespace != KUBE_SYSTEM:
                continue
            if not s.meta.name.startswith(BOOTSTRAP_TOKEN_PREFIX):
                continue
            exp = parse_token_expiration(s.data.get("expiration"))
            if exp <= now:
                try:
                    self.clientset.secrets.delete(s.meta.name, KUBE_SYSTEM)
                    deleted += 1
                except NotFoundError:
                    pass
        return deleted
