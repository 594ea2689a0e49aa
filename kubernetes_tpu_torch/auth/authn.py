"""Authentication (SURVEY.md §2.9): who is making this request.

Capability equivalents of the reference's authenticator stack
(``pkg/kubeapiserver/authenticator/config.go`` builds a union of x509,
token-file, service-account-JWT, bootstrap-token and webhook
authenticators; interfaces in ``apiserver/pkg/authentication``).

Transport: over TLS with a client CA (``apiserver.server.TLSConfig``) the
handshake verifies a client certificate and its subject becomes the
identity (``X509CertificateAuthenticator.from_peercert``, the standard
``ssl`` module alone); every other credential rides the ``Authorization``
header, and identity-asserting headers play the front proxy's part (the
reference's ``RequestHeader`` authenticator).  The PEM-header path and
OIDC's RS256 import ``cryptography`` inside the call and fail closed
without it, as the JAX package's do.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
from dataclasses import dataclass, field
from typing import Optional

# rejection causes log at debug and never include credential material —
# auth failures are normal traffic, but a systematic one needs a trail
logger = logging.getLogger("kubernetes_tpu_torch.auth")


@dataclass
class UserInfo:
    """Reference ``authentication/user.Info``."""

    name: str = ""
    groups: list[str] = field(default_factory=list)

    @property
    def authenticated(self) -> bool:
        return bool(self.name) and self.name != ANONYMOUS.name


ANONYMOUS = UserInfo(name="system:anonymous", groups=["system:unauthenticated"])


class Authenticator:
    """Returns a UserInfo or None (not my credential type / invalid)."""

    def authenticate(self, headers) -> Optional[UserInfo]:
        raise NotImplementedError


class TokenFileAuthenticator(Authenticator):
    """Static bearer tokens (reference ``--token-auth-file``,
    ``plugin/pkg/auth/authenticator/token/tokenfile``)."""

    def __init__(self, tokens: dict[str, UserInfo | str]):
        self.tokens: dict[str, UserInfo] = {
            t: (u if isinstance(u, UserInfo) else UserInfo(name=u))
            for t, u in tokens.items()
        }

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        return self.tokens.get(auth[7:])


def parse_token_expiration(raw) -> float:
    """A bootstrap token's ``expiration``: epoch seconds or RFC 3339.  A
    malformed value means already expired: a broken token fails closed and
    never crashes the auth path.  (The JAX package keeps this in
    ``controllers/ipam.py``; the port has its own copy.)"""
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


class BootstrapTokenAuthenticator(Authenticator):
    """Bootstrap tokens "<id>.<secret>" validated against live
    ``bootstrap-token-<id>`` Secrets in kube-system (reference
    ``plugin/pkg/auth/authenticator/token/bootstrap``): unexpired tokens
    authenticate as ``system:bootstrap:<id>`` in
    ``system:bootstrappers`` — the kubeadm join credential."""

    def __init__(self, store, clock=None):
        import time

        self.store = store
        self.clock = clock or time.time

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer ") or "." not in auth[7:]:
            return None
        token_id, _, token_secret = auth[7:].partition(".")
        from ..store.store import NotFoundError

        try:
            raw = self.store.get("Secret", "kube-system", f"bootstrap-token-{token_id}")
        except NotFoundError:
            return None
        data = raw.get("data") or {}
        if not hmac.compare_digest(
            str(data.get("token-secret", "")), token_secret
        ):
            return None
        if parse_token_expiration(data.get("expiration")) <= self.clock():
            return None
        # the reference splits token usages: a signing-only token must NOT
        # authenticate — require the authentication usage explicitly
        if data.get("usage-bootstrap-authentication") not in ("true", True):
            return None
        return UserInfo(name=f"system:bootstrap:{token_id}",
                        groups=["system:bootstrappers"])


class RequestHeaderAuthenticator(Authenticator):
    """Identity asserted via X-Remote-User / X-Remote-Group headers — the
    front-proxy / client-cert stand-in (reference
    ``apiserver/pkg/authentication/request/headerrequest``)."""

    def authenticate(self, headers) -> Optional[UserInfo]:
        name = headers.get("X-Remote-User", "")
        if not name:
            return None
        groups = [g for g in headers.get("X-Remote-Group", "").split(",") if g]
        return UserInfo(name=name, groups=groups)


class ServiceAccountTokenAuthenticator(Authenticator):
    """Verifies tokens minted by :class:`ServiceAccountTokenMinter`
    (reference ``pkg/serviceaccount/jwt.go`` — JWTs signed with the cluster
    key; here HMAC-SHA256 in JWT layout, no external deps)."""

    def __init__(self, minter: "ServiceAccountTokenMinter"):
        self.minter = minter

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        claims = self.minter.verify(auth[7:])
        if claims is None:
            return None
        namespace, name = claims
        return UserInfo(
            name=f"system:serviceaccount:{namespace}:{name}",
            groups=["system:serviceaccounts", f"system:serviceaccounts:{namespace}"],
        )


class X509CertificateAuthenticator(Authenticator):
    """Client-certificate identity (reference
    ``apiserver/pkg/authentication/request/x509``): subject CN is the
    user, O entries are the groups.

    Two ingestion paths, both ending in the same subject mapping:

    - **TLS handshake** (the reference's own path): the wire server
      verifies the chain against the client CA during the handshake and
      hands the peer-cert subject to :meth:`from_peercert`.
    - **PEM header** (front-proxy style, for plain-HTTP deployments): the
      proxy forwards the client cert in ``X-Client-Certificate``
      (base64 PEM); :meth:`authenticate` verifies the CA signature and
      validity window before trusting the subject.  Because a certificate
      alone proves nothing about who SENT it (certs are public artifacts),
      this path additionally requires the proxy to authenticate itself
      with ``proxy_secret`` in ``X-Proxy-Authorization`` — the analogue of
      the reference requiring the front proxy's own client cert
      (``--requestheader-client-ca-file``).  Without a configured
      ``proxy_secret`` the header path is disabled entirely.
    """

    HEADER = "X-Client-Certificate"
    PROXY_HEADER = "X-Proxy-Authorization"

    def __init__(self, ca_pem: Optional[bytes] = None,
                 proxy_secret: Optional[str] = None, clock=None):
        import time

        self.ca_pem = ca_pem
        self.proxy_secret = proxy_secret
        self.clock = clock or time.time

    @staticmethod
    def from_peercert(peercert: Optional[dict]) -> Optional[UserInfo]:
        """Map an ``ssl.SSLSocket.getpeercert()`` dict (chain already
        verified by the handshake) to a UserInfo."""
        if not peercert:
            return None
        name, groups = "", []
        for rdn in peercert.get("subject", ()):
            for key, value in rdn:
                if key == "commonName":
                    name = value
                elif key == "organizationName":
                    groups.append(value)
        return UserInfo(name=name, groups=groups) if name else None

    def authenticate(self, headers) -> Optional[UserInfo]:
        raw = headers.get(self.HEADER, "")
        if not raw or self.ca_pem is None or not self.proxy_secret:
            return None
        if not hmac.compare_digest(
            headers.get(self.PROXY_HEADER, ""), self.proxy_secret
        ):
            return None
        try:
            pem = _unb64(raw)
        except Exception as e:  # noqa: BLE001 - bad credential => 401
            logger.debug("x509: undecodable %s payload (%s): rejected",
                         self.HEADER, type(e).__name__)
            return None
        return self._verify_pem(pem)

    def _verify_pem(self, pem: bytes) -> Optional[UserInfo]:
        try:
            from cryptography import x509 as cx509
            from cryptography.x509.oid import NameOID

            cert = cx509.load_pem_x509_certificate(pem)
            ca = cx509.load_pem_x509_certificate(self.ca_pem)
            cert.verify_directly_issued_by(ca)
        except Exception as e:  # noqa: BLE001 - bad credential => 401
            # unparseable cert, signature mismatch, or no cryptography
            # module at all — every case reads as a rejected credential
            logger.debug("x509: certificate verification failed (%s): "
                         "rejected", type(e).__name__)
            return None
        import datetime

        now = datetime.datetime.fromtimestamp(self.clock(), tz=datetime.timezone.utc)
        if not (cert.not_valid_before_utc <= now <= cert.not_valid_after_utc):
            return None
        cn = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        orgs = cert.subject.get_attributes_for_oid(NameOID.ORGANIZATION_NAME)
        if not cn:
            return None
        return UserInfo(name=cn[0].value, groups=[o.value for o in orgs])


class WebhookTokenAuthenticator(Authenticator):
    """Delegates bearer tokens to an external TokenReview service
    (reference ``plugin/pkg/auth/authenticator/token/webhook``): POST a
    TokenReview, trust the returned user on ``status.authenticated``.
    Verdicts are cached with a TTL (the reference's 2-minute cache) so a
    flood of requests doesn't hammer the webhook."""

    CACHE_MAX = 4096

    def __init__(self, url: str, timeout: float = 5.0, cache_ttl: float = 120.0,
                 clock=None):
        import time

        self.url = url
        self.timeout = timeout
        self.cache_ttl = cache_ttl
        self.clock = clock or time.time
        self._cache: dict[str, tuple[float, Optional[UserInfo]]] = {}

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        token = auth[7:]
        hit = self._cache.get(token)
        if hit is not None and self.clock() - hit[0] < self.cache_ttl:
            return hit[1]
        try:
            user = self._review(token)
        except OSError:
            # transport failure is NOT a verdict: don't poison the cache —
            # the token gets re-reviewed as soon as the webhook recovers
            return None
        now = self.clock()
        if len(self._cache) >= self.CACHE_MAX:
            # evict expired entries; if still full (an unauthenticated
            # flood of distinct tokens), drop the oldest — the cache must
            # not be a memory-exhaustion vector
            self._cache = {t: v for t, v in self._cache.items()
                           if now - v[0] < self.cache_ttl}
            while len(self._cache) >= self.CACHE_MAX:
                self._cache.pop(next(iter(self._cache)))
        self._cache[token] = (now, user)
        return user

    def _review(self, token: str) -> Optional[UserInfo]:
        import urllib.error
        import urllib.request

        body = json.dumps({"kind": "TokenReview",
                           "spec": {"token": token}}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                status = json.loads(r.read()).get("status") or {}
        except urllib.error.HTTPError as e:
            if e.code < 500:
                # a 4xx is a deliberate answer: fail closed, cacheable
                return None
            # a 5xx is the webhook failing, not deciding — treat like an
            # unreachable server so the verdict cache is not poisoned
            raise OSError(f"webhook 5xx: {e.code}") from e
        except Exception as e:
            # unreachable/timeout: fail closed for this request but let the
            # caller skip the cache write
            raise OSError(str(e)) from e
        if not status.get("authenticated"):
            return None
        user = status.get("user") or {}
        if not user.get("username"):
            return None
        return UserInfo(name=user["username"], groups=list(user.get("groups") or []))


class OIDCAuthenticator(Authenticator):
    """OIDC-style JWT validation (reference
    ``plugin/pkg/auth/authenticator/token/oidc``): verify signature,
    issuer, audience and expiry, then map the username/groups claims.
    Verification keys are supplied out-of-band (the reference fetches
    JWKS from the issuer; this deployment has no egress, so the key is
    config): HS256 with a shared secret, or RS256 with an RSA public key
    when the ``cryptography`` backend is present."""

    def __init__(self, issuer: str, audience: str, key,
                 username_claim: str = "sub", groups_claim: str = "groups",
                 username_prefix: str = "", alg: Optional[str] = None,
                 clock=None):
        import time

        self.issuer = issuer
        self.audience = audience
        self.key = key
        self.username_claim = username_claim
        self.groups_claim = groups_claim
        self.username_prefix = username_prefix
        # The accepted algorithm is FIXED at configuration time — never
        # taken from the token header, or an attacker could downgrade an
        # RS256 deployment to HS256 and use the (public!) RSA key PEM as
        # the HMAC secret to forge identities.
        if alg is None:
            key_bytes = key if isinstance(key, (bytes, str)) else None
            if key_bytes is not None:
                kb = key_bytes if isinstance(key_bytes, bytes) else key_bytes.encode()
                alg = "RS256" if kb.lstrip().startswith(b"-----BEGIN") else "HS256"
            else:
                alg = "RS256"  # loaded public-key object
        self.alg = alg
        self.clock = clock or time.time

    def authenticate(self, headers) -> Optional[UserInfo]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer ") or auth.count(".") != 2:
            return None
        token = auth[7:]
        try:
            h64, p64, s64 = token.split(".")
            header = json.loads(_unb64(h64))
            claims = json.loads(_unb64(p64))
            sig = _unb64(s64)
            if not isinstance(header, dict) or not isinstance(claims, dict):
                return None
            # issuer gate FIRST: a token from another issuer is "not my
            # credential type" and must fall through in a union
            if claims.get("iss") != self.issuer:
                return None
            if header.get("alg") != self.alg:
                return None
            if not self._verify_sig(self.alg, f"{h64}.{p64}".encode(), sig):
                return None
            aud = claims.get("aud")
            if self.audience not in (aud if isinstance(aud, list) else [aud]):
                return None
            # exp is MANDATORY (OIDC Core requires it in ID tokens): a
            # token without one would be valid forever and can never be
            # invalidated
            if "exp" not in claims or float(claims["exp"]) <= self.clock():
                return None
            name = claims.get(self.username_claim, "")
            if not name:
                return None
            groups = claims.get(self.groups_claim) or []
            if isinstance(groups, str):
                groups = [groups]
            return UserInfo(name=self.username_prefix + str(name),
                            groups=[str(g) for g in groups])
        except Exception as e:  # noqa: BLE001
            # malformed claims must read as a bad credential (401), never
            # crash the request thread
            logger.debug("oidc: malformed token/claims (%s): rejected",
                         type(e).__name__)
            return None

    def _verify_sig(self, alg: str, signed: bytes, sig: bytes) -> bool:
        if alg == "HS256" and isinstance(self.key, (bytes, str)):
            key = self.key if isinstance(self.key, bytes) else self.key.encode()
            return hmac.compare_digest(
                sig, hmac.new(key, signed, hashlib.sha256).digest())
        if alg == "RS256":
            try:
                from cryptography.hazmat.primitives import hashes, serialization
                from cryptography.hazmat.primitives.asymmetric import padding

                key = self.key
                if isinstance(key, (bytes, str)):
                    pem = key if isinstance(key, bytes) else key.encode()
                    key = serialization.load_pem_public_key(pem)
                key.verify(sig, signed, padding.PKCS1v15(), hashes.SHA256())
                return True
            except Exception:
                return False
        return False


class UnionAuthenticator(Authenticator):
    """First authenticator that recognizes the credential wins (reference
    ``authentication/request/union``)."""

    def __init__(self, *authenticators: Authenticator, allow_anonymous: bool = True):
        self.authenticators = list(authenticators)
        self.allow_anonymous = allow_anonymous

    def authenticate(self, headers) -> Optional[UserInfo]:
        for a in self.authenticators:
            user = a.authenticate(headers)
            if user is not None:
                return user
        # A credential that is PRESENT but unrecognized fails with 401; it
        # must not be downgraded to anonymous (the reference rejects
        # malformed/unknown bearer tokens rather than treating the request
        # as unauthenticated).
        if headers.get("Authorization", ""):
            return None
        return ANONYMOUS if self.allow_anonymous else None


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


# the cluster's signing key: ONE definition — every node-scoped HMAC
# credential (exec, tunnel, SA tokens) defaults to it, so a configurable
# key can never drift between the minting sites
CLUSTER_SIGNING_KEY = b"cluster-signing-key"


def kubelet_exec_token(node_name: str, key: bytes = CLUSTER_SIGNING_KEY) -> str:
    """The control plane's credential for a node's exec endpoint: HMAC of
    the node name under the cluster signing key.  Only components holding
    the key (apiserver, kubectl pointed at the in-proc store) can mint it
    — reading node.status alone is not enough to run commands (the
    reference's kubelet delegated-authz contract, minimally)."""
    return hmac.new(key, f"kubelet-exec:{node_name}".encode(), hashlib.sha256).hexdigest()


class ServiceAccountTokenMinter:
    """Mints and verifies service-account bearer tokens (reference
    ``pkg/serviceaccount`` TokenGenerator; the controller writes them into
    token Secrets)."""

    def __init__(self, signing_key: bytes = CLUSTER_SIGNING_KEY):
        self.key = signing_key

    def mint(self, namespace: str, name: str) -> str:
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        payload = _b64(json.dumps({
            "sub": f"system:serviceaccount:{namespace}:{name}",
            "kubernetes.io/serviceaccount/namespace": namespace,
            "kubernetes.io/serviceaccount/service-account.name": name,
        }).encode())
        sig = _b64(hmac.new(self.key, f"{header}.{payload}".encode(), hashlib.sha256).digest())
        return f"{header}.{payload}.{sig}"

    def verify(self, token: str) -> Optional[tuple[str, str]]:
        try:
            header, payload, sig = token.split(".")
            expect = _b64(hmac.new(self.key, f"{header}.{payload}".encode(), hashlib.sha256).digest())
            if not hmac.compare_digest(sig, expect):
                return None
            claims = json.loads(_unb64(payload))
            return (
                claims["kubernetes.io/serviceaccount/namespace"],
                claims["kubernetes.io/serviceaccount/service-account.name"],
            )
        except (ValueError, KeyError):
            return None
