"""Twins of ``tests/test_auth.py`` on the port's ``auth`` package, its
``api.rbac`` kinds and its apiserver's filter chain.

Each twin runs one scenario through the JAX package and through the port
(``_both``): the same inputs, made from fixed values or a seed, and the
decisions, users, groups, audit records and HTTP status codes each side
gives must be equal, and equal to what the JAX test asserts.  Exact: no
tolerance applies.  The eviction (``:270``) and max-in-flight (``:755``)
twins came with those routes, with a case of the JAX test's own: refused
TLS handshakes hold no in-flight slot.

Where the JAX test mints certificates with ``openssl``, these use the
port's committed test PKI (``kubernetes_tpu_torch/testing/pki``) for both
packages; the PEM-header and RS256 twins need ``cryptography``, as the
JAX ones do."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import socket
import ssl
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from kubernetes_tpu_torch.testing import pki as fixture


def _pkg(which: str) -> types.SimpleNamespace:
    """The modules a scenario needs, from one package."""
    if which == "jax":
        from kubernetes_tpu import api, auth
        from kubernetes_tpu.apiserver.server import APIServer, TLSConfig
        from kubernetes_tpu.auth import audit
        from kubernetes_tpu.client.clientset import Clientset
        from kubernetes_tpu.client.remote import RemoteError, RemoteStore
        from kubernetes_tpu.store.store import Store
    else:
        from kubernetes_tpu_torch import api, auth
        from kubernetes_tpu_torch.apiserver.server import APIServer, TLSConfig
        from kubernetes_tpu_torch.auth import audit
        from kubernetes_tpu_torch.client.clientset import Clientset
        from kubernetes_tpu_torch.client.remote import RemoteError, RemoteStore
        from kubernetes_tpu_torch.store.store import Store
    return types.SimpleNamespace(api=api, auth=auth, audit=audit, APIServer=APIServer,
                                 TLSConfig=TLSConfig, Clientset=Clientset,
                                 RemoteStore=RemoteStore, RemoteError=RemoteError, Store=Store,
                                 name=which)


def _both(scenario):
    """Run ``scenario(pkg)`` on each package; they must agree.  Returns the
    shared result."""
    jax_out, port_out = scenario(_pkg("jax")), scenario(_pkg("port"))
    assert port_out == jax_out
    return port_out


def _user(u):
    return None if u is None else (u.name, list(u.groups))


def _code(url: str, token: str = None, method: str = "GET", body=None, headers=(),
          ctx=None) -> int:
    req = urllib.request.Request(url, method=method,
                                 data=json.dumps(body).encode() if body is not None else None,
                                 headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def _serving(m, store, **kw):
    server = m.APIServer(store, **kw)
    server.start()
    return server


# -- authenticators ---------------------------------------------------------


def test_token_file_authenticator():
    def scenario(m):
        a = m.auth.TokenFileAuthenticator({"s3cret": m.auth.UserInfo(name="alice",
                                                                     groups=["dev"])})
        return [_user(a.authenticate(h)) for h in (
            {"Authorization": "Bearer s3cret"}, {"Authorization": "Bearer wrong"}, {})]

    assert _both(scenario) == [("alice", ["dev"]), None, None]


def test_service_account_tokens():
    def scenario(m):
        minter = m.auth.ServiceAccountTokenMinter(b"key-1")
        tok = minter.mint("prod", "builder")
        a = m.auth.ServiceAccountTokenAuthenticator(minter)
        other = m.auth.ServiceAccountTokenMinter(b"key-2").mint("prod", "builder")
        h, p, s = tok.split(".")
        return [tok] + [_user(a.authenticate({"Authorization": f"Bearer {t}"}))
                        for t in (tok, other, f"{h}.{p}x.{s}")]

    out = _both(scenario)  # the same token, byte for byte
    assert out[1] == ("system:serviceaccount:prod:builder",
                      ["system:serviceaccounts", "system:serviceaccounts:prod"])
    assert out[2:] == [None, None]


def test_union_authenticator_and_anonymous():
    def scenario(m):
        tokens = m.auth.TokenFileAuthenticator({"t": "bob"})
        u = m.auth.UnionAuthenticator(tokens, m.auth.RequestHeaderAuthenticator())
        strict = m.auth.UnionAuthenticator(tokens, allow_anonymous=False)
        return [_user(u.authenticate({"Authorization": "Bearer t"})),
                _user(u.authenticate({"X-Remote-User": "carol", "X-Remote-Group": "ops,dev"})),
                u.authenticate({}) is m.auth.ANONYMOUS, _user(strict.authenticate({}))]

    assert _both(scenario) == [("bob", []), ("carol", ["ops", "dev"]), True, None]


def test_present_but_invalid_bearer_is_401_even_with_anonymous():
    def scenario(m):
        lax = m.auth.UnionAuthenticator(m.auth.TokenFileAuthenticator({"good": "alice"}),
                                        allow_anonymous=True)
        return [_user(lax.authenticate({"Authorization": "Bearer good"})),
                lax.authenticate({}) is m.auth.ANONYMOUS,
                _user(lax.authenticate({"Authorization": "Bearer WRONG"})),
                _user(lax.authenticate({"Authorization": "Basic dXNlcjpwdw=="}))]

    assert _both(scenario) == [("alice", []), True, None, None]


# -- RBAC -------------------------------------------------------------------


def _rbac_cluster(m):
    api = m.api
    cs = m.Clientset(m.Store())
    cs.clusterroles.create(api.ClusterRole(
        meta=api.ObjectMeta(name="pod-reader"),
        rules=[api.PolicyRule(verbs=["get", "list", "watch"], resources=["pods"])]))
    cs.clusterrolebindings.create(api.ClusterRoleBinding(
        meta=api.ObjectMeta(name="devs-read-pods"),
        subjects=[api.Subject(kind="Group", name="dev")], role_name="pod-reader"))
    cs.roles.create(api.Role(
        meta=api.ObjectMeta(name="deployer", namespace="prod"),
        rules=[api.PolicyRule(verbs=["*"], resources=["deployments", "replicasets"])]))
    cs.rolebindings.create(api.RoleBinding(
        meta=api.ObjectMeta(name="alice-deploys", namespace="prod"),
        subjects=[api.Subject(kind="User", name="alice")], role_kind="Role",
        role_name="deployer"))
    return cs


def test_rbac_cluster_and_namespaced():
    def scenario(m):
        cs = _rbac_cluster(m)
        authz = m.auth.RBACAuthorizer(cs.store)
        A, U = m.auth.AuthzAttributes, m.auth.UserInfo
        dev, alice = U(name="bob", groups=["dev"]), U(name="alice")
        stored = [cs.store.get("ClusterRoleBinding", "", "devs-read-pods")["roleRef"],
                  cs.store.get("Role", "prod", "deployer")["rules"]]
        return stored + [authz.authorize(a) for a in (
            A(dev, "get", "pods", "anyns"), A(dev, "delete", "pods", "anyns"),
            A(alice, "update", "deployments", "prod"), A(alice, "update", "deployments", "dev"),
            A(alice, "update", "pods", "prod"))]

    out = _both(scenario)
    assert [d for d, _ in out[2:]] == ["allow", "no-opinion", "allow", "no-opinion",
                                       "no-opinion"]


def test_rbac_serviceaccount_subject():
    def scenario(m):
        cs = _rbac_cluster(m)
        cs.rolebindings.create(m.api.RoleBinding(
            meta=m.api.ObjectMeta(name="sa-deploys", namespace="prod"),
            subjects=[m.api.Subject(kind="ServiceAccount", name="ci", namespace="prod")],
            role_kind="Role", role_name="deployer"))
        sa = m.auth.UserInfo(name="system:serviceaccount:prod:ci",
                             groups=["system:serviceaccounts"])
        return m.auth.RBACAuthorizer(cs.store).authorize(
            m.auth.AuthzAttributes(sa, "create", "replicasets", "prod"))

    assert _both(scenario)[0] == "allow"


def test_node_authorizer_scopes_to_own_node():
    def scenario(m):
        store = m.Store()
        store.create("Pod", {"kind": "Pod", "metadata": {"name": "p1", "namespace": "default"},
                             "spec": {"nodeName": "node-1"}})
        authz = m.auth.NodeAuthorizer(store)
        A, U = m.auth.AuthzAttributes, m.auth.UserInfo
        n1 = U(name="system:node:node-1", groups=["system:nodes"])
        n2 = U(name="system:node:node-2", groups=["system:nodes"])
        out = [authz.authorize(a)[0] for a in (
            A(n1, "get", "nodes", "", "node-1"), A(n1, "get", "nodes", "", "node-2"),
            A(n1, "update", "pods", "default", "p1"), A(n2, "update", "pods", "default", "p1"),
            A(U(name="alice"), "get", "pods", "default", "p1"))]
        out.append(m.auth.UnionAuthorizer(authz).authorize(
            A(n2, "update", "pods", "default", "p1"))[0])
        return out

    assert _both(scenario) == ["allow", "no-opinion", "allow", "no-opinion", "no-opinion",
                               "deny"]


def test_abac_and_union():
    def scenario(m):
        abac = m.auth.ABACAuthorizer([
            {"user": "viewer", "resource": "*", "readonly": True},
            {"group": "admins", "resource": "*", "verb": "*"}])
        A, U = m.auth.AuthzAttributes, m.auth.UserInfo
        viewer = U(name="viewer")
        union = m.auth.UnionAuthorizer(m.auth.BootstrapPolicyAuthorizer(), abac)
        return [abac.authorize(A(viewer, "list", "pods", "")),
                abac.authorize(A(viewer, "delete", "pods", "")),
                union.authorize(A(U(name="root", groups=["system:masters"]), "delete",
                                  "nodes", "")),
                union.authorize(A(U(name="nobody"), "get", "pods", ""))]

    assert [d for d, _ in _both(scenario)] == ["allow", "no-opinion", "allow", "deny"]


# -- audit ------------------------------------------------------------------


def test_audit_policy_levels():
    def scenario(m):
        auditor = m.auth.Auditor(policy=m.auth.AuditPolicy(rules=[
            m.auth.AuditPolicyRule(level="None", resources=["events"]),
            m.auth.AuditPolicyRule(level="Request", verbs=["create"])]))
        auditor.record("ResponseComplete", "alice", "create", "pods", "default", "p",
                       code=201, request_object={"kind": "Pod"})
        auditor.record("ResponseComplete", "alice", "get", "events", "default", "e")
        auditor.record("ResponseComplete", "alice", "get", "pods", "default", "p", code=200)
        return [{k: v for k, v in e.to_dict().items() if k != "timestamp"}
                for e in auditor.memory.events]

    out = _both(scenario)
    assert len(out) == 2 and out[0]["requestObject"] == {"kind": "Pod"}
    assert "requestObject" not in out[1]


def test_audit_webhook_backend_batches_and_sheds():
    def scenario(m):
        received = []

        class Sink(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                received.extend(body["items"])
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        httpd = HTTPServer(("127.0.0.1", 0), Sink)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            backend = m.auth.WebhookBackend(f"http://127.0.0.1:{httpd.server_port}/",
                                            flush_interval=0.1)
            auditor = m.auth.Auditor(backends=[backend])
            for i in range(25):
                auditor.record("ResponseComplete", "alice", "get", "pods", "default", f"p{i}",
                               code=200)
            deadline = time.time() + 5
            while len(received) < 25 and time.time() < deadline:
                time.sleep(0.05)
            backend.stop()
        finally:
            httpd.shutdown()
        dead = m.auth.WebhookBackend("http://127.0.0.1:1/", flush_interval=0.05,
                                     max_buffer=5, timeout=0.1)
        auditor2 = m.auth.Auditor(backends=[dead])
        t0 = time.time()
        for i in range(200):
            auditor2.record("ResponseComplete", "bob", "get", "pods", "d", f"x{i}")
        fast = time.time() - t0 < 1.0  # audit never blocks the request path
        dead.stop()
        return [sorted((r["user"], r["name"]) for r in received), fast, dead.dropped > 0]

    out = _both(scenario)
    assert len(out[0]) == 25 and out[0][0][0] == "alice" and out[1:] == [True, True]


# -- the apiserver's filter chain over the wire -----------------------------


def _codes_full_stack(m):
    api = m.api
    cs = m.Clientset(m.Store())
    cs.clusterroles.create(api.ClusterRole(
        meta=api.ObjectMeta(name="reader"),
        rules=[api.PolicyRule(verbs=["get", "list", "watch"], resources=["*"])]))
    cs.clusterrolebindings.create(api.ClusterRoleBinding(
        meta=api.ObjectMeta(name="alice-reads"),
        subjects=[api.Subject(kind="User", name="alice")], role_name="reader"))
    auditor = m.auth.Auditor()
    server = _serving(
        m, cs.store,
        authenticator=m.auth.UnionAuthenticator(
            m.auth.TokenFileAuthenticator({"alice-token": "alice", "root-token": m.auth.UserInfo(
                name="root", groups=["system:masters"])}), allow_anonymous=False),
        authorizer=m.auth.UnionAuthorizer(m.auth.BootstrapPolicyAuthorizer(),
                                          m.auth.RBACAuthorizer(cs.store)),
        auditor=auditor)
    pod = {"kind": "Pod", "metadata": {"name": "p"}}
    try:
        out = []
        for store in (m.RemoteStore(server.url), m.RemoteStore(server.url, token="alice-token")):
            try:
                store.list("Pod")
                out.append("listed")
            except m.RemoteError:
                out.append("refused")
        alice = m.RemoteStore(server.url, token="alice-token")
        with pytest.raises(m.RemoteError):
            alice.create("Pod", pod)
        m.RemoteStore(server.url, token="root-token").create("Pod", pod)
        out.append([_code(server.url + "/api/v1/pods", t) for t in (None, "alice-token",
                                                                     "root-token", "bad")])
    finally:
        server.stop()
    # sorted: a request's ResponseComplete is recorded after its response
    # is written, so the next request (a new connection, on a thread of its
    # own) may record its RequestReceived first
    records = sorted((e.stage, e.user, e.verb, e.resource, e.namespace, e.name, e.code)
                     for e in auditor.memory.events)
    return out, records


def test_apiserver_full_auth_stack():
    out, records = _both(_codes_full_stack)
    assert out == ["refused", "listed", [401, 200, 200, 401]]
    assert ("ResponseComplete", "alice", "create", "pods", "", "", 403) in records
    assert ("ResponseComplete", "root", "create", "pods", "", "", 201) in records


def test_apiserver_namespaced_rolebinding_authorizes_create():
    def scenario(m):
        api = m.api
        cs = m.Clientset(m.Store())
        cs.roles.create(api.Role(meta=api.ObjectMeta(name="writer", namespace="prod"),
                                 rules=[api.PolicyRule(verbs=["create"], resources=["pods"])]))
        cs.rolebindings.create(api.RoleBinding(
            meta=api.ObjectMeta(name="bob-writes", namespace="prod"),
            subjects=[api.Subject(kind="User", name="bob")], role_kind="Role",
            role_name="writer"))
        server = _serving(m, cs.store, authenticator=m.auth.UnionAuthenticator(
            m.auth.TokenFileAuthenticator({"bob-token": "bob"}), allow_anonymous=False),
            authorizer=m.auth.RBACAuthorizer(cs.store))
        try:
            return [_code(server.url + "/api/v1/pods", "bob-token", "POST",
                          {"kind": "Pod", "metadata": {"name": n, "namespace": ns}})
                    for n, ns in (("p", "prod"), ("p2", "dev"))]
        finally:
            server.stop()

    assert _both(scenario) == [201, 403]


def test_impersonation_filter():
    def scenario(m):
        api = m.api
        store = m.Store()
        for role, verbs, resources, user in (("impersonator", ["impersonate"], ["users"], "admin"),
                                             ("pod-reader", ["list"], ["pods"], "alice")):
            store.create("ClusterRole", api.ClusterRole(
                meta=api.ObjectMeta(name=role),
                rules=[api.PolicyRule(verbs=verbs, resources=resources)]).to_dict())
            store.create("ClusterRoleBinding", api.ClusterRoleBinding(
                meta=api.ObjectMeta(name=f"{user}-{role}"), role_name=role,
                subjects=[api.Subject(kind="User", name=user)]).to_dict())
        auditor = m.auth.Auditor()
        server = _serving(m, store, authenticator=m.auth.UnionAuthenticator(
            m.auth.TokenFileAuthenticator({"t-admin": "admin", "t-bob": "bob"}),
            allow_anonymous=False), authorizer=m.auth.RBACAuthorizer(store), auditor=auditor)
        url = f"{server.url}/api/v1/pods"
        try:
            codes = [_code(url, "t-admin", headers=[("Impersonate-User", "alice")]),
                     _code(url, "t-admin"),
                     _code(url, "t-bob", headers=[("Impersonate-User", "alice")]),
                     _code(url, "t-admin", headers=[("Impersonate-User", "alice"),
                                                    ("Impersonate-Group", "system:masters")])]
        finally:
            server.stop()
        users = [e.user for e in auditor.memory.events if e.stage == "ResponseComplete"]
        return codes, users

    codes, users = _both(scenario)
    assert codes == [200, 403, 403, 403]
    assert users[0] == "alice (impersonated-by admin)"


def _x509_over_tls(m):
    api = m.api
    store = m.Store()
    store.create("ClusterRole", api.ClusterRole(
        meta=api.ObjectMeta(name="reader"),
        rules=[api.PolicyRule(verbs=["get", "list"], resources=["nodes"])]).to_dict())
    store.create("ClusterRoleBinding", api.ClusterRoleBinding(
        meta=api.ObjectMeta(name="masters-read"), role_name="reader",
        subjects=[api.Subject(kind="Group", name="system:masters")]).to_dict())
    auditor = m.auth.Auditor()
    server = _serving(m, store, authenticator=m.auth.UnionAuthenticator(
        m.auth.TokenFileAuthenticator({}), allow_anonymous=False),
        authorizer=m.auth.RBACAuthorizer(store), auditor=auditor,
        tls=m.TLSConfig(*fixture.pair("apiserver"), client_ca=fixture.path("ca.crt")))
    ca = fixture.path("ca.crt")
    out = [server.url.split(":")[0]]
    try:
        for who in ("admin", "outsider", None):
            rs = m.RemoteStore(server.url, ca_file=ca,
                               **({"client_cert": fixture.path(f"{who}.crt"),
                                   "client_key": fixture.path(f"{who}.key")} if who else {}))
            for op in (lambda: rs.list("Node", None), lambda: rs.delete("Node", "", "ghost")):
                try:
                    op()
                    out.append("ok")
                except Exception as e:  # noqa: BLE001 - the status is the result
                    out.append(str(e).split(":")[0][:3] if type(e).__name__ == "RemoteError"
                               else type(e).__name__)
    finally:
        server.stop()
    out.append(sorted({(e.user, e.code) for e in auditor.memory.events
                       if e.stage == "ResponseComplete"}))
    return out


def test_x509_over_real_tls():
    """The handshake verifies the client chain; the subject (CN
    ``kubernetes-admin``, O ``system:masters``) is the identity and flows
    through RBAC."""
    out = _both(_x509_over_tls)
    assert out[0] == "https"
    assert out[1:7] == ["ok", "ForbiddenError", "ForbiddenError", "ForbiddenError", "401",
                        "401"]
    assert out[7] == [("", 401), ("kubernetes-admin", 200), ("kubernetes-admin", 403),
                      ("outsider", 403)]


def test_x509_pem_header_path():
    pytest.importorskip("cryptography")  # the PEM path verifies with it in both packages

    def b64(p):
        return base64.urlsafe_b64encode(open(p, "rb").read()).decode()

    def scenario(m):
        ca_pem = open(fixture.path("ca.crt"), "rb").read()
        authn = m.auth.X509CertificateAuthenticator(ca_pem=ca_pem, proxy_secret="proxy-pw")
        hdrs = {"X-Client-Certificate": b64(fixture.path("admin.crt")),
                "X-Proxy-Authorization": "proxy-pw"}
        no_proxy = m.auth.X509CertificateAuthenticator(ca_pem=ca_pem)
        future = m.auth.X509CertificateAuthenticator(ca_pem=ca_pem, proxy_secret="proxy-pw",
                                                     clock=lambda: 4102444800.0)  # 2100
        return [_user(a.authenticate(h)) for a, h in (
            (authn, hdrs), (authn, {"X-Client-Certificate": hdrs["X-Client-Certificate"]}),
            (authn, {**hdrs, "X-Proxy-Authorization": "wrong"}), (no_proxy, hdrs),
            (authn, {**hdrs, "X-Client-Certificate": b64(fixture.path("other/client.crt"))}),
            (future, hdrs), (authn, {**hdrs, "X-Client-Certificate": "!!!"}))]

    out = _both(scenario)
    assert out == [("kubernetes-admin", ["system:masters"])] + [None] * 6


# -- webhook and OIDC token authenticators ----------------------------------


def _hook_server(answer):
    calls = []

    class Hook(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            calls.append(body["spec"]["token"])
            code, out = answer(body["spec"]["token"])
            data = json.dumps(out).encode() if out is not None else b""
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, calls


def test_webhook_token_authenticator_and_cache():
    def answer(token):
        if token == "good":
            return 200, {"status": {"authenticated": True,
                                    "user": {"username": "webhook-user", "groups": ["g1"]}}}
        return 200, {"status": {"authenticated": False}}

    def scenario(m):
        httpd, calls = _hook_server(answer)
        try:
            authn = m.auth.WebhookTokenAuthenticator(f"http://127.0.0.1:{httpd.server_port}/")
            out = [_user(authn.authenticate({"Authorization": f"Bearer {t}"}))
                   for t in ("good", "bad", "good", "bad")]
            out += [_user(authn.authenticate({})), list(calls)]
        finally:
            httpd.shutdown()
        dead = m.auth.WebhookTokenAuthenticator("http://127.0.0.1:1/", timeout=0.2)
        return out + [_user(dead.authenticate({"Authorization": "Bearer good"}))]

    assert _both(scenario) == [("webhook-user", ["g1"]), None, ("webhook-user", ["g1"]), None,
                               None, ["good", "bad"], None]


def test_webhook_cache_is_bounded():
    def scenario(m):
        authn = m.auth.WebhookTokenAuthenticator("http://127.0.0.1:1/", timeout=0.05)
        authn.CACHE_MAX = 10
        authn._review = lambda token: None  # a real (negative) verdict
        for i in range(50):
            authn.authenticate({"Authorization": f"Bearer junk-{i}"})
        return sorted(authn._cache)

    out = _both(scenario)
    assert len(out) <= 10


def test_webhook_transport_errors_are_not_cached():
    def scenario(m):
        authn = m.auth.WebhookTokenAuthenticator("http://127.0.0.1:1/", timeout=0.05)
        out = [_user(authn.authenticate({"Authorization": "Bearer tok"})), dict(authn._cache)]
        authn._review = lambda token: m.auth.UserInfo(name="late-but-valid")
        return out + [_user(authn.authenticate({"Authorization": "Bearer tok"}))]

    assert _both(scenario) == [None, {}, ("late-but-valid", [])]


def test_webhook_5xx_is_not_cached_as_verdict():
    mode = {"broken": True}

    def answer(token):
        if mode["broken"]:
            return 503, None
        return 200, {"status": {"authenticated": True, "user": {"username": "u1"}}}

    def scenario(m):
        mode["broken"] = True
        httpd, _ = _hook_server(answer)
        try:
            authn = m.auth.WebhookTokenAuthenticator(f"http://127.0.0.1:{httpd.server_port}/")
            out = [_user(authn.authenticate({"Authorization": "Bearer tok"})),
                   dict(authn._cache)]
            mode["broken"] = False
            return out + [_user(authn.authenticate({"Authorization": "Bearer tok"}))]
        finally:
            httpd.shutdown()

    assert _both(scenario) == [None, {}, ("u1", [])]


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _hs256_jwt(claims, key=b"oidc-secret", header=None) -> str:
    h = _b64(json.dumps(header or {"alg": "HS256", "typ": "JWT"}).encode())
    p = _b64(json.dumps(claims).encode())
    s = _b64(hmac.new(key, f"{h}.{p}".encode(), hashlib.sha256).digest())
    return f"{h}.{p}.{s}"


def test_oidc_authenticator_hs256():
    good = _hs256_jwt({"iss": "https://issuer.example", "aud": "kube",
                       "email": "bob@example.com", "groups": ["dev", "ops"], "exp": 2000})
    tokens = [good,
              _hs256_jwt({"iss": "https://other", "aud": "kube", "email": "x"}),
              _hs256_jwt({"iss": "https://issuer.example", "aud": "nope", "email": "x",
                          "exp": 2000}),
              _hs256_jwt({"iss": "https://issuer.example", "aud": "kube", "email": "x",
                          "exp": 500}),
              good[:-4] + "AAAA"]

    def scenario(m):
        authn = m.auth.OIDCAuthenticator(
            issuer="https://issuer.example", audience="kube", key=b"oidc-secret",
            username_claim="email", groups_claim="groups", username_prefix="oidc:",
            clock=lambda: 1000.0)
        return [_user(authn.authenticate({"Authorization": f"Bearer {t}"})) for t in tokens]

    assert _both(scenario) == [("oidc:bob@example.com", ["dev", "ops"])] + [None] * 4


def _rsa_keys():
    pytest.importorskip("cryptography")  # RS256 verifies with it in both packages
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_bytes(serialization.Encoding.PEM,
                                        serialization.PublicFormat.SubjectPublicKeyInfo)
    return key, pub


def test_oidc_authenticator_rs256():
    from_keys = _rsa_keys()
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    key, pub = from_keys
    h = _b64(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    p = _b64(json.dumps({"iss": "iss", "aud": "kube", "sub": "carol", "exp": 2000}).encode())
    signed = f"{h}.{p}".encode()
    other = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    tokens = [f"{h}.{p}.{_b64(k.sign(signed, padding.PKCS1v15(), hashes.SHA256()))}"
              for k in (key, other)]

    def scenario(m):
        authn = m.auth.OIDCAuthenticator(issuer="iss", audience="kube", key=pub,
                                         clock=lambda: 1000.0)
        return [authn.alg] + [_user(authn.authenticate({"Authorization": f"Bearer {t}"}))
                              for t in tokens]

    assert _both(scenario) == ["RS256", ("carol", []), None]


def test_oidc_rejects_algorithm_confusion():
    _, pub = _rsa_keys()
    forged = _hs256_jwt({"iss": "iss", "aud": "kube", "sub": "attacker", "exp": 2000}, key=pub)

    def scenario(m):
        authn = m.auth.OIDCAuthenticator(issuer="iss", audience="kube", key=pub,
                                         clock=lambda: 1000.0)
        return [authn.alg, _user(authn.authenticate({"Authorization": f"Bearer {forged}"}))]

    assert _both(scenario) == ["RS256", None]


def test_oidc_malformed_claims_do_not_crash():
    tokens = [f"{_b64(b'{}')}.{_b64(b'[]')}.{_b64(b'sig')}",
              _hs256_jwt({"iss": "iss", "aud": "kube", "sub": "x", "exp": "abc"}, key=b"k"),
              f"{_b64(b'[]')}.{_b64(json.dumps({'iss': 'iss'}).encode())}.{_b64(b's')}"]

    def scenario(m):
        authn = m.auth.OIDCAuthenticator(issuer="iss", audience="kube", key=b"k",
                                         clock=lambda: 1000.0)
        return [_user(authn.authenticate({"Authorization": f"Bearer {t}"})) for t in tokens]

    assert _both(scenario) == [None, None, None]


def test_oidc_requires_exp_claim():
    immortal = _hs256_jwt({"iss": "iss", "aud": "kube", "sub": "x"}, key=b"k")
    mortal = _hs256_jwt({"iss": "iss", "aud": "kube", "sub": "x", "exp": 2000}, key=b"k")

    def scenario(m):
        authn = m.auth.OIDCAuthenticator(issuer="iss", audience="kube", key=b"k",
                                         clock=lambda: 1000.0)
        return [_user(authn.authenticate({"Authorization": f"Bearer {t}"}))
                for t in (immortal, mortal)]

    assert _both(scenario) == [None, ("x", [])]


# -- eviction and max-in-flight (tests/test_auth.py :270, :755) --------------


def test_eviction_requires_evict_verb_not_create():
    """``POST pods/{name}/eviction`` is the verb ``evict``: create rights on
    pods do not let a user evict (delete) a pod."""

    def scenario(m):
        api = m.api
        cs = m.Clientset(m.Store())
        cs.pods.create(api.Pod(meta=api.ObjectMeta(name="victim", namespace="prod")))
        for role, verb in (("creator", "create"), ("evictor", "evict")):
            cs.roles.create(api.Role(meta=api.ObjectMeta(name=role, namespace="prod"),
                                     rules=[api.PolicyRule(verbs=[verb], resources=["pods"])]))
        for binding, user, role in (("carol-creates", "carol", "creator"),
                                    ("dave-evicts", "dave", "evictor")):
            cs.rolebindings.create(api.RoleBinding(
                meta=api.ObjectMeta(name=binding, namespace="prod"),
                subjects=[api.Subject(kind="User", name=user)], role_kind="Role",
                role_name=role))
        auditor = m.auth.Auditor()
        server = _serving(m, cs.store, authenticator=m.auth.UnionAuthenticator(
            m.auth.TokenFileAuthenticator({"carol-token": "carol", "dave-token": "dave"}),
            allow_anonymous=False), authorizer=m.auth.RBACAuthorizer(cs.store),
            auditor=auditor)
        try:
            url = server.url + "/api/v1/namespaces/prod/pods/victim/eviction"
            codes = [_code(url, tok, "POST", {}) for tok in ("carol-token", "dave-token")]
        finally:
            server.stop()
        try:
            cs.store.get("Pod", "prod", "victim")
            gone = False
        except KeyError:
            gone = True
        return codes, gone, sorted({(e.user, e.verb, e.resource, e.code)
                                    for e in auditor.memory.events
                                    if e.stage == "ResponseComplete"})

    codes, gone, records = _both(scenario)
    assert codes == [403, 201] and gone
    assert records == [("carol", "evict", "pods", 403), ("dave", "evict", "pods", 201)]


def _max_in_flight(m):
    server = _serving(m, m.Store(), max_in_flight=2)
    out = []
    try:
        # exhaust the slots through the filter's own semaphore
        assert server._inflight.acquire(blocking=False)
        assert server._inflight.acquire(blocking=False)
        out.append(_code(f"{server.url}/api/v1/pods"))
        # a watch still flows while the cap is exhausted
        with urllib.request.urlopen(f"{server.url}/api/v1/pods?watch=true&timeoutSeconds=1",
                                    timeout=10) as r:
            out.append(r.status)
            r.read()
        # only the parsed query exempts: a watch=true inside another
        # parameter's value does not
        out.append(_code(f"{server.url}/api/v1/pods?foo=watch%3Dtrue"))
        server._inflight.release()
        server._inflight.release()
        out.append(_code(f"{server.url}/api/v1/pods"))
        # every answered request gave its slot back (a handler releases its
        # slot after it has written the response, so wait for the two)
        out.append([server._inflight.acquire(timeout=10) for _ in range(2)]
                   + [server._inflight.acquire(blocking=False)])
    finally:
        server.stop()
    return out


def test_max_in_flight_sheds_load_but_exempts_watches():
    assert _both(_max_in_flight) == [429, 200, 429, 200, [True, True, False]]


def _refused_handshakes_hold_no_slot(m):
    """A TLS server with one in-flight slot: clients whose certificates the
    handshake refuses, and clients that hang up mid-handshake, leave the
    slot free; a kept-alive connection's requests each take and return it."""
    server = _serving(m, m.Store(), max_in_flight=1, authenticator=m.auth.UnionAuthenticator(
        m.auth.TokenFileAuthenticator({}), allow_anonymous=False),
        tls=m.TLSConfig(*fixture.pair("apiserver"), client_ca=fixture.path("ca.crt")))
    out = []
    try:
        bad = ssl.create_default_context(cafile=fixture.path("ca.crt"))
        bad.check_hostname = False
        bad.load_cert_chain(fixture.path("other/client.crt"), fixture.path("other/client.key"))
        for _ in range(4):
            try:
                with urllib.request.urlopen(server.url + "/api/v1/pods", timeout=10,
                                            context=bad) as r:
                    out.append(r.status)
            except urllib.error.HTTPError as e:
                out.append(e.code)
            except (urllib.error.URLError, ssl.SSLError, ConnectionError):
                out.append("refused")
        for _ in range(3):  # connect and close without a hello
            socket.create_connection(("127.0.0.1", server.port), timeout=5).close()
        good = ssl.create_default_context(cafile=fixture.path("ca.crt"))
        good.check_hostname = False
        good.load_cert_chain(*fixture.pair("admin"))
        for _ in range(3):
            with urllib.request.urlopen(server.url + "/api/v1/pods", timeout=10,
                                        context=good) as r:
                out.append(r.status)
        deadline = time.monotonic() + 5
        while not server._inflight.acquire(blocking=False):
            assert time.monotonic() < deadline, "the slot was never returned"
            time.sleep(0.01)
        server._inflight.release()
        out.append("free")
    finally:
        server.stop()
    return out


def test_a_refused_tls_handshake_returns_its_in_flight_slot():
    assert _both(_refused_handshakes_hold_no_slot) == ["refused"] * 4 + [200] * 3 + ["free"]
