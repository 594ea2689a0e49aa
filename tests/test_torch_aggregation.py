"""Twins of ``tests/test_aggregation.py`` on the port's apiserver:
``/apis/<group>/...`` proxied to the backend an ``APIService`` names.

Each twin runs one scenario against the JAX apiserver and against the
port's, with the same sample aggregated server (the JAX test's
``SampleHandler``) behind each, and the status codes, bodies, forwarded
headers and APIService availability each side gives must be equal, and
equal to what the JAX test asserts.  Exact: no tolerance applies.
"""

from __future__ import annotations

import importlib
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

GROUP = "metrics.example.com"
PKG = {"port": "kubernetes_tpu_torch", "jax": "kubernetes_tpu"}


class SampleHandler(BaseHTTPRequestHandler):
    """A sample aggregated API server: serves its group's resources, echoes
    a POST with the headers it was given, and records each GET's identity
    headers in ``seen``."""

    seen: list = []

    def log_message(self, *a):
        pass

    def _send(self, code, obj):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self.seen.append((self.headers.get("X-Remote-User", ""),
                          self.headers.get("X-Remote-Group", ""),
                          self.headers.get("Authorization", "")))
        if self.path.startswith(f"/apis/{GROUP}/v1/nodemetrics"):
            self._send(200, {"items": [{"node": "n1", "cpu": "500m"}]})
        else:
            self._send(404, {"kind": "Status", "code": 404})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length)) if length else {}
        self._send(201, {"echo": body, "auth": self.headers.get("Authorization", ""),
                         "remoteUser": self.headers.get("X-Remote-User", "")})


class World:
    """One package's apiserver over its store, a clientset on the store,
    and a sample backend."""

    def __init__(self, which: str, tokens=None, rbac: bool = False):
        pkg = PKG[which]
        self.api = importlib.import_module(f"{pkg}.api")
        store = importlib.import_module(f"{pkg}.store").Store()
        self.cs = importlib.import_module(f"{pkg}.client").Clientset(store)
        auth = importlib.import_module(f"{pkg}.auth")
        kw = {}
        if tokens is not None:
            kw["authenticator"] = auth.UnionAuthenticator(auth.TokenFileAuthenticator(tokens),
                                                          allow_anonymous=False)
        if rbac:
            kw["authorizer"] = auth.RBACAuthorizer(store)
        self.server = importlib.import_module(f"{pkg}.apiserver").APIServer(store, **kw)
        self.server.start()
        self.handler = type("Sample", (SampleHandler,), {"seen": []})
        self.backend = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        threading.Thread(target=self.backend.serve_forever, daemon=True).start()
        self.backend_url = f"http://127.0.0.1:{self.backend.server_port}"

    def register(self, name: str, group: str = GROUP, url: str = None):
        self.cs.apiservices.create(self.api.APIService(
            meta=self.api.ObjectMeta(name=name), group=group, url=url or self.backend_url))

    def close(self):
        self.server.stop()
        self.backend.shutdown()
        self.backend.server_close()


def request(url: str, method: str = "GET", body=None, headers=()):
    """(status, decoded body) of one request, errors included."""
    req = urllib.request.Request(url, method=method,
                                 data=json.dumps(body).encode() if body is not None else None)
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        data = json.loads(e.read())
        return e.code, data.get("reason", data)


def both(scenario, **server_kw):
    """``scenario(world)`` against each package's apiserver; equal results."""
    out = []
    for which in ("jax", "port"):
        w = World(which, **server_kw)
        try:
            out.append(scenario(w))
        finally:
            w.close()
    assert out[1] == out[0]
    return out[1]


def test_apis_route_proxies_to_registered_backend():
    def scenario(w):
        w.register(GROUP)
        return request(f"{w.server.url}/apis/{GROUP}/v1/nodemetrics")

    code, got = both(scenario)
    assert code == 200 and got["items"][0]["node"] == "n1"


def test_post_bodies_pass_through_but_credentials_do_not():
    def scenario(w):
        w.register(GROUP)
        return request(f"{w.server.url}/apis/{GROUP}/v1/things", "POST", {"a": 1},
                       headers=(("Content-Type", "application/json"),
                                ("Authorization", "Bearer tok")))

    code, got = both(scenario)
    assert code == 201 and got["echo"] == {"a": 1}
    assert got["auth"] == ""  # the credential is stripped


def test_identity_crosses_as_front_proxy_headers():
    def scenario(w):
        w.register(GROUP)
        code, _ = request(f"{w.server.url}/apis/{GROUP}/v1/nodemetrics",
                          headers=(("Authorization", "Bearer tok123"),))
        refused = request(f"{w.server.url}/apis/{GROUP}/v1/nodemetrics")[0]
        return code, refused, list(w.handler.seen), w.cs.apiservices.get(GROUP).available

    code, refused, seen, available = both(scenario, tokens={"tok123": "alice"})
    assert code == 200 and refused == 401
    assert seen == [("alice", "", "")]
    assert available is True


def test_name_by_version_group_convention_resolves():
    def scenario(w):
        w.register(f"v1.{GROUP}")
        before = request(f"{w.server.url}/apis")[1]
        got = request(f"{w.server.url}/apis/{GROUP}/v1/nodemetrics")
        # discovery lists the group, available once a proxied request got
        # through
        return got, before, request(f"{w.server.url}/apis")[1]

    (code, got), before, after = both(scenario)
    assert code == 200 and got["items"][0]["node"] == "n1"
    assert before == {"kind": "APIGroupList", "groups": [{"name": GROUP, "available": False}]}
    assert after == {"kind": "APIGroupList", "groups": [{"name": GROUP, "available": True}]}


def test_unregistered_group_404s_and_dead_backend_502s():
    def scenario(w):
        out = [request(f"{w.server.url}/apis/nope.example.com/v1/x")[0]]
        w.register("dead.example.com", group="dead.example.com", url="http://127.0.0.1:1")
        out.append(request(f"{w.server.url}/apis/dead.example.com/v1/x")[0])
        out.append(w.cs.apiservices.get("dead.example.com").available)
        # the authorization group stays local: the SelfSubjectAccessReview
        # route answers before aggregation
        out.append(request(f"{w.server.url}/apis/authorization.k8s.io/v1/"
                           "selfsubjectaccessreviews", "POST",
                           {"spec": {"resourceAttributes": {"verb": "get"}}})[0])
        return out

    assert both(scenario) == [404, 502, False, 201]


def test_backend_error_codes_pass_through():
    def scenario(w):
        w.register(GROUP)
        return request(f"{w.server.url}/apis/{GROUP}/v1/unknown")

    code, body = both(scenario)
    assert code == 404 and body == {"kind": "Status", "code": 404}


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_an_aggregated_route_is_authorized_per_group(method):
    """The request info names an aggregated request's resource
    ``<group>/<resource>``: an RBAC grant on one group's resource lets its
    holder through, and no other."""

    def scenario(w):
        api = w.api
        w.cs.clusterroles.create(api.ClusterRole(
            meta=api.ObjectMeta(name="metrics-reader"),
            rules=[api.PolicyRule(verbs=["list", "create"],
                                  resources=[f"{GROUP}/nodemetrics"])]))
        w.cs.clusterrolebindings.create(api.ClusterRoleBinding(
            meta=api.ObjectMeta(name="bob-reads"),
            subjects=[api.Subject(kind="User", name="bob")], role_name="metrics-reader"))
        w.register(GROUP)
        body = {} if method == "POST" else None
        return [request(f"{w.server.url}/apis/{GROUP}/v1/{res}", method, body,
                        headers=(("Authorization", f"Bearer {tok}"),))[0]
                for tok, res in (("bob-token", "nodemetrics"), ("bob-token", "other"),
                                 ("eve-token", "nodemetrics"))]

    got = both(scenario, tokens={"bob-token": "bob", "eve-token": "eve"}, rbac=True)
    assert got == [200 if method == "GET" else 201, 403, 403]
