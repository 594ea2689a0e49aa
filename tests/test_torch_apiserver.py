"""The port's apiserver core and wire client (``kubernetes_tpu_torch.
apiserver`` + ``client/remote.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_apiserver.py`` (the kubelet field selector waits
for the kubelet's port) with PATCH, OpenAPI (the schema of every kind and
the operations of every path, federation's Cluster kind included: each
package's apiserver registers it) and a kind registered late, plus a 410 on a
compacted watch that ends in an informer relist, and TLS both ways
between the packages: each package's client, with the test PKI's client
certificate, against each package's TLS apiserver with a client CA (a
list, a watch that resumes after the server ends its stream, a
``bindings:batch``; the server's audit names the certificate's user).  Every case is one test
parametrised over the four client x server pairings: port/port, the port
client on the JAX server, the JAX client on the port server, and JAX/JAX.
Each pairing's record must equal the JAX/JAX record with ``uid``,
``creationTimestamp`` and ``resourceVersion`` masked.
"""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

PKG = {"port": "kubernetes_tpu_torch", "jax": "kubernetes_tpu"}
PAIRINGS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
MASKED = ("uid", "creationTimestamp", "resourceVersion")


class Pair:
    """One apiserver of ``server``'s package and a clientset of
    ``client``'s package over the wire to it."""

    def __init__(self, client: str, server: str, admitted: bool = False, **store_kw):
        self.client_pkg = client
        srv = importlib.import_module(f"{PKG[server]}.apiserver")
        store = importlib.import_module(f"{PKG[server]}.store")
        if admitted:  # the apiserver as its entry point starts it
            adm = importlib.import_module(f"{PKG[server]}.admission")
            backing = adm.AdmittedStore(adm.default_chain(), **store_kw)
        else:
            backing = store.Store(**store_kw)
        self.server = srv.APIServer(backing)
        self.server.start()
        self.url = self.server.url
        self.remote = importlib.import_module(f"{PKG[client]}.client.remote")
        self.rs = self.remote.RemoteStore(self.url)
        self.cs = importlib.import_module(f"{PKG[client]}.client").Clientset(self.rs)
        self.tu = importlib.import_module(f"{PKG[client]}.testutil")
        self.api = importlib.import_module(f"{PKG[client]}.api")
        self.errors = importlib.import_module(f"{PKG[client]}.store")
        self.informer_mod = importlib.import_module(f"{PKG[client]}.client.informer")

    def close(self) -> None:
        self.server.stop()


def mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in MASKED else mask(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    return obj


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def http_error(req) -> tuple[int, dict]:
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    return ei.value.code, json.loads(ei.value.read())


def run(scenario, client: str, server: str, **store_kw):
    pair = Pair(client, server, **store_kw)
    try:
        return mask(scenario(pair))
    finally:
        pair.close()


_REFERENCE: dict = {}


def check(scenario, pairing, **store_kw):
    """The pairing's record equals the JAX/JAX record (computed once per
    scenario)."""
    got = run(scenario, *pairing, **store_kw)
    if scenario not in _REFERENCE:
        _REFERENCE[scenario] = (got if tuple(pairing) == ("jax", "jax")
                                else run(scenario, "jax", "jax", **store_kw))
    assert got == _REFERENCE[scenario]
    return got


# -- scenarios (tests/test_apiserver.py) -------------------------------------


def healthz_metrics_version(p: Pair):
    _, health = get_json(p.url + "/healthz")
    _, version = get_json(p.url + "/version")
    with urllib.request.urlopen(p.url + "/metrics", timeout=10) as r:
        metrics = r.read().decode()
    _, apis = get_json(p.url + "/api")
    return {"healthz": health, "version_keys": sorted(version),
            "request_count": "apiserver_request_count" in metrics, "api": apis}


def remote_crud(p: Pair):
    created = p.cs.pods.create(p.tu.make_pod("p1", cpu="1"))
    got = p.cs.pods.get("p1")
    assert got.meta.uid
    pods, rev = p.cs.pods.list()
    deleted = p.cs.pods.delete("p1")
    with pytest.raises(p.errors.NotFoundError):
        p.cs.pods.get("p1")
    return {"created": created.to_dict(), "got": got.to_dict(),
            "listed": [x.meta.name for x in pods], "rev_positive": rev >= 1,
            "deleted": deleted.to_dict()}


def cluster_scoped_node(p: Pair):
    p.cs.nodes.create(p.tu.make_node("n1"))
    _, raw = get_json(p.url + "/api/v1/namespaces/-/nodes/n1")
    return {"typed": p.cs.nodes.get("n1").to_dict(), "wire": raw,
            "listed": [n.meta.key for n in p.cs.nodes.list()[0]]}


def cas_conflict(p: Pair):
    p.cs.pods.create(p.tu.make_pod("p1"))
    a = p.cs.pods.get("p1")
    b = p.cs.pods.get("p1")
    a.meta.annotations["x"] = "1"
    p.cs.pods.update(a)
    b.meta.annotations["x"] = "2"
    with pytest.raises(p.errors.ConflictError):
        p.cs.pods.update(b)
    return p.cs.pods.get("p1").to_dict()


def bind_and_batch(p: Pair):
    Binding = p.api.Binding
    for i in range(3):
        p.cs.pods.create(p.tu.make_pod(f"p{i}"))
    p.cs.pods.bind(Binding(pod_name="p0", node_name="n1"))
    errs = p.cs.pods.bind_many([Binding(pod_name="p1", node_name="n1"),
                                Binding(pod_name="p2", node_name="n2"),
                                Binding(pod_name="p0", node_name="n2"),
                                Binding(pod_name="ghost", node_name="n1")])
    # the Binding subresource answers every client the same way
    body = json.dumps({"nodeName": "n9"}).encode()
    code, status = http_error(urllib.request.Request(
        p.url + "/api/v1/namespaces/default/pods/p0/binding", data=body, method="POST",
        headers={"Content-Type": "application/json"}))
    return {"errors": errs, "nodes": {x.meta.name: x.spec.node_name for x in p.cs.pods.list()[0]},
            "subresource": (code, status)}


def watch_stream(p: Pair):
    _, rev = p.cs.pods.list()
    w = p.cs.pods.watch(from_revision=rev)
    try:
        p.cs.pods.create(p.tu.make_pod("w1"))
        p.cs.pods.delete("w1")
        evs = [w.get(timeout=5) for _ in range(2)]
    finally:
        w.stop()
    return [(e.type, e.kind, e.key, e.object) for e in evs]


def unknown_resource_404(p: Pair):
    out = [http_error(urllib.request.Request(p.url + path, method=method))
           for method, path in (("GET", "/api/v1/widgets"),
                                ("GET", "/api/v1/namespaces/default/widgets/w"),
                                ("POST", "/api/v1/widgets:batch"))]
    return [(code, body["kind"], body["reason"], body["code"]) for code, body in out]


def list_selectors(p: Pair):
    for i in range(6):
        pod = p.tu.make_pod(f"p{i}", labels={"app": "web" if i % 2 else "db", "tier": "fe"})
        pod.spec.node_name = f"n{i % 3}"
        p.rs.create("Pod", pod.to_dict())
    names = lambda items: sorted(i["metadata"]["name"] for i in items)  # noqa: E731
    out = {
        "label": names(p.rs.list("Pod", None, label_selector="app=web")[0]),
        "field": names(p.rs.list("Pod", None, field_selector="spec.nodeName=n0")[0]),
        "both": names(p.rs.list("Pod", None, label_selector="app=web",
                                field_selector="spec.nodeName=n1")[0]),
        "set": names(p.rs.list("Pod", None, label_selector="app in (web,db),tier")[0]),
        "not": names(p.rs.list("Pod", None, field_selector="spec.nodeName!=n0")[0]),
    }
    with pytest.raises(Exception):
        p.rs.list("Pod", None, field_selector="spec.bogus=1")
    out["bad"] = http_error(urllib.request.Request(
        p.url + "/api/v1/pods?labelSelector=a%20in%20()"))[0]
    # the server filters a watch by the same selectors; it ends the stream
    # after timeoutSeconds
    with urllib.request.urlopen(p.url + "/api/v1/pods?watch=true&resourceVersion=0"
                                "&timeoutSeconds=1&labelSelector=app%3Dweb"
                                "&fieldSelector=spec.nodeName!%3Dn1", timeout=10) as r:
        out["watch"] = [json.loads(line)["key"] for line in r if line.strip()]
    return out


def namespaced_collection_path(p: Pair):
    body = json.dumps(p.tu.make_pod("via-path").to_dict()).encode()
    req = urllib.request.Request(p.url + "/api/v1/namespaces/default/pods", data=body,
                                 method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        created = (r.status, json.loads(r.read()))
    _, here = get_json(p.url + "/api/v1/namespaces/default/pods")
    _, other = get_json(p.url + "/api/v1/namespaces/other/pods")
    return {"created": created, "here": [i["metadata"]["name"] for i in here["items"]],
            "other": other["items"], "client": [x.meta.key for x in p.cs.pods.list("default")[0]]}


def compacted_watch_relists(p: Pair):
    """The informer's watch connects only after the event-log window (4)
    slid past its LIST revision: the resume gets 410, the watch emits a
    gap, and the informer relists and holds every pod."""
    gate = threading.Event()
    opener = "_open_stream" if p.client_pkg == "port" else "_open"
    orig = getattr(p.rs, opener)

    def gated(path):
        gate.wait(10)
        return orig(path)

    setattr(p.rs, opener, gated)
    p.cs.pods.create(p.tu.make_pod("seed"))
    inf = p.informer_mod.SharedInformer(p.cs.pods)
    inf.start_manual()
    try:
        for i in range(10):
            p.server.store.create("Pod", p.tu.make_pod(f"late{i}").to_dict())
        gate.set()
        deadline = time.monotonic() + 10
        while len(inf.keys()) < 11 and time.monotonic() < deadline:
            inf.pump()
            time.sleep(0.02)
        return {"keys": sorted(inf.keys()), "relists": inf.stats["relists"],
                "gaps": p.rs.metrics.watch_gaps.value}
    finally:
        gate.set()
        inf.stop()


def _frames_watch_open(w) -> bool:
    """The framed watch's stream is up (the port's reader keeps it in
    ``_stream``, the JAX one in ``_resp``)."""
    return getattr(w, "_stream", None) is not None or getattr(w, "_resp", None) is not None


def framed_watch(p: Pair):
    """``?frames=1``: a ``create_many`` and a ``bind_many`` txn each arrive
    as one frame line; a single delete as a plain event."""
    _, rev = p.rs.list("Pod")
    w = p.rs.watch("Pod", from_revision=rev, frames=True)
    try:
        deadline = time.monotonic() + 10
        while not _frames_watch_open(w) and time.monotonic() < deadline:
            time.sleep(0.01)
        pods = []
        for i in range(5):
            pod = p.tu.make_pod(f"f{i}", cpu="100m", labels={"app": "web"})
            pod.meta.uid = f"uid-f{i}"
            pods.append(pod)
        p.cs.pods.create_many(pods)
        p.cs.pods.bind_many([p.api.Binding(pod_namespace="default", pod_name=f"f{i}",
                                           node_name=f"n{i % 2}") for i in range(3)])
        p.cs.pods.delete("f4")
        items = []
        while len(items) < 3 and time.monotonic() < deadline:
            it = w.get(timeout=0.1)
            if it is not None:
                items.append(it)
    finally:
        w.stop()
    out = []
    for it in items:
        if it.type == "FRAME":
            out.append({"type": it.type, "kind": it.kind, "types": it.types, "keys": it.keys,
                        "revisions": it.revisions, "prev": it.prev_revisions,
                        "nodes": it.node_names, "objects": it.objects,
                        "txn": (it.txn or "").split("-")[0]})
        else:
            out.append({"type": it.type, "key": it.key, "object": it.object})
    return {"items": out}


def selector_framed_watch(p: Pair):
    """``?frames=1&labelSelector=``: a txn arrives as the sub-frame of the
    entries the selector matches; a txn none of whose entries match sends
    nothing; a plain event the selector misses is not sent."""
    _, rev = p.rs.list("Pod")
    w = p.rs.watch("Pod", from_revision=rev, frames=True, label_selector="app=web")
    try:
        deadline = time.monotonic() + 10
        while not _frames_watch_open(w) and time.monotonic() < deadline:
            time.sleep(0.01)
        pods = []
        for i in range(6):
            pod = p.tu.make_pod(f"s{i}", cpu="100m", labels={"app": "web" if i % 2 else "db"})
            pod.meta.uid = f"uid-s{i}"
            pods.append(pod)
        p.cs.pods.create_many(pods)
        p.cs.pods.bind_many([p.api.Binding(pod_namespace="default", pod_name=f"s{i}",
                                           node_name="n0") for i in (0, 2)])  # db only
        p.cs.pods.delete("s4")  # db: filtered
        p.cs.pods.delete("s5")  # web: sent
        items = []
        while len(items) < 2 and time.monotonic() < deadline:
            it = w.get(timeout=0.1)
            if it is not None:
                items.append(it)
    finally:
        w.stop()
    out = []
    for it in items:
        if it.type == "FRAME":
            out.append({"type": it.type, "keys": it.keys, "objects": it.objects})
        else:
            out.append({"type": it.type, "key": it.key})
    return {"items": out}


def admitted_writes(p: Pair):
    """An apiserver over ``AdmittedStore(default_chain())``: a create in a
    missing namespace or naming a missing PriorityClass answers 403
    Forbidden; an admitted pod is stored with the chain's defaults; a
    batch create skips the chain (the reference package's own rule)."""
    req = urllib.request.Request(
        p.url + "/api/v1/namespaces/nowhere/pods",
        data=json.dumps(p.tu.make_pod("lost", namespace="nowhere").to_dict()).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    code, body = http_error(req)
    ghost = p.tu.make_pod("ghost")
    ghost.spec.priority_class_name = "ghost"
    with pytest.raises(p.remote.ForbiddenError, match="PriorityClass"):
        p.cs.pods.create(ghost)
    admitted = p.cs.pods.create(p.tu.make_pod("ok", cpu="100m"))
    batch = p.rs.create_many("Pod", [p.tu.make_pod("b", namespace="nowhere").to_dict()])
    return {"code": code, "reason": body["reason"], "message": body["message"],
            "admitted": admitted.to_dict(), "batch_namespace": batch[0]["metadata"]["namespace"],
            "names": sorted(x["metadata"]["name"] for x in p.rs.list("Pod")[0])}


def columnar_list(p: Pair):
    """``?columnar=1``: a Pod and a Node LIST as one packed column batch;
    a kind without a columnar form answers None."""
    for i in range(3):
        node = p.tu.make_node(f"n{i}", cpu="4", memory="8Gi",
                              labels={"failure-domain.beta.kubernetes.io/zone": f"z{i}"})
        node.meta.uid = f"uid-n{i}"
        p.cs.nodes.create(node)
    for i in range(4):
        pod = p.tu.make_pod(f"c{i}", cpu=f"{100 * (i + 1)}m", memory="64Mi")
        pod.meta.uid = f"uid-c{i}"
        p.cs.pods.create(pod)
    pods, nodes = p.rs.list_columns("Pod"), p.rs.list_columns("Node")
    return {"pod_wire": pods.to_wire(), "keys": pods.keys, "sig_ids": pods.sig_ids.tolist(),
            "req": pods.req_units.tolist(), "node_keys": nodes.keys, "zones": nodes.zones,
            "lazy_names": [o.meta.name for o in pods.objects()],
            "service": p.rs.list_columns("Service")}


@pytest.fixture(params=PAIRINGS, ids=lambda p: f"{p[0]}-client-{p[1]}-server")
def pairing(request):
    return request.param


@pytest.mark.timeout(60)
def test_healthz_metrics_version(pairing):
    got = check(healthz_metrics_version, pairing)
    assert got["healthz"] == {"status": "ok"} and got["request_count"]


@pytest.mark.timeout(60)
def test_remote_crud(pairing):
    assert check(remote_crud, pairing)["listed"] == ["p1"]


@pytest.mark.timeout(60)
def test_remote_cluster_scoped_node(pairing):
    assert check(cluster_scoped_node, pairing)["listed"] == ["n1"]


@pytest.mark.timeout(60)
def test_remote_cas_conflict(pairing):
    assert check(cas_conflict, pairing)["metadata"]["annotations"] == {"x": "1"}


@pytest.mark.timeout(60)
def test_remote_bind_and_batch(pairing):
    got = check(bind_and_batch, pairing)
    assert got["errors"][:2] == [None, None] and got["nodes"]["p2"] == "n2"
    assert got["subresource"][0] == 409


@pytest.mark.timeout(60)
def test_remote_watch_stream(pairing):
    got = check(watch_stream, pairing)
    assert [(t, k) for t, _, k, _ in got] == [("ADDED", "default/w1"), ("DELETED", "default/w1")]


@pytest.mark.timeout(60)
def test_unknown_resource_404(pairing):
    got = check(unknown_resource_404, pairing)
    assert all(code == 404 and reason == "NotFound" for code, _, reason, _ in got)


@pytest.mark.timeout(60)
def test_wire_list_selectors(pairing):
    got = check(list_selectors, pairing)
    assert got["label"] == ["p1", "p3", "p5"] and got["field"] == ["p0", "p3"]
    assert got["both"] == ["p1"] and len(got["set"]) == 6 and got["bad"] == 400
    assert got["watch"] == ["default/p3", "default/p5"]


@pytest.mark.timeout(60)
def test_namespaced_collection_path_routes(pairing):
    got = check(namespaced_collection_path, pairing)
    assert got["created"][0] == 201 and got["here"] == ["via-path"] and got["other"] == []


@pytest.mark.timeout(60)
def test_compacted_watch_ends_in_an_informer_relist(pairing):
    got = check(compacted_watch_relists, pairing, event_log_window=4)
    assert got["relists"] == 1 and got["gaps"] == 1 and len(got["keys"]) == 11


# -- the port client's failure handling -------------------------------------


class Scripted:
    """An HTTP server that answers each request with the next scripted
    (status, headers, body); the last entry repeats."""

    def __init__(self, script):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.script, self.seen = list(script), []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                outer.seen.append((self.command, self.path))
                code, headers, body = (outer.script.pop(0) if len(outer.script) > 1
                                       else outer.script[0])
                data = json.dumps(body).encode()
                self.send_response(code)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _answer

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


def _status(code, reason):
    return (code, {}, {"kind": "Status", "code": code, "reason": reason, "message": reason})


POD_LIST = (200, {}, {"items": [], "resourceVersion": 7})


@pytest.mark.timeout(60)
def test_framed_watch(pairing):
    got = check(framed_watch, pairing)
    assert [i["type"] for i in got["items"]] == ["FRAME", "FRAME", "DELETED"]
    assert got["items"][1]["nodes"] == ["n0", "n1", "n0"]


@pytest.mark.timeout(60)
def test_selector_framed_watch(pairing):
    got = check(selector_framed_watch, pairing)
    assert got["items"] == [
        {"type": "FRAME", "keys": ["default/s1", "default/s3", "default/s5"],
         "objects": got["items"][0]["objects"]},
        {"type": "DELETED", "key": "default/s5"}]


@pytest.mark.timeout(60)
def test_admitted_writes_answer_403_and_carry_the_chains_defaults(pairing):
    got = check(admitted_writes, pairing, admitted=True)
    assert got["code"] == 403 and got["reason"] == "Forbidden"
    assert "NamespaceLifecycle" in got["message"]
    tolerations = got["admitted"]["spec"]["tolerations"]
    assert {t["key"] for t in tolerations} == {"node.alpha.kubernetes.io/notReady",
                                               "node.alpha.kubernetes.io/unreachable"}
    assert got["batch_namespace"] == "nowhere" and got["names"] == ["b", "ok"]


@pytest.mark.timeout(60)
def test_columnar_list(pairing):
    got = check(columnar_list, pairing)
    assert got["keys"] == [f"default/c{i}" for i in range(4)] and got["service"] is None


@pytest.mark.timeout(60)
@pytest.mark.parametrize("script,outcome,counters", [
    # 5xx is retried until it clears
    ([_status(503, "Unavailable"), _status(500, "InternalError"), POD_LIST], "ok",
     {"remote_retries": 2}),
    # a 429's Retry-After replaces the backoff step
    ([(429, {"Retry-After": "1"}, {"kind": "Status", "code": 429}), POD_LIST], "ok",
     {"remote_retries": 1, "retry_after_honored": 1}),
    # 4xx is fatal and typed, never retried
    ([_status(404, "NotFound")], "NotFoundError", {"remote_fatal": 1, "remote_retries": 0}),
    ([_status(410, "Expired")], "ExpiredRevisionError", {"remote_fatal": 1}),
    # the budget runs out: 1 try + 3 retries
    ([_status(503, "Unavailable")], "RetryExhaustedError",
     {"remote_retries": 3, "remote_retry_exhausted": 1}),
], ids=["5xx-then-ok", "429-retry-after", "404-fatal", "410-fatal", "exhausted"])
def test_remote_store_retry_classification(script, outcome, counters):
    from kubernetes_tpu_torch.client import remote

    server = Scripted(script)
    sleeps = []
    try:
        rs = remote.RemoteStore(server.url, retry_seed=1, sleep=sleeps.append)
        if outcome == "ok":
            assert rs.list("Pod") == ([], 7)
        else:
            errors = {"NotFoundError": remote.NotFoundError,
                      "ExpiredRevisionError": remote.ExpiredRevisionError,
                      "RetryExhaustedError": remote.RetryExhaustedError}
            with pytest.raises(errors[outcome]):
                rs.list("Pod")
    finally:
        server.close()
    for name, want in counters.items():
        assert getattr(rs.metrics, name).value == want, name
    assert len(sleeps) == rs.metrics.remote_retries.value
    if "retry_after_honored" in counters:
        assert 0.5 <= sleeps[0] < 1.5  # the 1 s hint, jittered


@pytest.mark.timeout(60)
def test_remote_store_retries_a_post_only_when_it_never_reached_the_server():
    """Connection refused proves a POST never ran, so it is retried; a 5xx
    POST is retried too (the server did not do the work)."""
    from kubernetes_tpu_torch.client import remote

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # bound, never listening: connects are refused
        rs = remote.RemoteStore(f"http://127.0.0.1:{port}", sleep=lambda s: None)
        with pytest.raises(remote.RetryExhaustedError):
            rs.create("Pod", {"metadata": {"name": "p"}})
    assert rs.metrics.remote_retries.value == 3
    assert not remote.RemoteStore._transport_retry_safe("POST", ConnectionResetError())
    assert remote.RemoteStore._transport_retry_safe("GET", ConnectionResetError())


@pytest.mark.timeout(60)
def test_remote_watch_reconnects_from_its_last_revision():
    """A transient failure mid-watch (here: the first two connects fail)
    backs off and reconnects from the last revision seen, losing and
    repeating nothing."""
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.client import Clientset, remote
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testutil import make_pod

    server = APIServer(Store())
    server.start()
    try:
        sleeps = []
        rs = remote.RemoteStore(server.url, sleep=sleeps.append)
        cs = Clientset(rs)
        cs.pods.create(make_pod("a"))
        orig, paths = rs._open_stream, []

        def flaky(path):
            paths.append(path)
            if len(paths) <= 2:
                raise ConnectionResetError("injected")
            return orig(path)

        rs._open_stream = flaky
        w = rs.watch("Pod", from_revision=0)
        try:
            first = w.get(timeout=5)
            cs.pods.create(make_pod("b"))
            second = w.get(timeout=5)
        finally:
            w.stop()
    finally:
        server.stop()
    assert (first.key, second.key) == ("default/a", "default/b")
    assert rs.metrics.watch_reconnects.value == 2 and rs.metrics.watch_errors.value == 2
    assert sleeps == [remote.BACKOFF_MIN_S, 2 * remote.BACKOFF_MIN_S]
    assert all("resourceVersion=0" in p for p in paths[:3])


# -- TLS, both ways between the packages -------------------------------------


def tls_pair(client: str, server: str):
    """``server``'s apiserver over TLS with the test PKI's client CA, a
    memory audit and ``AuthenticatedOrDiscovery``; a store of ``client``'s
    package holding the admin client certificate."""
    from kubernetes_tpu_torch.testing import pki as fixture

    srv = importlib.import_module(f"{PKG[server]}.apiserver.server")
    auth = importlib.import_module(f"{PKG[server]}.auth")
    store = importlib.import_module(f"{PKG[server]}.store").Store()
    auditor = auth.Auditor()
    server_obj = srv.APIServer(
        store, authenticator=auth.UnionAuthenticator(auth.BootstrapTokenAuthenticator(store),
                                                     allow_anonymous=True),
        authorizer=auth.AuthenticatedOrDiscovery(), auditor=auditor,
        tls=srv.TLSConfig(*fixture.pair("apiserver"), client_ca=fixture.path("ca.crt")))
    server_obj.start()
    remote = importlib.import_module(f"{PKG[client]}.client.remote")
    rs = remote.RemoteStore(server_obj.url, ca_file=fixture.path("ca.crt"),
                            client_cert=fixture.path("admin.crt"),
                            client_key=fixture.path("admin.key"))
    return server_obj, auditor, rs


def tls_scenario(client: str, server: str) -> dict:
    server_obj, auditor, rs = tls_pair(client, server)
    tu = importlib.import_module(f"{PKG[client]}.testutil")
    try:
        for n in ("n1", "n2"):
            rs.create("Node", tu.make_node(n).to_dict())
        rs.create_many("Pod", [tu.make_pod(f"p{i}", cpu="100m").to_dict() for i in range(3)])
        pods, _ = rs.list("Pod")
        w = rs.watch("Pod", from_revision=0)
        try:
            seen = [w.get(timeout=10) for _ in range(3)]
            # the server ends each stream after 5 s: the next event arrives
            # only through a resume from the last revision
            time.sleep(6.0)
            errors = rs.bind_many([("default", "p0", "n1"), ("default", "p1", "n2"),
                                   ("default", "p9", "n1")])
            seen += [w.get(timeout=10) for _ in range(2)]
        finally:
            w.stop()
        bound = {p["metadata"]["name"]: p["spec"].get("nodeName") for p in rs.list("Pod")[0]}
    finally:
        server_obj.stop()
    users = sorted({e.user for e in auditor.memory.events})
    return {"scheme": server_obj.url.split(":")[0], "listed": [p["metadata"]["name"] for p in pods],
            "events": [(e.type, e.key, (e.object.get("spec") or {}).get("nodeName"))
                       for e in seen],
            "revisions_increase": all(a.revision < b.revision for a, b in zip(seen, seen[1:])),
            "errors": [e is None for e in errors], "bound": bound, "audit_users": users,
            "verbs": sorted({(e.verb, e.resource) for e in auditor.memory.events
                             if e.stage == "ResponseComplete"})}


_TLS_REFERENCE: dict = {}


@pytest.mark.timeout(90)
def test_tls_both_ways_between_the_packages(pairing):
    # the JAX/JAX record, run once a process (its own pairing reuses it)
    if not _TLS_REFERENCE:
        _TLS_REFERENCE["jj"] = tls_scenario("jax", "jax")
    want = _TLS_REFERENCE["jj"]
    got = want if tuple(pairing) == ("jax", "jax") else tls_scenario(*pairing)
    # the request info of a batch bind is the port's own (ROADMAP.md kept
    # divergence h): compare the rest of the audit's verbs
    strip = {("create", "bindings:batch"), ("bind", "pods"), ("create", "pods:batch"),
             ("create", "pods")}
    assert {k: v for k, v in got.items() if k != "verbs"} == {
        k: v for k, v in want.items() if k != "verbs"}
    assert set(got["verbs"]) - strip == set(want["verbs"]) - strip
    assert got["scheme"] == "https" and got["listed"] == ["p0", "p1", "p2"]
    assert got["events"][3:] == [("MODIFIED", "default/p0", "n1"), ("MODIFIED", "default/p1", "n2")]
    assert got["errors"] == [True, True, False] and got["audit_users"] == ["kubernetes-admin"]
    if pairing[1] == "port":
        assert ("bind", "pods") in got["verbs"] and ("create", "pods") in got["verbs"]


@pytest.mark.timeout(60)
def test_a_tls_watch_stops_at_once_and_a_refused_certificate_is_not_retried():
    """``RemoteWatch.stop`` shuts an SSL stream's socket down and the reader
    blocked in ``SSL_read`` returns at once.  A certificate the handshake
    refuses (the server's, under the wrong pinned CA, or ours, from another
    CA) fails the request on its first attempt: no retry can make it
    verify.  The JAX client retries such a GET until its budget is spent
    and fails a POST at once; the port fails both at once."""
    from kubernetes_tpu.client import remote as jax_remote
    from kubernetes_tpu_torch.client import remote
    from kubernetes_tpu_torch.testing import pki as fixture

    server_obj, _, rs = tls_pair("port", "port")
    try:
        w = rs.watch("Pod", from_revision=0)
        deadline = time.monotonic() + 5
        while w._stream is None and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # the reader is blocked in SSL_read
        t = time.monotonic()
        w.stop()
        w._thread.join(timeout=2)
        assert not w._thread.is_alive() and time.monotonic() - t < 1.0
        refused = [
            dict(ca_file=fixture.path("other/ca.crt"), client_cert=fixture.path("admin.crt"),
                 client_key=fixture.path("admin.key")),
            dict(ca_file=fixture.path("ca.crt"), client_cert=fixture.path("other/client.crt"),
                 client_key=fixture.path("other/client.key"))]
        for kw in refused:
            for method in ("GET", "POST"):
                sleeps = []
                store = remote.RemoteStore(server_obj.url, sleep=sleeps.append, **kw)
                with pytest.raises(OSError) as exc:
                    if method == "GET":
                        store.list("Pod")
                    else:
                        store.create("Node", {"kind": "Node", "metadata": {"name": "x"}})
                assert remote.tls_refused(exc.value)
                assert sleeps == [] and store.metrics.remote_retries.value == 0
                assert store.metrics.remote_fatal.value == 1
        jax = jax_remote.RemoteStore(server_obj.url, sleep=lambda s: None, **refused[0])
        with pytest.raises(jax_remote.RetryExhaustedError):
            jax.list("Pod")
        assert jax.metrics.remote_retries.value == jax.max_retries
    finally:
        server_obj.stop()


@pytest.mark.timeout(60)
def test_a_client_certificate_refused_before_the_request_is_sent_reads_as_a_refusal():
    """Under TLS 1.3 a client finishes its side of the handshake before the
    server checks its certificate.  A client that sends its request only
    after the server has refused it must still read the server's alert (a
    refusal, never retried), not a dropped connection (retried): the server
    lingers on a refused handshake until the client closes."""
    import ssl

    from kubernetes_tpu_torch.client import remote
    from kubernetes_tpu_torch.testing import pki as fixture

    server_obj, _, _ = tls_pair("port", "port")
    ctx = ssl.create_default_context(cafile=fixture.path("ca.crt"))
    ctx.load_cert_chain(fixture.path("other/client.crt"), fixture.path("other/client.key"))
    try:
        for _ in range(3):
            with ctx.wrap_socket(socket.create_connection(("127.0.0.1", server_obj.port),
                                                          timeout=10),
                                 server_hostname="127.0.0.1") as conn:
                time.sleep(0.3)  # the server has refused the certificate
                with pytest.raises(OSError) as exc:
                    conn.sendall(b"GET /api/v1/pods HTTP/1.1\r\nHost: x\r\n\r\n")
                    conn.recv(1024)
                assert remote.tls_refused(exc.value), repr(exc.value)
    finally:
        server_obj.stop()


@pytest.mark.timeout(60)
def test_a_kept_alive_connection_carries_no_identity_into_the_next_request():
    """Each request on one kept-alive connection is authenticated on its
    own: a token on the first does not make the second (no token) that
    user, neither for the authorizer nor for the admission plugins
    (``store.user``, thread-local on the handler's thread) nor the audit."""
    import http.client

    from kubernetes_tpu_torch.admission import AdmittedStore
    from kubernetes_tpu_torch.admission.framework import AdmissionChain, AdmissionPlugin
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.auth import (
        Auditor,
        TokenFileAuthenticator,
        UnionAuthenticator,
    )

    seen = []

    class Record(AdmissionPlugin):
        name = "Record"

        def admit(self, attrs):
            seen.append(attrs.user)

    store = AdmittedStore(AdmissionChain([Record()]))
    auditor = Auditor()
    server = APIServer(store, authenticator=UnionAuthenticator(
        TokenFileAuthenticator({"t": "alice"}), allow_anonymous=True), auditor=auditor)
    server.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        codes = []
        for i, token in enumerate(("t", None, "t", None)):
            body = json.dumps({"kind": "Node", "metadata": {"name": f"n{i}"}})
            headers = {"Content-Type": "application/json"}
            if token:
                headers["Authorization"] = f"Bearer {token}"
            conn.request("POST", "/api/v1/nodes", body=body, headers=headers)
            resp = conn.getresponse()
            resp.read()
            codes.append(resp.status)
        sock = conn.sock  # one connection served all four
    finally:
        conn.close()
        server.stop()
    assert sock is not None and codes == [201] * 4
    assert seen == ["alice", "system:anonymous", "alice", "system:anonymous"]
    assert [e.user for e in auditor.memory.events if e.stage == "ResponseComplete"] == [
        "alice", "system:anonymous", "alice", "system:anonymous"]


@pytest.mark.timeout(60)
def test_a_silent_tls_client_does_not_hold_the_accept_loop():
    """The handshake runs in the connection's own thread: clients that
    connect and send nothing hold their own threads, and everyone else is
    served at once."""
    server_obj, _, rs = tls_pair("port", "port")
    silent = []
    try:
        for _ in range(3):
            s = socket.create_connection(("127.0.0.1", server_obj.port), timeout=5)
            silent.append(s)
        t = time.monotonic()
        items, _ = rs.list("Pod")
        assert items == [] and time.monotonic() - t < 2.0
    finally:
        for s in silent:
            s.close()
        server_obj.stop()


# -- late kinds, PATCH and OpenAPI (tests/test_apiserver.py :137, :196, :258) --

def late_registered_kind(p: Pair):
    """A kind registered after the server started (in both packages'
    registries: the server routes by it, the client names its path by it)
    is addressable at once: lookup is per request."""
    types = [importlib.import_module(f"{PKG[side]}.api.types") for side in ("port", "jax")]

    class Widget:
        KIND = "Widget"

    for t in types:
        t.register_kind(Widget)
    try:
        p.server.store.create("Widget", {"kind": "Widget",
                                         "metadata": {"name": "w", "namespace": "default"}})
        _, listed = get_json(p.url + "/api/v1/widgets")
        items, _ = p.rs.list("Widget")
        return {"raw": [i["metadata"]["name"] for i in listed["items"]],
                "client": [i["metadata"]["name"] for i in items]}
    finally:
        for t in types:
            t.KINDS.pop("Widget", None)
            t.KIND_PLURALS.pop("Widget", None)


def wire_patch_verb(p: Pair):
    p.rs.create("Node", p.tu.make_node("n1").to_dict())
    out = [p.rs.patch("Node", "", "n1", {"metadata": {"labels": {"pool": "gpu"}}})]
    p.rs.create("Pod", p.tu.make_pod("p1").to_dict())
    out.append(p.rs.patch("Pod", "default", "p1",
                          {"spec": {"containers": [{"name": "c0", "image": "new:v2"}]}},
                          patch_type="strategic"))
    out.append(p.rs.patch("Pod", "default", "p1",
                          [{"op": "replace", "path": "/metadata/labels",
                            "value": {"patched": "yes"}}], patch_type="json"))
    with pytest.raises(Exception) as ei:
        p.rs.patch("Pod", "default", "p1", [{"op": "remove", "path": "/metadata/ghost"}],
                   patch_type="json")
    out.append(str(ei.value).split(":")[0])
    with pytest.raises(KeyError):
        p.rs.patch("Pod", "default", "ghost", {"metadata": {"labels": {"x": "1"}}})
    return out


def openapi_document(p: Pair):
    docs = []
    for path in ("/openapi/v2", "/swagger.json"):
        _, doc = get_json(p.url + path)
        assert doc["swagger"] == "2.0"
        pod = doc["definitions"]["io.k8s.api.core.v1.Pod"]
        assert pod["type"] == "object" and "containers" in pod["properties"]["spec"]["properties"]
        assert set(doc["paths"]["/api/v1/namespaces/{namespace}/pods/{name}"]) == {
            "get", "put", "patch", "delete"}
        assert set(doc["paths"]["/api/v1/namespaces/{namespace}/pods"]) == {"get", "post"}
        assert "/api/v1/nodes/{name}" in doc["paths"]
        # the schemas without their one-line descriptions (each package's
        # own docstrings), and the operations of every path
        defs = {k: {f: v for f, v in d.items() if f != "description"}
                for k, d in doc["definitions"].items()}
        docs.append({"definitions": defs, "paths": doc["paths"], "info": doc["info"]["title"]})
    assert docs[0] == docs[1]
    return docs[0]


@pytest.mark.timeout(60)
def test_late_registered_kind_is_wire_addressable(pairing):
    assert check(late_registered_kind, pairing) == {"raw": ["w"], "client": ["w"]}


@pytest.mark.timeout(60)
def test_wire_patch_verb(pairing):
    got = check(wire_patch_verb, pairing)
    assert got[0]["metadata"]["labels"]["pool"] == "gpu"
    assert got[1]["spec"]["containers"][0]["image"] == "new:v2"
    assert got[2]["metadata"]["labels"] == {"patched": "yes"}
    assert got[3].startswith("422")


@pytest.mark.timeout(60)
def test_openapi_document_served(pairing):
    got = check(openapi_document, pairing)
    from kubernetes_tpu_torch.api.types import KINDS

    # the 34 API kinds and federation's Cluster
    assert "io.k8s.api.core.v1.Cluster" in got["definitions"]
    assert len(got["definitions"]) == len(KINDS) == 35
    assert len(got["paths"]) == 2 * len(KINDS)


@pytest.mark.timeout(60)
def test_requests_by_verb_and_resource():
    """The port's ``apiserver_requests_total`` (the JAX package counts
    requests only in all): one series per verb and resource, a subresource
    as ``resource/sub``, never one per object name."""
    srv = importlib.import_module("kubernetes_tpu_torch.apiserver")
    backing = importlib.import_module("kubernetes_tpu_torch.store").Store()
    server = srv.APIServer(backing)
    server.start()
    routes = [("GET", "/api/v1/pods"),  # core collection
              ("GET", "/api/v1/namespaces/-/nodes/n1"),  # cluster-scoped object
              ("GET", "/api/v1/namespaces/ns/pods/web"),  # namespaced object
              ("PUT", "/api/v1/namespaces/ns/pods/web/status"),  # its subresource
              ("GET", "/apis/apps/v1/namespaces/ns/deployments/web"),  # grouped object
              ("GET", "/apis/apps/v1/namespaces/ns/deployments/web/scale"),
              ("GET", "/apis/apiregistration.k8s.io/v1/apiservices/v1.x/status"),
              ("GET", "/apis/apps/v1/namespaces/ns/deployments/db")]
    try:
        for method, path in routes:
            req = urllib.request.Request(server.url + path, method=method,
                                         data=b"{}" if method == "PUT" else None,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()
            except urllib.error.HTTPError as e:  # counted before dispatch
                e.read()
        got = server.metrics.requests.values()
        with urllib.request.urlopen(server.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        server.stop()
    assert got == {("list", "pods"): 1, ("get", "nodes"): 1, ("get", "pods"): 1,
                   ("update", "pods/status"): 1, ("get", "apps/deployments"): 2,
                   ("get", "apps/deployments/scale"): 1,
                   ("get", "apiregistration.k8s.io/apiservices/status"): 1}
    assert 'apiserver_requests_total{verb="get",resource="apps/deployments"} 2.0' in text
