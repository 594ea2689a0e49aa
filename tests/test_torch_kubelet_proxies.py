"""The apiserver's kubelet proxies on the port, held to the JAX package:
the pod subresources ``log``, ``exec``, ``attach`` and ``cp``, the node
proxy, and the Endpoints half of the readiness test.

Five twins run ``tests/test_kubelet_depth.py`` cases whole through both
packages (``tests/torch_twin``), three of them through ``kubectl``
(``logs``, ``exec``, discovery and ``top pods``): both pass the test's
assertions, leave equal stores and answer every ``kubectl`` call with the
same exit code and output.  The log half of
``test_pod_logs_through_kubelet_server_and_apiserver`` also runs here over
plain HTTP.  The other scenarios run through both packages with ``both``
and compare status codes and bodies.  A last test is the port's own: a
``cp`` PUT and a GET on one kept-alive connection (the JAX server keeps
no connection alive)."""

from __future__ import annotations

import http.client
import importlib
import json
import urllib.error
import urllib.request

import pytest

from tests.torch_kubelet_pkg import FakeClock, both
from tests.torch_twin import twin


@pytest.mark.timeout(60)
def test_log_path_traversal_and_stale_buffers_blocked(tmp_path):
    twin("test_kubelet_depth", "test_log_path_traversal_and_stale_buffers_blocked", tmp_path)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", ["test_pod_logs_through_kubelet_server_and_apiserver",
                                  "test_kubectl_exec_through_apiserver_and_kubelet",
                                  "test_discovery_and_top_pods"])
def test_kubectl_twin(test, tmp_path):
    twin("test_kubelet_depth", test, tmp_path, echo=["cli.kubectl:main"])


@pytest.mark.timeout(60)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_readiness_flips_pod_ready_condition_and_endpoints(lazy, tmp_path):
    twin("test_kubelet_depth", "test_readiness_flips_pod_ready_condition_and_endpoints",
         tmp_path, lazy=lazy)


def _world(P, store=None):
    store = store if store is not None else P.Store()
    cs = P.Clientset(store)
    k = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=FakeClock(), serve=True)
    k.register()
    srv = importlib.import_module(f"{P.root}.apiserver").APIServer(store)
    srv.start()
    return cs, k, srv


def _pod(P, name, node="n1", privileged=False):
    api = P.api
    c = api.Container(name="c")
    pod = api.Pod(meta=api.ObjectMeta(name=name, namespace="default"),
                  spec=api.PodSpec(containers=[c], node_name=node))
    d = pod.to_dict()
    if privileged:
        d["spec"]["containers"][0]["securityContext"] = {"privileged": True}
    return d


def _start(cs, k, P, d):
    cs.store.create("Pod", d)
    for _ in range(3):
        k.tick()


def _call(url, method="GET", body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _reason(code_body):
    code, body = code_body
    if code == 200:
        return code, body
    return code, json.loads(body).get("reason")


def _run(P, scenario, store=None):
    cs, k, srv = _world(P, store)
    try:
        return scenario(P, cs, k, srv.url + "/api/v1/namespaces/default/pods")
    finally:
        srv.stop()
        k.server.stop()


@pytest.mark.timeout(60)
def test_pod_log_subresource_through_the_apiserver():
    """The apiserver half of the JAX ``kubectl logs`` test."""
    def scenario(P, cs, k, pods):
        _start(cs, k, P, _pod(P, "p"))
        k.runtime.append_log("default/p", "c", "hello from the app")
        code, body = _call(f"{pods}/p/log")
        assert code == 200 and "hello from the app" in body.decode()
        tail = _call(f"{pods}/p/log?tailLines=1")
        assert tail == (200, b"hello from the app\n")
        return body, tail, _reason(_call(f"{pods}/p/log?tailLines=abc"))

    both(lambda P: _run(P, scenario))


@pytest.mark.timeout(60)
def test_exec_attach_and_errors_through_the_apiserver():
    def scenario(P, cs, k, pods):
        _start(cs, k, P, _pod(P, "p"))
        cs.store.create("Pod", _pod(P, "pending", node=""))
        k.runtime.append_log("default/p", "c", "attached")
        cmd = json.dumps({"command": ["echo", "ok"]}).encode()
        hdr = {"Content-Type": "application/json"}
        out = {"echo": _call(f"{pods}/p/exec", "POST", cmd, hdr),
               "attach": _call(f"{pods}/p/attach")}
        k.runtime.set_exec_handler("default/p", "c",
                                   lambda c: ("no such file", 2) if c[0] == "ls" else ("ok", 0))
        out["scripted"] = _call(f"{pods}/p/exec", "POST",
                                json.dumps({"command": ["ls", "/nope"]}).encode(), hdr)
        out["errors"] = [
            _reason(_call(f"{pods}/p/exec?container=other", "POST", cmd, hdr)),
            _reason(_call(f"{pods}/p/exec", "POST", b"{}", hdr)),
            _reason(_call(f"{pods}/pending/exec", "POST", cmd, hdr)),
            _reason(_call(f"{pods}/pending/log")),
            _reason(_call(f"{pods}/ghost/log")),
            _reason(_call(f"{pods}/p/attach?container=../../pods")),
        ]
        assert out["echo"][0] == 200 and out["attach"][1].endswith(b"attached\n")
        assert [c for c, _ in out["errors"]] == [400, 400, 400, 400, 404, 400]
        return out

    both(lambda P: _run(P, scenario))


@pytest.mark.timeout(60)
def test_cp_round_trips_bytes_through_the_apiserver():
    def scenario(P, cs, k, pods):
        _start(cs, k, P, _pod(P, "p"))
        data = bytes(range(256)) * 8
        put = _call(f"{pods}/p/cp?path=/tmp/blob", "PUT", data,
                    {"Content-Type": "application/octet-stream"})
        got = _call(f"{pods}/p/cp?path=/tmp/blob")
        assert put[0] == 200 and got == (200, data)
        return put, got, _reason(_call(f"{pods}/p/cp")), \
            _reason(_call(f"{pods}/p/cp?path=/tmp/none")), \
            _reason(_call(f"{pods}/p/cp?path=/x", "POST", b""))

    both(lambda P: _run(P, scenario))


@pytest.mark.timeout(60)
def test_node_proxy_reaches_the_kubelet():
    def scenario(P, cs, k, pods):
        base = pods.split("/api/v1/")[0] + "/api/v1/nodes"
        _start(cs, k, P, _pod(P, "p"))
        code, body = _call(f"{base}/n1/proxy/stats/summary")
        summary = json.loads(body)
        assert code == 200 and summary["node"]["nodeName"] == "n1"
        healthz = _call(f"{base}/n1/proxy/healthz")
        api = P.api
        cs.nodes.create(api.Node(meta=api.ObjectMeta(name="bare", namespace="")))
        return (sorted(p["podRef"]["name"] for p in summary["pods"]), healthz,
                _reason(_call(f"{base}/ghost/proxy/stats/summary")),
                _reason(_call(f"{base}/bare/proxy/stats/summary")))

    both(lambda P: _run(P, scenario))


@pytest.mark.timeout(60)
def test_exec_passes_the_connect_admission():
    """``DenyEscalatingExec`` refuses exec into a privileged container
    (403); the admission runs before the pod's node is resolved."""
    def scenario(P):
        adm = importlib.import_module(f"{P.root}.admission")
        store = adm.AdmittedStore(adm.AdmissionChain([adm.DenyEscalatingExec()]))

        def inner(P, cs, k, pods):
            _start(cs, k, P, _pod(P, "p"))
            _start(cs, k, P, _pod(P, "priv", privileged=True))
            cmd = json.dumps({"command": ["id"]}).encode()
            hdr = {"Content-Type": "application/json"}
            return (_call(f"{pods}/p/exec", "POST", cmd, hdr)[0],
                    _reason(_call(f"{pods}/priv/exec", "POST", cmd, hdr)),
                    _reason(_call(f"{pods}/priv/attach")))

        return _run(P, inner, store)

    assert both(scenario) == (200, (403, "Forbidden"), (403, "Forbidden"))


@pytest.mark.timeout(60)
def test_cp_put_then_get_on_one_kept_alive_connection():
    """The port reads every body before routing, so the cp PUT forwards
    that body and the connection's next request is read as a request (a
    second read of the body would wait for bytes that never come)."""
    from tests.torch_kubelet_pkg import pkg

    P = pkg("port")

    def scenario(P, cs, k, pods):
        _start(cs, k, P, _pod(P, "p"))
        host, port = pods.split("//")[1].split("/")[0].split(":")
        path = "/" + pods.split("//")[1].split("/", 1)[1]
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            conn.request("PUT", f"{path}/p/cp?path=/a", body=b"first")
            r1 = conn.getresponse()
            assert r1.status == 200 and r1.getheader("Connection") == "keep-alive"
            r1.read()
            sock = conn.sock
            conn.request("GET", f"{path}/p/cp?path=/a")
            r2 = conn.getresponse()
            assert conn.sock is sock  # the same connection
            return r2.status, r2.read()
        finally:
            conn.close()

    assert _run(P, scenario) == (200, b"first")
