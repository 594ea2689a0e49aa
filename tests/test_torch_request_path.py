"""The apiserver's per-request path, made cheaper without changing an
answer: the request's URL parsed once, and the admission chain's read of
the stored object on an update only where a plugin looks at it.

The four client x server pairings of ``tests/test_torch_apiserver.py`` and
the keep-alive tests hold the answers themselves; here each cheaper piece
is held against what it replaces."""

from __future__ import annotations

import http.client
import json

import pytest

from kubernetes_tpu_torch.apiserver import server as srv

NODE = {"apiVersion": "v1", "kind": "Node",
        "metadata": {"name": "n1", "labels": {"zone": "a"}}}

# (method, path, body, the status wanted): each request once, in this order
REQUESTS = [
    ("POST", "/api/v1/nodes", NODE, 201),
    ("GET", "/api/v1/namespaces/-/nodes/n1", None, 200),
    ("GET", "/api/v1/nodes?labelSelector=zone%3Da", None, 200),
    ("GET", "/api/v1/nodes?labelSelector=zone%3Db", None, 200),
    ("PUT", "/api/v1/namespaces/-/nodes/n1", NODE, 200),
    ("DELETE", "/api/v1/namespaces/-/nodes/n1", None, 200),
    ("GET", "/healthz", None, 200),
]


@pytest.mark.parametrize("max_in_flight", [0, 4])
def test_each_request_parses_its_url_once(monkeypatch, max_in_flight):
    """One ``urlparse`` a request, whether the max-in-flight filter reads
    the query or not, and the query still reaches the handler (a label
    selector filters the list)."""
    from kubernetes_tpu_torch.store.store import Store

    calls = []
    plain = srv.urlparse

    def counted(url, *a, **k):
        calls.append(url)
        return plain(url, *a, **k)

    monkeypatch.setattr(srv, "urlparse", counted)
    api = srv.APIServer(Store(), max_in_flight=max_in_flight)
    api.start()
    conn = http.client.HTTPConnection("127.0.0.1", api.port, timeout=10)
    try:
        listed = []
        for method, path, body, want in REQUESTS:
            if method == "PUT":  # the Node as created, its resourceVersion
                body = created
            calls.clear()
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            assert resp.status == want, (method, path, data)
            assert calls == [path], (method, path)
            if method == "POST":
                created = json.loads(data)
            if "labelSelector" in path:
                listed.append([i["metadata"]["name"] for i in json.loads(data)["items"]])
        assert listed == [["n1"], []]
    finally:
        conn.close()
        api.stop()


def test_admitted_update_reads_the_stored_object_only_for_a_plugin(monkeypatch):
    """No default plugin looks at a Node's update (a heartbeat): the stored
    Node is not read for the chain; a plugin that handles the update gets
    it as ``old_obj``, as before."""
    from kubernetes_tpu_torch.admission import AdmittedStore, default_chain
    from kubernetes_tpu_torch.admission.framework import UPDATE, AdmissionChain, AdmissionPlugin
    from kubernetes_tpu_torch.store.store import Store
    from kubernetes_tpu_torch.testutil import make_node

    reads = []
    plain_get = Store.get

    def counted(self, kind, namespace, name):
        reads.append(kind)
        return plain_get(self, kind, namespace, name)

    monkeypatch.setattr(Store, "get", counted)
    store = AdmittedStore(default_chain())
    node = store.create("Node", make_node("n1").to_dict())
    store.update("Node", dict(node))
    assert reads == []

    seen = []

    class Watcher(AdmissionPlugin):
        operations = (UPDATE,)

        def admit(self, attrs):
            seen.append((attrs.kind, (attrs.old_obj or {}).get("metadata", {}).get("name")))

    store = AdmittedStore(AdmissionChain([Watcher()]))
    node = store.create("Node", make_node("n2").to_dict())
    store.update("Node", dict(node))
    assert seen == [("Node", "n2")] and reads == ["Node"]


@pytest.mark.parametrize("watched", ["Node", "Pod"])
def test_admitted_update_old_object_for_the_kind_a_plugin_handles(monkeypatch, watched):
    """A plugin that handles one kind's updates gets the stored object (the
    one before the update) for that kind only; the other kind's update is
    neither read nor admitted, and both updates land."""
    from kubernetes_tpu_torch.admission import AdmittedStore
    from kubernetes_tpu_torch.admission.framework import UPDATE, AdmissionChain, AdmissionPlugin
    from kubernetes_tpu_torch.store.store import Store
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    reads = []
    plain_get = Store.get

    def counted(self, kind, namespace, name):
        reads.append(kind)
        return plain_get(self, kind, namespace, name)

    seen = []

    class Watcher(AdmissionPlugin):
        operations = (UPDATE,)

        def handles(self, attrs):
            return super().handles(attrs) and attrs.kind == watched

        def admit(self, attrs):
            old = attrs.old_obj or {}
            seen.append((attrs.kind, old.get("metadata", {}).get("labels", {}).get("beat")))

    store = AdmittedStore(AdmissionChain([Watcher()]))
    objs = {"Node": store.create("Node", make_node("n1").to_dict()),
            "Pod": store.create("Pod", make_pod("p1").to_dict())}
    monkeypatch.setattr(Store, "get", counted)
    for kind, obj in objs.items():
        obj = json.loads(json.dumps(obj))
        obj["metadata"].setdefault("labels", {})["beat"] = "1"
        obj = json.loads(json.dumps(store.update(kind, obj)))
        obj["metadata"]["labels"]["beat"] = "2"
        store.update(kind, obj)
    assert reads == [watched, watched]
    assert seen == [(watched, None), (watched, "1")]
    monkeypatch.setattr(Store, "get", plain_get)
    for kind, obj in objs.items():
        ns = obj["metadata"].get("namespace", "default")
        assert store.get(kind, ns, obj["metadata"]["name"])["metadata"]["labels"]["beat"] == "2"
