"""The port's PATCH (``api/patch.py``, the apiserver's PATCH route and
``RemoteStore.patch``) against the JAX package's, on the CPU.

- The three patch types (merge, strategic-merge, JSON patch) give equal
  documents in both packages on seeded documents and patches
  (hypothesis), or fail alike.
- A PATCH to each package's apiserver answers 200 with the patched
  object, 415 for an unknown patch content type and 422 for a patch that
  cannot apply, as the JAX server does; a versioned patch applies in wire
  space.
- A cordon PATCH (``{"spec": {"unschedulable": true}}``) over the wire to
  a node moves the next in-process batch off it: the port's
  ``BatchBackend(device="cpu")`` binds as the JAX ``TPUBatchBackend`` does
  on the same cluster before and after the cordon, the port's per-pod
  oracle replayed over the cluster as read back before the wave
  (``workload.oracle_replay_state``) binds it alike, and the uncordon by
  JSON patch makes the node usable again.

All exact: no tolerance applies.
"""

from __future__ import annotations

import copy
import importlib
import json
import urllib.error
import urllib.request

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubernetes_tpu.api import patch as jax_patch
from kubernetes_tpu_torch.api import patch as port_patch

PKG = {"port": "kubernetes_tpu_torch", "jax": "kubernetes_tpu"}
MASKED = ("uid", "creationTimestamp", "resourceVersion")

_keys = st.sampled_from(["a", "b", "c", "name", "spec", "items"])
_leaf = st.one_of(st.none(), st.booleans(), st.integers(-5, 5), st.text("xyz", max_size=3))
_named = st.fixed_dictionaries({"name": st.sampled_from(["c0", "c1", "c2"])},
                               optional={"image": st.text("ab", max_size=2),
                                         "port": st.integers(0, 3)})
_docs = st.recursive(
    _leaf,
    lambda inner: st.one_of(st.lists(inner, max_size=3), st.lists(_named, max_size=3),
                            st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=12)


def _outcome(fn, *args):
    """The function's result, or the type of what it raised."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the exception type is the result
        return ("raised", type(e).__name__)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(base=st.dictionaries(_keys, _docs, max_size=4),
       overlay=st.dictionaries(_keys, _docs, max_size=4),
       strategic=st.booleans())
def test_merge_and_strategic_patches_equal_the_reference(base, overlay, strategic):
    want = _outcome(jax_patch.merge_patch, copy.deepcopy(base), copy.deepcopy(overlay),
                    strategic)
    got = _outcome(port_patch.merge_patch, copy.deepcopy(base), copy.deepcopy(overlay),
                   strategic)
    assert got == want
    ptype = port_patch.STRATEGIC if strategic else port_patch.MERGE
    assert (_outcome(port_patch.apply_patch, copy.deepcopy(base), copy.deepcopy(overlay), ptype)
            == _outcome(jax_patch.apply_patch, copy.deepcopy(base), copy.deepcopy(overlay),
                        ptype))


def _json_ops(doc: dict):
    """Seeded RFC 6902 operations over ``doc``'s own paths, with some that
    name a missing path or an unsupported op."""
    paths = [""]
    stack = [("", doc)]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, dict):
            for k, v in node.items():
                paths.append(f"{prefix}/{k}")
                stack.append((f"{prefix}/{k}", v))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                paths.append(f"{prefix}/{i}")
                stack.append((f"{prefix}/{i}", v))
            paths.append(f"{prefix}/-")
    op = st.fixed_dictionaries({
        "op": st.sampled_from(["add", "replace", "remove", "remove", "move"]),
        "path": st.one_of(st.sampled_from(paths), st.just("/ghost/x")),
        "value": _leaf})
    return st.lists(op, min_size=1, max_size=4)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), base=st.dictionaries(_keys, _docs, min_size=1, max_size=4))
def test_json_patches_equal_the_reference(data, base):
    ops = data.draw(_json_ops(base))
    want = _outcome(jax_patch.apply_patch, copy.deepcopy(base), copy.deepcopy(ops),
                    jax_patch.JSON_PATCH)
    got = _outcome(port_patch.apply_patch, copy.deepcopy(base), copy.deepcopy(ops),
                   port_patch.JSON_PATCH)
    assert got == want
    assert port_patch.CONTENT_TYPES == jax_patch.CONTENT_TYPES


# -- the PATCH route -----------------------------------------------------------


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in MASKED else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _patch(url: str, body, ctype: str):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="PATCH",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, _mask(json.loads(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["reason"]


def _patch_route(which: str) -> list:
    """PATCHes of every kind of outcome to one package's apiserver, through
    raw HTTP and through that package's ``RemoteStore.patch``."""
    pkg = PKG[which]
    srv = importlib.import_module(f"{pkg}.apiserver")
    store = importlib.import_module(f"{pkg}.store").Store()
    tu = importlib.import_module(f"{pkg}.testutil")
    remote = importlib.import_module(f"{pkg}.client.remote")
    server = srv.APIServer(store)
    server.start()
    try:
        rs = remote.RemoteStore(server.url)
        rs.create("Node", tu.make_node("n1").to_dict())
        rs.create("Pod", tu.make_pod("p1", cpu="1").to_dict())
        rs.create("Deployment", {"kind": "Deployment", "metadata": {
            "name": "d", "namespace": "default"}, "spec": {
            "replicas": 4, "strategy": "RollingUpdate", "maxSurge": 1, "maxUnavailable": 0,
            "selector": {"matchLabels": {"app": "d"}},
            "template": {"metadata": {"labels": {"app": "d"}}}}})
        node = f"{server.url}/api/v1/namespaces/-/nodes/n1"
        pod = f"{server.url}/api/v1/namespaces/default/pods/p1"
        out = [
            _patch(node, {"metadata": {"labels": {"pool": "gpu"}}},
                   "application/merge-patch+json"),
            _patch(node, {"spec": {"unschedulable": True}},
                   "application/strategic-merge-patch+json"),
            _patch(pod, {"spec": {"containers": [{"name": "c0", "image": "new:v2"}]}},
                   "application/strategic-merge-patch+json"),
            _patch(pod, [{"op": "replace", "path": "/metadata/labels",
                          "value": {"patched": "yes"}}], "application/json-patch+json"),
            _patch(pod, {"metadata": {"labels": {"x": "1"}}}, "application/json"),
            _patch(pod, {"metadata": {"labels": {"x": "1"}}}, "text/plain"),
            _patch(pod, [{"op": "remove", "path": "/metadata/ghost"}],
                   "application/json-patch+json"),
            _patch(pod, [{"op": "copy", "path": "/metadata/labels"}],
                   "application/json-patch+json"),
            _patch(f"{server.url}/api/v1/namespaces/default/pods/ghost",
                   {"metadata": {"labels": {"x": "1"}}}, "application/merge-patch+json"),
            # a versioned patch applies in the spoke's wire space: the
            # nested rollingUpdate lands on the hub's flat fields
            _patch(f"{server.url}/api/v1/namespaces/default/deployments/d",
                   {"apiVersion": "apps/v1beta1", "spec": {"strategy": {
                       "rollingUpdate": {"maxSurge": "50%"}}}},
                   "application/strategic-merge-patch+json"),
        ]
        out.append(_mask(rs.patch("Pod", "default", "p1", {"metadata": {"labels": {"m": "1"}}})))
        out.append(_mask(rs.patch("Pod", "default", "p1",
                                  [{"op": "add", "path": "/metadata/labels/j", "value": "2"}],
                                  patch_type="json")))
        with pytest.raises(Exception) as ei:
            rs.patch("Pod", "default", "p1", [{"op": "remove", "path": "/metadata/ghost"}],
                     patch_type="json")
        out.append(str(ei.value).split(":")[0])
        return out
    finally:
        server.stop()


def test_the_patch_route_answers_as_the_reference():
    want, got = _patch_route("jax"), _patch_route("port")
    assert got == want
    assert [o[0] for o in got[:10]] == [200, 200, 200, 200, 415, 415, 422, 422, 404, 200]
    assert got[0][1]["metadata"]["labels"]["pool"] == "gpu"
    assert got[1][1]["spec"]["unschedulable"] is True
    assert got[2][1]["spec"]["containers"][0]["image"] == "new:v2"
    assert got[3][1]["metadata"]["labels"] == {"patched": "yes"}
    assert got[9][1]["spec"]["maxSurge"] == 2 and "apiVersion" not in got[9][1]
    assert got[12] == "422"


# -- a cordon moves the next batch ---------------------------------------------


def _cordon_run(which: str) -> dict:
    """Six nodes, a first batch of 12 pods, a cordon PATCH over the wire on
    the node with the most pods, a second batch of 12, the uncordon by JSON
    patch, a third batch; every batch on the package's batch backend."""
    pkg = PKG[which]
    store = importlib.import_module(f"{pkg}.store").Store()
    tu = importlib.import_module(f"{pkg}.testutil")
    cs = importlib.import_module(f"{pkg}.client").Clientset(store)
    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    algo = sched_mod.GenericScheduler()
    if which == "jax":
        from kubernetes_tpu.ops import TPUBatchBackend

        backend = TPUBatchBackend(algorithm=algo, kernel_impl="xla")
    else:
        from kubernetes_tpu_torch.ops.backend import BatchBackend

        backend = BatchBackend(algorithm=algo, device="cpu")
    cs.nodes.create_many([tu.make_node(f"n{i}", cpu=str(4 + i % 3), memory="16Gi")
                          for i in range(6)])
    sched = sched_mod.Scheduler(cs, algorithm=algo, backend=backend, emit_events=False)
    sched.start(manual=True)
    server = importlib.import_module(f"{pkg}.apiserver").APIServer(store)
    server.start()
    out: dict = {"waves": []}

    def wave(w: int) -> dict:
        cs.pods.create_many([tu.make_pod(f"w{w}-{i:02d}", cpu=f"{100 + 50 * (i % 4)}m",
                                         memory="256Mi") for i in range(12)])
        sched.pump()
        sched.schedule_pending_batch()
        sched.pump()
        got = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]
               if p.meta.name.startswith(f"w{w}-")}
        out["waves"].append(got)
        return got

    try:
        first = wave(0)
        counts: dict = {}
        for n in first.values():
            counts[n] = counts.get(n, 0) + 1
        target = max(sorted(counts), key=lambda n: counts[n])
        code, node = _patch(f"{server.url}/api/v1/namespaces/-/nodes/{target}",
                            {"spec": {"unschedulable": True}},
                            "application/strategic-merge-patch+json")
        out["cordon"] = (target, code, node["spec"]["unschedulable"])
        state = {"Node": store.list("Node")[0], "Pod": store.list("Pod")[0]}
        rr = algo._round_robin
        assert target not in wave(1).values()
        if which == "port":
            # the per-pod oracle replayed over the cluster as read back
            # before the wave (chip_smoke 13a's check) binds it alike
            from kubernetes_tpu_torch.workload import oracle_replay_state

            arrivals = [d for d in store.list("Pod")[0]
                        if d["metadata"]["name"].startswith("w1-")]
            for d in arrivals:
                d["spec"].pop("nodeName", None)
            oracle = oracle_replay_state(state, arrivals, rr)
            assert oracle["assignments"] == {f"default/{k}": v
                                             for k, v in out["waves"][1].items()}
            assert oracle["round_robin"] == algo._round_robin
        code, node = _patch(f"{server.url}/api/v1/namespaces/-/nodes/{target}",
                            [{"op": "replace", "path": "/spec/unschedulable", "value": False}],
                            "application/json-patch+json")
        out["uncordon"] = (code, node["spec"]["unschedulable"])
        wave(2)
        out["rr"] = algo._round_robin
        return out
    finally:
        server.stop()
        sched.informers.stop_all()


def test_a_cordon_patch_moves_the_next_batch_as_the_reference_does():
    want, got = _cordon_run("jax"), _cordon_run("port")
    assert got == want
    target = got["cordon"][0]
    assert got["cordon"][1:] == (200, True) and got["uncordon"] == (200, False)
    assert all(got["waves"][w][k] for w in range(3) for k in got["waves"][w])
    assert target in got["waves"][0].values() and target not in got["waves"][1].values()
    assert target in got["waves"][2].values()
