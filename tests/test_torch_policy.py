"""The scheduler's policy surface in the port (``scheduler/policy.py``,
``scheduler/extender.py``, the two policy-only predicate factories)
against the JAX package, on the CPU.

- Twins of the five policy and extender cases of
  ``tests/test_policy_extender_leader.py`` (:31-127), the extender a local
  HTTP server as there: each case runs in both packages and must give the
  same selections, errors and bindings.
- The upstream ``ClusterAutoscalerProvider`` as a policy document through
  ``load_policy_file``: ``BatchBackend(device="cpu")`` (the scan with the
  ``most`` weight plane) equals the JAX ``TPUBatchBackend`` and the
  sequential oracle on the seeded ``mixed`` cluster; a policy the scan does
  not express schedules the batch on the oracle in both packages.
- ``CheckNodeLabelPresence`` and ``CheckServiceAffinity`` from a policy,
  against the JAX package.

Tolerance: exact equality of every binding and of the round-robin counter.
The JAX package is imported inside the tests that compare with it.
"""

from __future__ import annotations

import http.server
import importlib
import json
import threading

import pytest

from tests import torch_port_cases as cases


def _policy(pkg: str):
    return importlib.import_module(f"{pkg}.scheduler.policy")


def _build_map(M, nodes):
    return {n.meta.name: M.NodeInfo(n) for n in nodes}


# -- providers and policy documents (:31-76) ----------------------------------


def _provider_names(pkg: str) -> tuple:
    P = _policy(pkg)
    out = []
    for name in ("DefaultProvider", "ClusterAutoscalerProvider"):
        algo = P.algorithm_from_provider(name)
        out.append(([(type(p).__name__, w) for p, w in algo.priorities], sorted(algo.predicates)))
    with pytest.raises(P.PolicyError):
        P.algorithm_from_provider("NoSuch")
    return tuple(out)


def test_provider_selection_equals_the_jax_package():
    got = _provider_names(cases.PORT)
    assert got == _provider_names(cases.JAX)
    default, ca = ({n for n, _ in prios} for prios, _ in got)
    assert "LeastRequestedPriority" in default and "MostRequestedPriority" not in default
    assert "MostRequestedPriority" in ca and "LeastRequestedPriority" not in ca


def _policy_bin_pack(pkg: str) -> tuple:
    M = cases.mods(pkg)
    algo = _policy(pkg).algorithm_from_policy(json.dumps({
        "predicates": [{"name": "GeneralPredicates"}, {"name": "PodToleratesNodeTaints"}],
        "priorities": [{"name": "MostRequestedPriority", "weight": 3}]}))
    m = _build_map(M, [M.tu.make_node("n1", cpu="4"), M.tu.make_node("n2", cpu="4")])
    m["n1"].add_pod(M.tu.make_pod("e", cpu="2", node_name="n1"))
    res = algo.schedule(M.tu.make_pod("p", cpu="1"), m)
    return (sorted(algo.predicates), [(type(p).__name__, w) for p, w in algo.priorities],
            res.node_name)


def test_policy_json_selects_and_weights_as_the_jax_package():
    got = _policy_bin_pack(cases.PORT)
    assert got == _policy_bin_pack(cases.JAX)
    assert got == (["GeneralPredicates", "PodToleratesNodeTaints"],
                   [("MostRequestedPriority", 3)], "n1")  # bin-pack: the fuller node


@pytest.mark.parametrize("pkg", [cases.PORT, cases.JAX])
def test_policy_rejects_unknown_names(pkg):
    P = _policy(pkg)
    for bad in ({"predicates": [{"name": "Nope"}]}, {"priorities": [{"name": "Nope"}]},
                {"priorities": [{"name": "EqualPriority", "weight": 0}]}):
        with pytest.raises(P.PolicyError):
            P.algorithm_from_policy(bad)


# -- the extender over HTTP (:79-127) ------------------------------------------


class ExtenderHandler(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        if self.path == "/filter":
            # refuse any node ending in 0
            keep = [n for n in body["nodeNames"] if not n.endswith("0")]
            failed = {n: "ends in 0" for n in body["nodeNames"] if n.endswith("0")}
            out = {"nodeNames": keep, "failedNodes": failed}
        elif self.path == "/prioritize":
            # strongly prefer n3
            out = [{"host": n, "score": 100 if n == "n3" else 0} for n in body["nodeNames"]]
        else:
            self.send_error(404)
            return
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def extender_server():
    server = http.server.HTTPServer(("127.0.0.1", 0), ExtenderHandler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


def _extender_filter_and_prioritize(pkg: str, url: str) -> tuple:
    M = cases.mods(pkg)
    ext_mod = importlib.import_module(f"{pkg}.scheduler.extender")
    pred = importlib.import_module(f"{pkg}.scheduler.predicates")
    ext = ext_mod.HTTPExtender(url, filter_verb="filter", prioritize_verb="prioritize")
    algo = M.gs.GenericScheduler(extenders=[ext])
    m = _build_map(M, [M.tu.make_node(f"n{i}") for i in range(5)])
    res = algo.schedule(M.tu.make_pod("p", cpu="100m"), m)
    feasible, failures = algo.find_nodes_that_fit(
        M.tu.make_pod("q", cpu="100m"), sorted(m), m, pred.PredicateContext(m))
    return res.node_name, feasible, failures


@pytest.mark.timeout(60)
def test_extender_filter_and_prioritize_as_the_jax_package(extender_server):
    got = _extender_filter_and_prioritize(cases.PORT, extender_server)
    assert got == _extender_filter_and_prioritize(cases.JAX, extender_server)
    node, feasible, failures = got
    assert node == "n3"  # the extender's score dominates
    assert "n0" not in feasible and failures["n0"] == ["ends in 0"]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", [cases.PORT, cases.JAX])
def test_extender_via_policy(pkg, extender_server):
    M = cases.mods(pkg)
    algo = _policy(pkg).algorithm_from_policy(
        {"extenders": [{"urlPrefix": extender_server, "filterVerb": "filter"}]})
    with pytest.raises(M.gs.FitError):
        algo.schedule(M.tu.make_pod("p"), _build_map(M, [M.tu.make_node("n0")]))


@pytest.mark.timeout(60)
def test_extender_errors_name_the_hook(extender_server):
    from kubernetes_tpu_torch.scheduler.extender import ExtenderError, HTTPExtender

    ext = HTTPExtender(extender_server + "/nowhere", filter_verb="filter", timeout=5.0)
    with pytest.raises(ExtenderError, match="/nowhere/filter"):
        ext.filter(cases.mods(cases.PORT).tu.make_pod("p"), ["n1"])
    assert HTTPExtender.from_config({"urlPrefix": "http://x/", "bindVerb": "bind"}).is_binder()


# -- a policy file on the batch backend -----------------------------------------

# the upstream ClusterAutoscalerProvider as a document: the default
# predicates, MostRequested in place of LeastRequested, the default weights
AUTOSCALER_POLICY = {
    "predicates": [{"name": n} for n in (
        "CheckNodeSchedulable", "CheckNodeCondition", "NoDiskConflict", "MaxVolumeCount",
        "NoVolumeZoneConflict", "NoVolumeNodeConflict", "GeneralPredicates",
        "PodToleratesNodeTaints", "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
        "MatchInterPodAffinity")],
    "priorities": [
        {"name": "SelectorSpreadPriority", "weight": 1},
        {"name": "InterPodAffinityPriority", "weight": 1},
        {"name": "MostRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "NodePreferAvoidPodsPriority", "weight": 10000},
        {"name": "NodeAffinityPriority", "weight": 1},
        {"name": "TaintTolerationPriority", "weight": 1}],
}


def _batch_under_policy(pkg: str, path: str, policy: dict) -> tuple:
    """(bindings, rr) of the package's batch backend and of its sequential
    oracle, both on the algorithm ``load_policy_file`` builds."""
    load = _policy(pkg).load_policy_file
    m, pods, pctx = cases.mixed(pkg, seed=11, n_nodes=16, n_pods=80)
    oracle = load(path)
    want = cases.oracle_batch(pkg, pods, m, pctx, oracle)
    algo = load(path)
    if pkg == cases.JAX:
        from kubernetes_tpu.ops.backend import TPUBatchBackend

        backend = TPUBatchBackend(algorithm=algo, kernel_impl="xla")
    else:
        from kubernetes_tpu_torch.ops.backend import BatchBackend

        backend = BatchBackend(algorithm=algo, device="cpu")
    got = backend.schedule_batch(pods, m, pctx)
    assert got == want and algo._round_robin == oracle._round_robin
    return got, algo._round_robin, backend


def test_autoscaler_policy_file_runs_the_scan_with_the_most_plane(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(AUTOSCALER_POLICY))
    got, rr, backend = _batch_under_policy(cases.PORT, str(path), AUTOSCALER_POLICY)
    want, rr_want, _ = _batch_under_policy(cases.JAX, str(path), AUTOSCALER_POLICY)
    assert got == want and rr == rr_want and sum(1 for n in got if n) > 0
    assert backend.stats["oracle_pods"] == 0 and backend.stats["kernel_pods"] == len(got)
    weights = backend._config_supported()
    assert weights["most"] == 1 and weights["least"] == 0
    provider = _policy(cases.PORT).algorithm_from_provider("ClusterAutoscalerProvider")
    assert [(type(p), w) for p, w in backend.algorithm.priorities] == [
        (type(p), w) for p, w in provider.priorities]
    assert backend.algorithm.predicates == provider.predicates


def test_policy_the_scan_cannot_express_runs_on_the_oracle_in_both(tmp_path):
    policy = {"priorities": [{"name": "ServiceSpreadingPriority", "weight": 2},
                             {"name": "LeastRequestedPriority", "weight": 1}]}
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(policy))
    got, rr, backend = _batch_under_policy(cases.PORT, str(path), policy)
    want, rr_want, _ = _batch_under_policy(cases.JAX, str(path), policy)
    assert got == want and rr == rr_want
    assert backend.stats["oracle_pods"] == len(got) and backend.stats["kernel_pods"] == 0


def _label_and_service_policy(pkg: str) -> list:
    M = cases.mods(pkg)
    api = M.api
    algo = _policy(pkg).algorithm_from_policy({"predicates": [
        {"name": "GeneralPredicates"},
        {"name": "OnSsd", "argument": {"labelsPresence": {"labels": ["ssd"], "presence": True}}},
        {"name": "SameRegion", "argument": {"serviceAffinity": {"labels": ["region"]}}}]})
    m = _build_map(M, [M.tu.make_node(f"n{i}", labels={"region": f"r{i % 2}", **(
        {"ssd": "yes"} if i != 2 else {})}) for i in range(5)])
    m["n3"].add_pod(M.tu.make_pod("first", labels={"app": "web"}, node_name="n3"))
    pctx = M.PriorityContext(m, services=[api.Service(meta=api.ObjectMeta(name="web"),
                                                      selector={"app": "web"})])
    out = []
    for pod in (M.tu.make_pod("w", labels={"app": "web"}), M.tu.make_pod("o")):
        feasible, failures = algo.find_nodes_that_fit(
            pod, sorted(m), m, importlib.import_module(
                f"{pkg}.scheduler.predicates").PredicateContext(m, services=pctx.services))
        out.append((feasible, failures))
    return out


def test_label_presence_and_service_affinity_predicates_as_the_jax_package():
    got = _label_and_service_policy(cases.PORT)
    assert got == _label_and_service_policy(cases.JAX)
    (web, _), (other, failures) = got
    assert web == ["n1", "n3"]  # ssd, and the region the first web pod pinned
    assert other == ["n0", "n1", "n3", "n4"] and "n2" in failures
