"""Twins of ``tests/test_kubelet_depth.py`` on the port's kubelet: probes
driving restarts and readiness, restart policy, QoS classes, memory
pressure eviction, and the kubelet server's logs and exec.

Each twin runs the JAX test's scenario through both packages (``both``)
on the same fake clock and holds the outcomes equal: pod phases, reasons,
restart counts, container states, the Ready condition, node conditions,
eviction order, HTTP status codes and bodies.  Exact.

The halves that go through the apiserver run in
``tests/test_torch_kubelet_proxies.py``: the Endpoints half of the
readiness test, the apiserver and ``kubectl logs`` half of the logs
test, and the ``kubectl exec`` and discovery/``top pods`` tests, each
whole through both packages."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from tests.torch_kubelet_pkg import FakeClock, both


def _world(P, serve=False):
    cs = P.Clientset(P.Store())
    clock = FakeClock()
    k = P.HollowKubelet(cs, "n1", pod_start_latency=0.0, clock=clock, memory="1Gi",
                        serve=serve)
    k.register()
    return cs, clock, k


def probe_pod(P, name, liveness=None, readiness=None, restart_policy="Always",
              labels=None, resources=None):
    api = P.api
    return api.Pod(
        meta=api.ObjectMeta(name=name, namespace="default", labels=labels or {}),
        spec=api.PodSpec(
            containers=[api.Container(name="c", liveness_probe=liveness,
                                      readiness_probe=readiness,
                                      resources=resources or api.ResourceRequirements())],
            node_name="n1",
            restart_policy=restart_policy,
        ),
    )


def start(cs, k, pod):
    cs.pods.create(pod)
    k.tick()  # observe
    k.tick()  # start (latency 0)
    k.tick()  # first runtime sync publishes container statuses
    return cs.pods.get(pod.meta.name, "default")


def _status(pod):
    s = pod.status
    return (s.phase, s.reason, [c.to_dict() for c in s.container_statuses],
            sorted((c.get("type"), c.get("status")) for c in s.conditions))


def test_pod_starts_with_ready_containers():
    def scenario(P):
        cs, clock, k = _world(P)
        got = start(cs, k, probe_pod(P, "p"))
        assert got.status.phase == "Running"
        assert got.status.container_statuses[0].ready is True
        ready = [c for c in got.status.conditions if c.get("type") == "Ready"]
        assert ready and ready[0]["status"] == "True"
        return _status(got)

    both(scenario)


def test_liveness_failures_restart_after_threshold():
    def scenario(P):
        cs, clock, k = _world(P)
        start(cs, k, probe_pod(P, "p", liveness=P.api.Probe(period_seconds=1,
                                                            failure_threshold=3)))
        k.runtime.set_probe("default/p", "c", "liveness", False)
        for _ in range(3):
            clock.advance(1.0)
            k.tick()
        got = cs.pods.get("p", "default")
        assert got.status.container_statuses[0].restart_count == 1
        assert got.status.phase == "Running"
        mid = _status(got)
        k.runtime.set_probe("default/p", "c", "liveness", True)
        for _ in range(5):
            clock.advance(1.0)
            k.tick()
        got = cs.pods.get("p", "default")
        assert got.status.container_statuses[0].restart_count == 1
        return mid, _status(got), k.runtime.read_logs("default/p", "c")

    both(scenario)


def test_readiness_flips_pod_ready_condition():
    """The Ready-condition half of the JAX readiness test: a failing
    readiness probe turns the pod's Ready condition and the container's
    ready bit off, and a passing one turns them back on."""

    def scenario(P):
        cs, clock, k = _world(P)
        p = probe_pod(P, "p", readiness=P.api.Probe(period_seconds=1, failure_threshold=1),
                      labels={"app": "web"})
        seen = [_status(start(cs, k, p))]
        k.runtime.set_probe("default/p", "c", "readiness", False)
        clock.advance(1.0)
        k.tick()
        got = cs.pods.get("p", "default")
        assert {"type": "Ready", "status": "False"} in got.status.conditions
        assert got.status.container_statuses[0].ready is False
        seen.append(_status(got))
        k.runtime.set_probe("default/p", "c", "readiness", True)
        clock.advance(1.0)
        k.tick()
        got = cs.pods.get("p", "default")
        assert {"type": "Ready", "status": "True"} in got.status.conditions
        seen.append(_status(got))
        return seen

    both(scenario)


def test_restart_policy_never_terminal_phase():
    def scenario(P):
        cs, clock, k = _world(P)
        start(cs, k, probe_pod(P, "p", restart_policy="Never"))
        k.runtime.inject_exit("default/p", "c", 1)
        clock.advance(1.0)
        k.tick()
        got = cs.pods.get("p", "default")
        st = got.status.container_statuses[0]
        assert (got.status.phase, st.state, st.exit_code) == ("Failed", "terminated", 1)
        return _status(got)

    both(scenario)


def test_restart_policy_on_failure():
    def scenario(P):
        cs, clock, k = _world(P)
        start(cs, k, probe_pod(P, "p", restart_policy="OnFailure"))
        k.runtime.inject_exit("default/p", "c", 1)
        clock.advance(1.0)
        k.tick()
        mid = _status(cs.pods.get("p", "default"))
        assert cs.pods.get("p", "default").status.container_statuses[0].restart_count == 1
        k.runtime.inject_exit("default/p", "c", 0)
        clock.advance(1.0)
        k.tick()
        assert cs.pods.get("p", "default").status.phase == "Succeeded"
        return mid, _status(cs.pods.get("p", "default"))

    both(scenario)


def test_qos_classes():
    def scenario(P):
        api, rt = P.api, P.runtime
        Q = api.Quantity
        be = probe_pod(P, "a")
        bu = probe_pod(P, "b", resources=api.ResourceRequirements(requests={"cpu": Q("100m")}))
        gu = probe_pod(P, "c", resources=api.ResourceRequirements(
            requests={"cpu": Q("1"), "memory": Q("1Gi")},
            limits={"cpu": Q("1"), "memory": Q("1Gi")}))
        got = [rt.pod_qos_class(p) for p in (be, bu, gu)]
        assert got == [rt.QOS_BEST_EFFORT, rt.QOS_BURSTABLE, rt.QOS_GUARANTEED]
        return got

    both(scenario)


def test_memory_pressure_evicts_best_effort_first():
    def scenario(P):
        api = P.api
        Q = api.Quantity
        cs, clock, k = _world(P)
        gu = probe_pod(P, "precious", resources=api.ResourceRequirements(
            requests={"cpu": Q("1"), "memory": Q("256Mi")},
            limits={"cpu": Q("1"), "memory": Q("256Mi")}))
        start(cs, k, gu)
        start(cs, k, probe_pod(P, "disposable"))
        m = 1 << 20
        k.runtime.pod_memory_usage = {"default/precious": 700 * m,
                                      "default/disposable": 400 * m}
        clock.advance(1.0)
        res = k.tick()
        assert res["evicted"] == 1
        d = cs.pods.get("disposable", "default")
        assert (d.status.reason, d.status.phase) == ("Evicted", "Failed")
        assert cs.pods.get("precious", "default").status.phase == "Running"
        during = cs.nodes.get("n1").status.condition("MemoryPressure").status
        assert during == "True"
        clock.advance(1.0)
        k.tick()
        after = cs.nodes.get("n1").status.condition("MemoryPressure").status
        assert after == "False"
        order = [p.meta.name for p in P.runtime.rank_for_eviction(
            [cs.pods.get("precious", "default"), d], k.runtime.pod_memory_usage)]
        return res, _status(d), during, after, order

    both(scenario)


def test_pod_completing_during_pressure_is_not_marked_evicted():
    def scenario(P):
        cs, clock, k = _world(P)
        start(cs, k, probe_pod(P, "done", restart_policy="Never"))
        start(cs, k, probe_pod(P, "hog"))
        k.runtime.inject_exit("default/done", "c", 0)
        m = 1 << 20
        k.runtime.pod_memory_usage = {"default/done": 600 * m, "default/hog": 600 * m}
        clock.advance(1.0)
        r = k.tick()
        done, hog = cs.pods.get("done", "default"), cs.pods.get("hog", "default")
        assert done.status.phase == "Succeeded"
        assert (hog.status.phase, hog.status.reason) == ("Running", "")
        return r, _status(done), _status(hog)

    both(scenario)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.timeout(60)
def test_pod_logs_through_kubelet_server():
    """The kubelet-server half of the JAX logs test: the node registers
    its server's URL and serves container logs, whole and tailed."""

    def scenario(P):
        cs, clock, k = _world(P, serve=True)
        try:
            assert cs.nodes.get("n1").status.kubelet_url == k.server.url
            start(cs, k, probe_pod(P, "p"))
            k.runtime.append_log("default/p", "c", "hello from the app")
            code, body = _get(f"{k.server.url}/containerLogs/default/p/c")
            assert code == 200
            assert "container c started" in body and "hello from the app" in body
            tail = _get(f"{k.server.url}/containerLogs/default/p/c?tailLines=1")
            assert tail == (200, "hello from the app\n")
            return code, body, tail
        finally:
            k.server.stop()

    both(scenario)


@pytest.mark.timeout(60)
def test_log_path_traversal_and_stale_buffers_blocked():
    """The kubelet-server half of the JAX test: a traversal in the
    container segment reaches no other endpoint, a bad ``tailLines`` is a
    400, and a pod deleted and created again starts with fresh logs."""

    def scenario(P):
        cs, clock, k = _world(P, serve=True)
        try:
            start(cs, k, probe_pod(P, "p"))
            url = k.server.url
            codes = [_get(f"{url}/containerLogs/default/p/../../pods")[0],
                     _get(f"{url}/containerLogs/default/p/..%2F..%2Fpods")[0],
                     _get(f"{url}/containerLogs/default/p/c?tailLines=abc")[0]]
            assert codes[2] == 400 and 200 not in codes
            cs.pods.delete("p", "default")
            k.tick()
            start(cs, k, probe_pod(P, "p"))
            code, body = _get(f"{url}/containerLogs/default/p/c")
            assert code == 200 and body.count("container c started") == 1
            return codes, body
        finally:
            k.server.stop()

    both(scenario)


@pytest.mark.timeout(60)
def test_kubelet_exec_endpoint_requires_the_cluster_credential():
    def scenario(P):
        cs, clock, k = _world(P, serve=True)
        try:
            start(cs, k, probe_pod(P, "p"))
            req = urllib.request.Request(
                f"{k.server.url}/exec/default/p/c",
                data=json.dumps({"command": ["id"]}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 401
            token = P.authn.kubelet_exec_token("n1")
            req.add_header("Authorization", f"Bearer {token}")
            with urllib.request.urlopen(req, timeout=10) as r:
                body = json.loads(r.read())
            assert body["exitCode"] == 0
            return ei.value.code, token, body
        finally:
            k.server.stop()

    both(scenario)
