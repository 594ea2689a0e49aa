"""Twins of ``tests/test_api_extended.py`` :54-248 on the port's kinds
(``api/apps.py``, ``api/cluster.py``, ``api/crd.py``, ``api/rbac.py`` and
``api/types.py``), and seeded round trips of every kind the registry holds.

Each twin builds the same objects in both packages (``build(api)`` takes
either package's ``api`` module), round-trips each through
``to_dict``/``from_dict``, and holds the two packages' wire dicts equal,
then asserts what the JAX test asserts.  The seeded round trips fill every
leaf of each kind's default wire form with seeded values of the leaf's
type and decode the document in both packages.  The registries' kind
sets, plurals, scopes and the ``api`` export lists are equal.  All exact.
"""

from __future__ import annotations

import copy
import inspect
import random

import pytest

import kubernetes_tpu.api as jax_api
import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu.federation.types  # noqa: F401  (registers Cluster, as the apiserver does)
import kubernetes_tpu_torch.api as port_api
import kubernetes_tpu_torch.api.types as port_types
import kubernetes_tpu_torch.federation.types  # noqa: F401

# the kinds this slice registered in the port
NEW_KINDS = ("APIService", "CertificateSigningRequest", "CustomResourceDefinition", "CronJob",
             "DaemonSet", "Deployment", "Job", "StatefulSet", "Endpoints",
             "HorizontalPodAutoscaler", "PodDisruptionBudget", "ReplicationController")


def roundtrip(obj, types_mod):
    d = obj.to_dict()
    again = types_mod.from_dict(d)
    assert again.to_dict() == d, f"{obj.KIND} round-trip mismatch"
    return again


def both(build):
    """``build(api)`` in each package; every object round-trips, and the two
    packages' wire dicts are equal.  Returns the port's round-tripped
    objects."""
    jax_objs, port_objs = build(jax_api), build(port_api)
    assert len(jax_objs) == len(port_objs)
    out = []
    for j, p in zip(jax_objs, port_objs):
        jd, pd = roundtrip(j, jax_types).to_dict(), roundtrip(p, port_types)
        assert pd.to_dict() == jd
        out.append(pd)
    return out


def test_job_roundtrip_and_conditions():
    def build(api):
        return [api.Job(meta=api.ObjectMeta(name="burn", namespace="batchns"), parallelism=3,
                        completions=None, backoff_limit=2,
                        selector=api.LabelSelector(match_labels={"job": "burn"}),
                        template=api.PodTemplateSpec(labels={"job": "burn"}),
                        status_conditions=[{"type": "Complete", "status": "True"}])]

    (again,) = both(build)
    assert again.completions is None
    assert again.complete and not again.failed


def test_cronjob_roundtrip():
    (again,) = both(lambda api: [api.CronJob(
        meta=api.ObjectMeta(name="tick"), schedule="*/5 * * * *", concurrency_policy="Forbid",
        job_template={"parallelism": 1}, status_active=["tick-001"])])
    assert again.schedule == "*/5 * * * *"
    assert again.status_active == ["tick-001"]


def test_daemonset_statefulset_roundtrip():
    def build(api):
        return [api.DaemonSet(meta=api.ObjectMeta(name="agent"),
                              selector=api.LabelSelector(match_labels={"ds": "agent"}),
                              status_desired=5),
                api.StatefulSet(meta=api.ObjectMeta(name="db"), replicas=3, service_name="db",
                                pod_management_policy="Parallel")]

    ds, ss = both(build)
    assert ds.status_desired == 5
    assert ss.pod_management_policy == "Parallel"
    # one class under the kind: the full one
    assert port_types.KINDS["StatefulSet"] is port_api.StatefulSet


def test_namespace_cluster_scoped_and_phase():
    (ns,) = both(lambda api: [api.Namespace(meta=api.ObjectMeta(name="prod"))])
    assert ns.meta.namespace == ""
    assert ns.phase == "Active"
    assert ns.spec_finalizers == ["kubernetes"]


def test_quota_limitrange_roundtrip():
    def build(api):
        Q = api.Quantity
        return [api.ResourceQuota(meta=api.ObjectMeta(name="compute", namespace="prod"),
                                  hard={"cpu": Q("10"), "pods": Q("50")},
                                  used={"cpu": Q("2")}),
                api.LimitRange(meta=api.ObjectMeta(name="defaults", namespace="prod"),
                               limits=[api.LimitRangeItem(type="Container",
                                                          default_request={"cpu": Q("100m")},
                                                          max={"memory": Q("1Gi")})])]

    rq, lr = both(build)
    assert rq.hard["pods"] == port_api.Quantity("50")
    assert lr.limits[0].default_request["cpu"] == port_api.Quantity("100m")


def test_endpoints_roundtrip():
    (ep,) = both(lambda api: [api.Endpoints(
        meta=api.ObjectMeta(name="web", namespace="prod"),
        subsets=[api.EndpointSubset(
            addresses=[api.EndpointAddress(ip="10.0.0.1", target_pod="prod/web-1")],
            not_ready_addresses=[api.EndpointAddress(ip="10.0.0.2")],
            ports=[api.EndpointPort(name="http", port=8080)])])])
    assert ep.subsets[0].addresses[0].ip == "10.0.0.1"
    assert ep.subsets[0].not_ready_addresses[0].ip == "10.0.0.2"


def test_pv_pvc_priorityclass_csr_roundtrip():
    def build(api):
        Q = api.Quantity
        return [api.PersistentVolume(meta=api.ObjectMeta(name="disk-1"),
                                     capacity={"storage": Q("100Gi")}, zone="zone-a",
                                     phase="Available"),
                api.PersistentVolumeClaim(meta=api.ObjectMeta(name="claim", namespace="prod"),
                                          request_storage=Q("10Gi")),
                api.PriorityClass(meta=api.ObjectMeta(name="critical"), value=1000,
                                  global_default=True),
                api.CertificateSigningRequest(meta=api.ObjectMeta(name="node-1-csr"),
                                              request="csr-bytes",
                                              username="system:node:node-1",
                                              conditions=[{"type": "Approved"}])]

    pv, pvc, pc, csr = both(build)
    assert pv.meta.namespace == "" and pv.zone == "zone-a"
    assert pvc.request_storage == port_api.Quantity("10Gi")
    assert pc.value == 1000
    assert csr.approved and not csr.denied


def test_pdb_hpa_roundtrip():
    def build(api):
        return [api.PodDisruptionBudget(meta=api.ObjectMeta(name="web-pdb", namespace="prod"),
                                        min_available=2,
                                        selector=api.LabelSelector(match_labels={"app": "web"}),
                                        status_disruptions_allowed=1),
                api.HorizontalPodAutoscaler(meta=api.ObjectMeta(name="web-hpa",
                                                                namespace="prod"),
                                            target_name="web", min_replicas=2, max_replicas=10,
                                            target_cpu_utilization=50)]

    pdb, hpa = both(build)
    assert pdb.status_disruptions_allowed == 1
    assert hpa.max_replicas == 10


def test_rbac_roundtrip_and_rule_matching():
    rule = port_api.PolicyRule(verbs=["get", "list"], resources=["pods"])
    assert rule.matches("get", "pods")
    assert not rule.matches("delete", "pods")
    assert not rule.matches("get", "nodes")
    assert port_api.PolicyRule(verbs=["*"], resources=["*"]).matches("anything", "whatever")
    named = port_api.PolicyRule(verbs=["get"], resources=["secrets"], resource_names=["tok"])
    assert named.matches("get", "secrets", "tok")
    assert not named.matches("get", "secrets", "other")

    def build(api):
        rule = api.PolicyRule(verbs=["get", "list"], resources=["pods"])
        star = api.PolicyRule(verbs=["*"], resources=["*"])
        return [api.Role(meta=api.ObjectMeta(name="reader", namespace="prod"), rules=[rule]),
                api.ClusterRole(meta=api.ObjectMeta(name="admin"), rules=[star]),
                api.RoleBinding(meta=api.ObjectMeta(name="rb", namespace="prod"),
                                subjects=[api.Subject(kind="User", name="alice")],
                                role_name="reader"),
                api.ClusterRoleBinding(meta=api.ObjectMeta(name="crb"),
                                       subjects=[api.Subject(kind="Group", name="ops")],
                                       role_name="admin")]

    role, cr, rb, crb = both(build)
    assert role.rules[0].verbs == ["get", "list"]
    assert cr.meta.namespace == ""
    assert rb.subjects[0].name == "alice"
    assert crb.role_kind == "ClusterRole"


def test_secret_configmap_serviceaccount_roundtrip():
    def build(api):
        return [api.Secret(meta=api.ObjectMeta(name="tok"), data={"k": "djE="}),
                api.ConfigMap(meta=api.ObjectMeta(name="cfg"), data={"a": "1"}),
                api.ServiceAccount(meta=api.ObjectMeta(name="default"),
                                   secrets=["default-token"])]

    sec, cm, sa = both(build)
    assert sec.data["k"] == "djE=" and cm.data["a"] == "1"
    assert sa.secrets == ["default-token"]


def test_service_ports_and_probe_roundtrip():
    def build(api):
        return [api.Service(meta=api.ObjectMeta(name="web", namespace="prod"),
                            selector={"app": "web"},
                            ports=[api.ServicePort(name="http", port=80, target_port=8080)],
                            cluster_ip="10.96.0.10", session_affinity="ClientIP")]

    (svc,) = both(build)
    assert svc.ports[0].target_port == 8080
    assert svc.session_affinity == "ClientIP"

    def container(api):
        return api.Container(name="app", image="app:v1",
                             liveness_probe=api.Probe(handler="http", period_seconds=5),
                             readiness_probe=api.Probe(handler="tcp"))

    d = container(port_api).to_dict()
    assert d == container(jax_api).to_dict()
    again = port_api.Container.from_dict(d)
    assert again.liveness_probe.period_seconds == 5
    assert again.readiness_probe.handler == "tcp"


def test_clientset_has_all_kind_clients():
    from kubernetes_tpu.client.clientset import Clientset as JaxClientset
    from kubernetes_tpu.store.store import Store as JaxStore
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.store.store import Store

    reads = []
    for api, cs in ((jax_api, JaxClientset(JaxStore())), (port_api, Clientset(Store()))):
        ns = cs.namespaces.create(api.Namespace(meta=api.ObjectMeta(name="prod")))
        assert ns.meta.uid
        assert cs.namespaces.get("prod").phase == "Active"
        cs.jobs.create(api.Job(meta=api.ObjectMeta(name="j1", namespace="default")))
        assert cs.jobs.get("j1").meta.name == "j1"
        cs.priorityclasses.create(api.PriorityClass(meta=api.ObjectMeta(name="high"),
                                                    value=10))
        assert cs.priorityclasses.get("high").value == 10
        # a client for every registered kind, under its plural
        for kind, plural in api.types.KIND_PLURALS.items():
            assert cs.client_for(kind) is (cs.pods if kind == "Pod" else getattr(cs, plural))
        reads.append(sorted(api.types.KINDS))
    assert reads[0] == reads[1]


# -- the registries and seeded round trips of every kind ----------------------


def test_registries_and_exports_equal_the_reference():
    # the 34 kinds of the API and federation's Cluster
    assert set(port_types.KINDS) == set(jax_types.KINDS)
    assert len(port_types.KINDS) == 35
    assert set(NEW_KINDS) <= set(port_types.KINDS)
    for kind in port_types.KINDS:
        assert port_types.KIND_PLURALS[kind] == jax_types.KIND_PLURALS[kind]
    assert port_types.CLUSTER_SCOPED_KINDS == jax_types.CLUSTER_SCOPED_KINDS

    def exports(mod):
        return {n for n in dir(mod)
                if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))}

    assert exports(port_api) == exports(jax_api)


_ADDRESS = {"ip": "", "nodeName": "", "targetPod": ""}
# the member shape of a list that is empty in a kind's default wire form
_MEMBERS = {
    "subsets": {"addresses": [_ADDRESS], "notReadyAddresses": [_ADDRESS],
                "ports": [{"name": "", "port": 0, "protocol": ""}]},
    "conditions": {"type": "", "status": ""},
}


def _fill(value, rng: random.Random, key: str = ""):
    """``value`` (a default wire form) with every leaf replaced by a seeded
    value of the leaf's type; lists get one to three seeded members."""
    if isinstance(value, bool):
        return rng.random() < 0.5
    if isinstance(value, int):
        return rng.randint(0, 1000)
    if isinstance(value, float):
        return float(rng.randint(0, 10_000))
    if isinstance(value, str):
        return f"s{rng.randint(0, 99)}"
    if isinstance(value, dict):
        return {k: _fill(v, rng, k) for k, v in value.items()}
    if isinstance(value, list):
        member = value[0] if value else _MEMBERS.get(key, "")
        return [_fill(member, rng) for _ in range(rng.randint(1, 3))]
    return value


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_seeded_documents_decode_alike(kind):
    """Seeded wire documents of each new kind decode to the same object in
    both packages: ``from_dict(d).to_dict()`` is equal, and stable under a
    second round trip."""
    rng = random.Random(sum(map(ord, kind)))
    template = port_types.KINDS[kind]().to_dict()
    assert template == jax_types.KINDS[kind]().to_dict()
    for _ in range(20):
        d = _fill(copy.deepcopy(template), rng)
        d["kind"] = kind
        d["metadata"] = {"name": f"o{rng.randint(0, 9)}", "namespace": "default",
                         "labels": {"app": f"a{rng.randint(0, 3)}"}}
        spec = d.get("spec")
        if isinstance(spec, dict) and "selector" in spec:
            # a LabelSelector, or ReplicationController's plain map
            labels = {"app": f"a{rng.randint(0, 3)}"}
            spec["selector"] = (labels if kind == "ReplicationController"
                                else {"matchLabels": labels})
        if kind in ("Job", "Deployment", "StatefulSet", "DaemonSet",
                    "ReplicationController"):
            d["spec"]["template"] = {"metadata": {"labels": {"app": "a1"}},
                                     "spec": {"containers": [{"name": "c", "image": "i"}]}}
        want = jax_types.from_dict(copy.deepcopy(d)).to_dict()
        got = port_types.from_dict(copy.deepcopy(d)).to_dict()
        assert got == want
        assert port_types.from_dict(got).to_dict() == got


def _custom_kind(api_pkg: str) -> list:
    """A CustomResourceDefinition registered by ``register_custom_kind``
    (the establishing controller is not ported): its kind is in the
    registry, a clientset built before it reaches it through
    ``client_for``, a built-in's name is refused, and unregistering removes
    it."""
    import importlib

    crd_mod = importlib.import_module(f"{api_pkg}.api.crd")
    types = importlib.import_module(f"{api_pkg}.api.types")
    api = importlib.import_module(f"{api_pkg}.api")
    client = importlib.import_module(f"{api_pkg}.client")
    store = importlib.import_module(f"{api_pkg}.store")
    cs = client.Clientset(store.Store())
    crd = crd_mod.CustomResourceDefinition(meta=api.ObjectMeta(name="widgets.example.com"),
                                           kind_name="Widget", plural="widgets",
                                           scope="Cluster")
    cs.customresourcedefinitions.create(crd)
    cls = crd_mod.register_custom_kind(crd)
    try:
        out = [types.KIND_PLURALS["Widget"], "Widget" in types.CLUSTER_SCOPED_KINDS,
               crd_mod.register_custom_kind(crd) is cls]
        widgets = cs.client_for("Widget")
        widgets.create(cls.from_dict({"metadata": {"name": "w1"}, "spec": {"size": 3}}))
        got = widgets.get("w1").to_dict()
        out.append({k: v for k, v in got.items() if k != "metadata"})
        out.append(got["metadata"]["namespace"])
        out.append(crd_mod.register_custom_kind(crd_mod.CustomResourceDefinition(
            meta=api.ObjectMeta(name="pods.example.com"), kind_name="Pod", plural="pods")))
    finally:
        crd_mod.unregister_custom_kind("Widget")
    out.append("Widget" in types.KINDS or "Widget" in types.KIND_PLURALS)
    crd_mod.unregister_custom_kind("Pod")  # a built-in is never removed
    out.append("Pod" in types.KINDS)
    return out


def test_a_custom_kind_registers_and_unregisters_alike():
    got = _custom_kind("kubernetes_tpu_torch")
    assert got == _custom_kind("kubernetes_tpu")
    assert got == ["widgets", True, True, {"kind": "Widget", "spec": {"size": 3}}, "", None,
                   False, True]
