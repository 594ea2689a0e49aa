"""The port's admission chain (``kubernetes_tpu_torch.admission``) against
the JAX package's.

Twins of ``tests/test_admission.py`` (the reference's plugin unit tests,
``plugin/pkg/admission/*/admission_test.go``), then two cross-package
checks: the same seeded requests through the JAX ``AdmittedStore(
default_chain())`` and the port's give equal stored objects (uid and
revisions masked) and equal denials; and pods created one at a time
through each package's admitted store, then scheduled by each package's
batch backend (the port's on ``device="cpu"``) and by the oracle, give
equal chosen nodes and an equal round-robin counter.  Tolerance: exact
equality."""

import json
import threading

import pytest

from kubernetes_tpu_torch.admission import (
    AdmissionDenied,
    AdmittedStore,
    default_chain,
)
from kubernetes_tpu_torch.admission import quota as quotalib
from kubernetes_tpu_torch.api import (
    Container,
    LimitRange,
    LimitRangeItem,
    Namespace,
    ObjectMeta,
    Pod,
    PodSpec,
    PriorityClass,
    Quantity,
    ResourceQuota,
    ResourceRequirements,
    ServiceAccount,
)
from kubernetes_tpu_torch.client.clientset import Clientset


def make_cs() -> Clientset:
    return Clientset(AdmittedStore(default_chain()))


def make_pod(name, ns="default", cpu=None, memory=None, **spec_kw):
    res = ResourceRequirements()
    if cpu:
        res.requests["cpu"] = Quantity(cpu)
    if memory:
        res.requests["memory"] = Quantity(memory)
    return Pod(
        meta=ObjectMeta(name=name, namespace=ns),
        spec=PodSpec(containers=[Container(name="c", resources=res)], **spec_kw),
    )


# -- NamespaceLifecycle -----------------------------------------------------


def test_create_in_missing_namespace_denied():
    cs = make_cs()
    with pytest.raises(AdmissionDenied, match="not found"):
        cs.pods.create(make_pod("p", ns="nope"))


def test_create_in_immortal_and_existing_namespace_ok():
    cs = make_cs()
    cs.pods.create(make_pod("p"))  # default is immortal
    cs.namespaces.create(Namespace(meta=ObjectMeta(name="prod")))
    cs.pods.create(make_pod("p2", ns="prod"))


def test_create_in_terminating_namespace_denied():
    cs = make_cs()
    ns = Namespace(meta=ObjectMeta(name="dying"))
    ns.phase = "Terminating"
    cs.namespaces.create(ns)
    with pytest.raises(AdmissionDenied, match="terminating"):
        cs.pods.create(make_pod("p", ns="dying"))


def test_immortal_namespace_delete_denied():
    cs = make_cs()
    cs.namespaces.create(Namespace(meta=ObjectMeta(name="default")))
    with pytest.raises(AdmissionDenied, match="immortal"):
        cs.namespaces.delete("default")


# -- LimitRanger ------------------------------------------------------------


def test_limitranger_defaults_and_max():
    cs = make_cs()
    cs.limitranges.create(LimitRange(
        meta=ObjectMeta(name="lr", namespace="default"),
        limits=[LimitRangeItem(
            type="Container",
            default_request={"cpu": Quantity("100m")},
            default={"memory": Quantity("256Mi")},
            max={"memory": Quantity("1Gi")},
        )],
    ))
    pod = cs.pods.create(make_pod("defaulted"))
    c = pod.spec.containers[0]
    assert c.resources.requests["cpu"] == Quantity("100m")
    assert c.resources.limits["memory"] == Quantity("256Mi")
    assert c.resources.requests["memory"] == Quantity("256Mi")

    with pytest.raises(AdmissionDenied, match="maximum memory"):
        cs.pods.create(make_pod("fat", memory="2Gi"))


def test_limitranger_min_denied():
    cs = make_cs()
    cs.limitranges.create(LimitRange(
        meta=ObjectMeta(name="lr", namespace="default"),
        limits=[LimitRangeItem(type="Container", min={"cpu": Quantity("50m")})],
    ))
    with pytest.raises(AdmissionDenied, match="minimum cpu"):
        cs.pods.create(make_pod("tiny", cpu="10m"))


# -- ServiceAccount ---------------------------------------------------------


def test_serviceaccount_defaulted_and_missing_denied():
    cs = make_cs()
    pod = cs.pods.create(make_pod("p"))
    assert pod.spec.service_account_name == "default"
    with pytest.raises(AdmissionDenied, match="service account"):
        cs.pods.create(make_pod("p2", service_account_name="deployer"))
    cs.serviceaccounts.create(ServiceAccount(meta=ObjectMeta(name="deployer", namespace="default")))
    cs.pods.create(make_pod("p3", service_account_name="deployer"))


# -- DefaultTolerationSeconds ----------------------------------------------


def test_default_tolerations_added():
    cs = make_cs()
    pod = cs.pods.create(make_pod("p"))
    keys = {t.key: t.toleration_seconds for t in pod.spec.tolerations}
    assert keys.get("node.alpha.kubernetes.io/notReady") == 300
    assert keys.get("node.alpha.kubernetes.io/unreachable") == 300


# -- Priority ---------------------------------------------------------------


def test_priority_class_resolution():
    cs = make_cs()
    cs.priorityclasses.create(PriorityClass(meta=ObjectMeta(name="high"), value=1000))
    pod = cs.pods.create(make_pod("p", priority_class_name="high"))
    assert pod.spec.priority == 1000
    with pytest.raises(AdmissionDenied, match="PriorityClass"):
        cs.pods.create(make_pod("p2", priority_class_name="missing"))


def test_priority_global_default():
    cs = make_cs()
    cs.priorityclasses.create(
        PriorityClass(meta=ObjectMeta(name="standard"), value=7, global_default=True))
    pod = cs.pods.create(make_pod("p"))
    assert pod.spec.priority == 7
    assert pod.spec.priority_class_name == "standard"


# -- anti-affinity topology guard ------------------------------------------


def test_hard_antiaffinity_topology_denied():
    from kubernetes_tpu_torch.api import Affinity, PodAffinityTerm
    from kubernetes_tpu_torch.api.selectors import LabelSelector

    cs = make_cs()
    bad = make_pod("p")
    bad.spec.affinity = Affinity(
        pod_anti_affinity_required=[PodAffinityTerm(
            selector=LabelSelector(match_labels={"app": "x"}),
            topology_key="failure-domain.beta.kubernetes.io/zone",
        )],
    )
    with pytest.raises(AdmissionDenied, match="topologyKey"):
        cs.pods.create(bad)


# -- ResourceQuota ----------------------------------------------------------


def test_quota_enforced_and_released():
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q", namespace="default"),
        hard={"pods": Quantity("2"), "requests.cpu": Quantity("1")},
    ))
    cs.pods.create(make_pod("a", cpu="600m"))
    with pytest.raises(AdmissionDenied, match="exceeded quota"):
        cs.pods.create(make_pod("b", cpu="600m"))  # cpu over
    cs.pods.create(make_pod("c", cpu="200m"))
    with pytest.raises(AdmissionDenied, match="exceeded quota"):
        cs.pods.create(make_pod("d"))  # pod count over
    used = cs.resourcequotas.get("q").used
    assert used["pods"] == Quantity(2)
    cs.pods.delete("a")
    used = cs.resourcequotas.get("q").used
    assert used["pods"] == Quantity(1)
    cs.pods.create(make_pod("e", cpu="100m"))  # fits again


def test_quota_concurrent_creates_never_over_admit():
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q", namespace="default"),
        hard={"pods": Quantity("5")},
    ))
    admitted, denied = [], []

    def worker(i):
        try:
            cs.pods.create(make_pod(f"p{i}"))
            admitted.append(i)
        except AdmissionDenied:
            denied.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(admitted) == 5
    assert len(denied) == 7
    assert cs.resourcequotas.get("q").used["pods"] == Quantity(5)


def test_quota_scopes():
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="be", namespace="default"),
        hard={"pods": Quantity("1")},
        scopes=["BestEffort"],
    ))
    cs.pods.create(make_pod("rich", cpu="100m"))  # NotBestEffort: untracked
    cs.pods.create(make_pod("poor1"))
    with pytest.raises(AdmissionDenied):
        cs.pods.create(make_pod("poor2"))


# -- evaluator unit behavior -------------------------------------------------


def test_usage_for_terminal_pod_is_free():
    pod = make_pod("done").to_dict()
    pod["status"]["phase"] = "Succeeded"
    assert quotalib.usage_for("Pod", pod) == {}


def test_counted_kinds():
    svc = {"kind": "Service", "metadata": {"name": "s"}}
    assert quotalib.usage_for("Service", svc) == {"services": Quantity(1)}


def _controller_resync(cs, namespace, name):
    """The quota controller's full recalculation (the JAX package's
    ``ResourceQuotaController.sync``; the port has no controllers yet):
    ``status.used`` becomes the live objects' usage of each resource the
    quota constrains."""
    hard = cs.resourcequotas.get(name, namespace).hard
    used = {}
    for pod in cs.store.list("Pod", namespace)[0]:
        used = quotalib.add_usage(used, quotalib.usage_for("Pod", pod))

    def apply(cur):
        cur.setdefault("status", {})["used"] = {
            k: str(used.get(k, Quantity(0))) for k in hard}
        return cur

    cs.store.guaranteed_update("ResourceQuota", namespace, name, apply)


def test_quota_terminal_pod_reclaimed_by_controller_not_delete():
    """Terminal-pod usage is reclaimed by the quota controller at the phase
    transition; the admission delete path must NOT decrement again (that
    double-release would deflate used and over-admit)."""
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q", namespace="default"),
        hard={"pods": Quantity("1")},
    ))
    cs.pods.create(make_pod("a"))
    assert cs.resourcequotas.get("q").used["pods"] == Quantity(1)
    # pod finishes; the controller's churn-driven resync reclaims its usage
    def finish(cur):
        cur.setdefault("status", {})["phase"] = "Succeeded"
        return cur
    cs.store.guaranteed_update("Pod", "default", "a", finish)
    _controller_resync(cs, "default", "q")
    assert cs.resourcequotas.get("q").used["pods"] == Quantity(0)
    cs.pods.create(make_pod("b"))  # freed slot is reusable while a exists
    # deleting the terminal pod releases nothing further (no double-release)
    cs.pods.delete("a")
    assert cs.resourcequotas.get("q").used["pods"] == Quantity(1)


def test_quota_deny_rolls_back_earlier_charges():
    """With multiple matching quotas, a deny by a later quota must not
    leave earlier quotas charged."""
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q-loose", namespace="default"),
        hard={"pods": Quantity("10")},
    ))
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q-tight", namespace="default"),
        hard={"pods": Quantity("0")},
    ))
    with pytest.raises(AdmissionDenied):
        cs.pods.create(make_pod("a"))
    used = cs.resourcequotas.get("q-loose").used
    assert used.get("pods", Quantity(0)) == Quantity(0)


def test_pod_created_terminal_is_normalized_and_charged():
    """Client-supplied terminal status is wiped at create (PrepareForCreate)
    so the quota ledger stays symmetric: no over-admission via
    create-terminal-then-delete."""
    cs = make_cs()
    cs.resourcequotas.create(ResourceQuota(
        meta=ObjectMeta(name="q", namespace="default"),
        hard={"pods": Quantity("2")},
    ))
    cs.pods.create(make_pod("a"))
    cs.pods.create(make_pod("b"))
    sneaky = make_pod("sneaky").to_dict()
    sneaky["status"] = {"phase": "Succeeded"}
    with pytest.raises(AdmissionDenied):  # charged like any pod -> over quota
        cs.store.create("Pod", sneaky)
    assert cs.resourcequotas.get("q").used["pods"] == Quantity(2)


# -- the port against the JAX package ----------------------------------------

import importlib  # noqa: E402
import random  # noqa: E402

JAX, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"
UNREACHABLE = "node.alpha.kubernetes.io/unreachable"


def _pkg(pkg):
    imp = importlib.import_module
    api = imp(f"{pkg}.api")
    cluster = imp(f"{pkg}.api.cluster")
    adm = imp(f"{pkg}.admission")
    return api, cluster, adm, imp(f"{pkg}.testutil")


def _setup_objects(pkg):
    """The cluster-side objects the chain reads, built with ``pkg``'s own
    kinds: namespaces, a LimitRange, PriorityClasses, a ResourceQuota, a
    ServiceAccount, StorageClasses."""
    api, cluster, _, _ = _pkg(pkg)
    Q, M = api.Quantity, api.ObjectMeta
    terminating = cluster.Namespace(meta=M(name="tenant-b"), phase="Terminating")
    return [
        ("Namespace", cluster.Namespace(meta=M(name="tenant-a")).to_dict()),
        ("Namespace", terminating.to_dict()),
        ("LimitRange", cluster.LimitRange(meta=M(name="lr", namespace="tenant-a"), limits=[
            cluster.LimitRangeItem(default_request={"cpu": Q("100m"), "memory": Q("128Mi")},
                                   max={"cpu": Q("2")})]).to_dict()),
        ("PriorityClass", cluster.PriorityClass(meta=M(name="high"), value=1000).to_dict()),
        ("PriorityClass", cluster.PriorityClass(meta=M(name="batch"), value=0,
                                                global_default=True).to_dict()),
        ("ResourceQuota", cluster.ResourceQuota(meta=M(name="q", namespace="tenant-a"),
                                                hard={"pods": Q("12")}).to_dict()),
        ("ServiceAccount", cluster.ServiceAccount(meta=M(name="deployer",
                                                         namespace="tenant-a")).to_dict()),
        ("StorageClass", cluster.StorageClass(meta=M(name="std"), provisioner="p",
                                              is_default=True).to_dict()),
    ]


def _requests(pkg, seed, n=120):
    """``n`` seeded pod creates (and a few deletes) over namespaces that
    exist, terminate or are missing, priority classes that exist or not,
    service accounts, requests over the LimitRange's max, anti-affinity
    topologies, and a PVC, Services and NetworkPolicies."""
    api, cluster, _, tu = _pkg(pkg)
    rng = random.Random(seed)
    out = []
    for i in range(n):
        ns = rng.choice(["default"] * 3 + ["tenant-a"] * 4 + ["tenant-b", "missing"])
        cpu = rng.choice(["0", "0", "0", "250m", "250m", "500m", "1", "3"])
        aff = None
        if rng.random() < 0.15:
            key = rng.choice(["kubernetes.io/hostname", "failure-domain.beta.kubernetes.io/zone"])
            aff = api.Affinity(pod_anti_affinity_required=[api.PodAffinityTerm(
                selector=api.LabelSelector.from_match_labels({"app": "x"}), topology_key=key)])
        pod = tu.make_pod(f"p{i:03d}", cpu=cpu, namespace=ns, labels={"app": "x"}, affinity=aff)
        pod.spec.priority_class_name = rng.choice(["", "", "", "high", "high", "batch", "batch",
                                                   "ghost"])
        pod.spec.service_account_name = rng.choice(["", "", "", "", "", "deployer", "deployer",
                                                    "ghost"])
        out.append(("create", "Pod", pod.to_dict()))
        if i % 10 == 9:
            out.append(("delete", "Pod", (ns, f"p{i - 1:03d}")))
    M = api.ObjectMeta
    out.append(("create", "PersistentVolumeClaim", api.PersistentVolumeClaim(
        meta=M(name="claim", namespace="tenant-a"), request_storage=api.Quantity("1Gi")).to_dict()))
    for name, ip in (("svc-a", ""), ("svc-b", "10.0.0.7"), ("svc-c", "192.168.0.1")):
        out.append(("create", "Service", api.Service(meta=M(name=name, namespace="default"),
                                                     cluster_ip=ip).to_dict()))
    good = cluster.NetworkPolicy(meta=M(name="np", namespace="default"),
                                 pod_selector=api.LabelSelector.from_match_labels({"a": "b"}))
    bad = good.to_dict()
    bad["metadata"]["name"] = "np-bad"
    bad["spec"]["ingress"] = [{"ports": [{"protocol": "SCTP"}]}]
    out += [("create", "NetworkPolicy", good.to_dict()), ("create", "NetworkPolicy", bad)]
    return out


_VOLATILE = ("uid", "resourceVersion", "creationRevision", "deletionRevision",
             "creationTimestamp")


def _masked(obj):
    obj = json.loads(json.dumps(obj))
    for k in _VOLATILE:
        obj.get("metadata", {}).pop(k, None)
    return obj


def _drive(pkg, seed):
    """Every setup object and request through ``pkg``'s ``AdmittedStore(
    default_chain())``: each outcome (the masked stored object, or the
    denying plugin and its message) and the final state of every kind."""
    _, _, adm, _ = _pkg(pkg)
    store = adm.AdmittedStore(adm.default_chain())
    outcomes = []
    for kind, body in _setup_objects(pkg):
        outcomes.append(_masked(store.create(kind, body)))
    for op, kind, arg in _requests(pkg, seed):
        try:
            if op == "create":
                outcomes.append(("ok", _masked(store.create(kind, arg))))
            else:
                outcomes.append(("deleted", _masked(store.delete(kind, *arg))))
        except adm.AdmissionDenied as e:
            outcomes.append(("denied", e.plugin, e.message))
        except KeyError as e:  # a delete of a pod that was never admitted
            outcomes.append(("missing", str(e)))
    state = {kind: [_masked(o) for o in store.list(kind)[0]]
             for kind in ("Pod", "ResourceQuota", "PersistentVolumeClaim", "Service",
                          "NetworkPolicy", "Namespace")}
    return outcomes, state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admitted_objects_and_denials_equal_the_jax_chains(seed):
    got, want = _drive(PORT, seed), _drive(JAX, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    kinds = [o[0] for o in got[0] if isinstance(o, tuple)]
    assert kinds.count("denied") > 10 and kinds.count("ok") > 30 and "deleted" in kinds
    plugins = {o[1] for o in got[0] if isinstance(o, tuple) and o[0] == "denied"}
    assert {"NamespaceLifecycle", "Priority", "ServiceAccount", "LimitRanger",
            "ResourceQuota", "NetworkPolicyValidation"} <= plugins


def _admitted_schedule(pkg, backend_kind):
    """Nodes (a tenth tainted unreachable:NoExecute), the setup objects
    but the quota, then 40 pods with no requests created one at a time through the
    admitted store; one batch wave (or the oracle) schedules them.
    Returns (pod -> node, rr)."""
    imp = importlib.import_module
    api, _, adm, tu = _pkg(pkg)
    store = adm.AdmittedStore(adm.default_chain())
    Clientset = imp(f"{pkg}.client").Clientset
    sched_mod = imp(f"{pkg}.scheduler")
    cs = Clientset(store)
    for i in range(20):
        taints = [api.Taint(key=UNREACHABLE, effect="NoExecute")] if i % 10 == 0 else []
        cs.nodes.create(tu.make_node(f"n{i:02d}", cpu=str(1 + i % 4), memory=f"{2 + i % 3}Gi",
                                     taints=taints))
    for kind, body in _setup_objects(pkg):
        if kind != "ResourceQuota":  # 20 pods go to tenant-a
            store.create(kind, body)
    for i in range(40):
        pod = tu.make_pod(f"p{i:03d}", namespace="tenant-a" if i % 2 else "default")
        pod.spec.priority_class_name = "high" if i % 3 == 0 else ""
        cs.pods.create(pod)
    algo = sched_mod.GenericScheduler()
    if backend_kind == "oracle":
        sched = sched_mod.Scheduler(cs, algorithm=algo)
        sched.start()
        for _ in range(3):
            sched.pump()
            sched.run_pending()
    else:
        if pkg == PORT:
            backend = imp(f"{pkg}.ops.backend").BatchBackend(algorithm=algo, device="cpu")
        else:
            backend = imp(f"{pkg}.ops").TPUBatchBackend(algorithm=algo)
        sched = sched_mod.Scheduler(cs, algorithm=algo, backend=backend)
        sched.start()
        sched.pump()
        sched.schedule_pending_batch()
    sched.pump()
    pods = store.list("Pod")[0]
    return {f"{p['metadata']['namespace']}/{p['metadata']['name']}": p["spec"].get("nodeName")
            for p in pods}, algo._round_robin, pods


def test_admitted_pods_bind_as_the_jax_package_and_the_oracle():
    port, port_rr, pods = _admitted_schedule(PORT, "batch")
    jax, jax_rr, _ = _admitted_schedule(JAX, "batch")
    oracle, oracle_rr, _ = _admitted_schedule(PORT, "oracle")
    assert port == jax == oracle and port_rr == jax_rr == oracle_rr
    assert all(port.values())
    # the admitted fields the scan read: LimitRange requests in tenant-a,
    # the default tolerations, the resolved priority
    for p in pods:
        spec = p["spec"]
        assert {t["key"] for t in spec["tolerations"]} >= {UNREACHABLE}
        want = 1000 if spec["priorityClassName"] == "high" else 0
        assert spec["priority"] == want
        req = spec["containers"][0]["resources"]["requests"]
        assert (req == {"cpu": "100m", "memory": "128Mi"}) == (
            p["metadata"]["namespace"] == "tenant-a")
    # only the admitted tolerations let pods onto the tainted nodes
    assert any(n in ("n00", "n10") for n in port.values())
