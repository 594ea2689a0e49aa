"""The port's extended admission plugins: twins of
``tests/test_admission_ext.py`` (behavioural specs from the reference's
``plugin/pkg/admission/*``).

Every JAX test also runs whole through both packages (``test_twin``,
``tests/torch_twin``): the CRD registrar and the garbage collector,
``PersistentVolumeLabel`` over ``FakeCloud``, and ``kubectl exec`` into
a hollow kubelet's pods through the apiserver's CONNECT chain.  Both
pass its assertions, leave equal stores and answer every ``kubectl``
call with the same exit code and output.  The port's own cases beside
them hold the same rules from other sides: a kind registered at run
time by hand, the new kinds' plurals and scope against the JAX registry,
and ``DenyEscalatingExec`` driven on the chain itself.
Tolerance: exact equality."""

import pytest

from kubernetes_tpu_torch.admission import (
    AdmissionChain,
    AdmissionDenied,
    AdmittedStore,
    AlwaysPullImages,
    GenericAdmissionWebhook,
    ImagePolicyWebhook,
    NodeRestriction,
    PodNodeSelector,
    default_chain,
)
from kubernetes_tpu_torch.api import (
    Namespace,
    ObjectMeta,
    PersistentVolumeClaim,
    Quantity,
    StorageClass,
)
from kubernetes_tpu_torch.api import PodPresetSpec
from kubernetes_tpu_torch.api.selectors import LabelSelector
from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testutil import make_pod
from tests.torch_twin import cases, twin


@pytest.fixture()
def cs():
    return Clientset(AdmittedStore(default_chain()))


def test_default_storage_class_applied_to_classless_claim(cs):
    cs.storageclasses.create(StorageClass(
        meta=ObjectMeta(name="standard"), provisioner="p", is_default=True))
    cs.storageclasses.create(StorageClass(meta=ObjectMeta(name="slow"), provisioner="p"))
    pvc = cs.persistentvolumeclaims.create(PersistentVolumeClaim(
        meta=ObjectMeta(name="c", namespace="default"), request_storage=Quantity("1Gi")))
    assert pvc.storage_class == "standard"
    # explicit class untouched
    pvc2 = cs.persistentvolumeclaims.create(PersistentVolumeClaim(
        meta=ObjectMeta(name="c2", namespace="default"),
        request_storage=Quantity("1Gi"), storage_class="slow"))
    assert pvc2.storage_class == "slow"


def test_two_default_storage_classes_deny(cs):
    for n in ("a", "b"):
        cs.storageclasses.create(StorageClass(
            meta=ObjectMeta(name=n), provisioner="p", is_default=True))
    with pytest.raises(AdmissionDenied):
        cs.persistentvolumeclaims.create(PersistentVolumeClaim(
            meta=ObjectMeta(name="c", namespace="default"),
            request_storage=Quantity("1Gi")))


def test_pod_preset_injects_env_and_volumes(cs):
    cs.podpresets.create(PodPresetSpec(
        meta=ObjectMeta(name="inject", namespace="default"),
        selector=LabelSelector.from_match_labels({"app": "web"}),
        env={"DB_HOST": "db.internal"},
        volumes=[{"name": "cache", "diskId": "", "diskKind": ""}],
    ))
    pod = cs.pods.create(make_pod("p", labels={"app": "web"}))
    assert pod.spec.containers[0].env == {"DB_HOST": "db.internal"}
    assert any(v.name == "cache" for v in pod.spec.volumes)
    assert "podpreset.admission.kubernetes.io/podpreset-inject" in pod.meta.annotations
    # non-matching pod untouched
    other = cs.pods.create(make_pod("q", labels={"app": "api"}))
    assert other.spec.containers[0].env == {}


def test_always_pull_images():
    chain = AdmissionChain([AlwaysPullImages()])
    cs = Clientset(AdmittedStore(chain))
    pod = cs.pods.create(make_pod("p"))
    assert all(c.image_pull_policy == "Always" for c in pod.spec.containers)


def test_pod_node_selector_merges_and_conflicts():
    chain = AdmissionChain([PodNodeSelector()])
    cs = Clientset(AdmittedStore(chain))
    cs.namespaces.create(Namespace(meta=ObjectMeta(
        name="tenant", annotations={
            PodNodeSelector.ANNOTATION: "pool=gold, zone=us-east"})))
    pod = cs.pods.create(make_pod("p", namespace="tenant"))
    assert pod.spec.node_selector == {"pool": "gold", "zone": "us-east"}
    bad = make_pod("q", namespace="tenant", node_selector={"pool": "silver"})
    with pytest.raises(AdmissionDenied):
        cs.pods.create(bad)


def test_image_policy_webhook_allow_deny_and_failure_policy():
    def deny_evil(payload):
        images = [c["image"] for c in payload["spec"]["containers"]]
        bad = any("evil" in i for i in images)
        return {"status": {"allowed": not bad, "reason": "evil image"}}

    chain = AdmissionChain([ImagePolicyWebhook(backend=deny_evil)])
    cs = Clientset(AdmittedStore(chain))
    cs.pods.create(make_pod("ok"))
    evil = make_pod("bad")
    evil.spec.containers[0].image = "registry/evil:latest"
    with pytest.raises(AdmissionDenied):
        cs.pods.create(evil)

    def broken(payload):
        raise RuntimeError("down")

    closed = Clientset(AdmittedStore(AdmissionChain(
        [ImagePolicyWebhook(backend=broken, default_allow=False)])))
    with pytest.raises(AdmissionDenied):
        closed.pods.create(make_pod("x"))
    open_ = Clientset(AdmittedStore(AdmissionChain(
        [ImagePolicyWebhook(backend=broken, default_allow=True)])))
    open_.pods.create(make_pod("y"))  # fail-open admits


def test_generic_admission_webhook_scoping_and_fail_policy():
    calls = []

    def record_and_deny(payload):
        calls.append(payload["request"]["kind"])
        return {"response": {"allowed": False, "status": {"message": "nope"}}}

    chain = AdmissionChain([GenericAdmissionWebhook(webhooks=[
        {"name": "podcop", "kinds": ["Pod"], "backend": record_and_deny},
    ])])
    cs = Clientset(AdmittedStore(chain))
    cs.namespaces.create(Namespace(meta=ObjectMeta(name="ns1")))  # not scoped -> no call
    with pytest.raises(AdmissionDenied):
        cs.pods.create(make_pod("p"))
    assert calls == ["Pod"]


def test_node_restriction():
    chain = AdmissionChain([NodeRestriction()])
    store = AdmittedStore(chain)
    cs = Clientset(store)
    # kubelet identity may write its own pod status but not others'
    own = make_pod("mine", node_name="n1").to_dict()
    other = make_pod("theirs", node_name="n2").to_dict()
    from kubernetes_tpu_torch.admission import Attributes, CREATE

    chain.run(Attributes(operation=CREATE, kind="Pod", namespace="default",
                         name="mine", obj=own, store=store, user="system:node:n1"))
    with pytest.raises(AdmissionDenied):
        chain.run(Attributes(operation=CREATE, kind="Pod", namespace="default",
                             name="theirs", obj=other, store=store,
                             user="system:node:n1"))
    with pytest.raises(AdmissionDenied):
        chain.run(Attributes(operation=CREATE, kind="Node", namespace="",
                             name="n2", obj={}, store=store, user="system:node:n1"))


def test_crd_registers_runtime_kind_end_to_end(cs):
    """A kind registered at run time is admitted (NamespaceLifecycle holds
    it to an existing namespace), addressable through the typed client and
    the wire apiserver by its plural, and gone once unregistered."""
    from dataclasses import dataclass, field

    from kubernetes_tpu_torch.api.types import KIND_PLURALS, KINDS, kind_for_plural, register_kind
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.remote import RemoteStore

    @dataclass
    class Widget:
        meta: ObjectMeta = field(default_factory=ObjectMeta)
        raw: dict = field(default_factory=dict)
        KIND = "Widget"

        def to_dict(self):
            return {**self.raw, "kind": self.KIND, "metadata": self.meta.to_dict()}

        @classmethod
        def from_dict(cls, d):
            return cls(meta=ObjectMeta.from_dict(d.get("metadata") or {}), raw=dict(d))

    register_kind(Widget)
    try:
        assert kind_for_plural("widgets") == "Widget"
        cs = Clientset(cs.store)  # the port's clientset binds its kinds when built
        created = cs.client_for("Widget").create(Widget.from_dict(
            {"kind": "Widget", "metadata": {"name": "w1", "namespace": "default"},
             "spec": {"size": 3}}))
        assert created.raw["spec"]["size"] == 3
        assert cs.client_for("Widget").get("w1", "default").meta.name == "w1"
        with pytest.raises(AdmissionDenied):
            cs.client_for("Widget").create(Widget.from_dict(
                {"kind": "Widget", "metadata": {"name": "w2", "namespace": "nowhere"}}))
        srv = APIServer(cs.store)
        srv.start()
        try:
            objs, _ = RemoteStore(srv.url).list("Widget")
            assert [o["metadata"]["name"] for o in objs] == ["w1"]
        finally:
            srv.stop()
    finally:
        KINDS.pop("Widget", None)
        KIND_PLURALS.pop("Widget", None)
    assert kind_for_plural("widgets") is None


def test_pod_preset_conflict_skips_whole_preset(cs):
    """A pod whose env conflicts with the preset gets NOTHING from it —
    no partial application, no applied annotation."""
    cs.podpresets.create(PodPresetSpec(
        meta=ObjectMeta(name="inject", namespace="default"),
        selector=LabelSelector.from_match_labels({"app": "web"}),
        env={"FOO": "preset"},
        volumes=[{"name": "cache"}],
    ))
    p = make_pod("p", labels={"app": "web"})
    p.spec.containers[0].env = {"FOO": "pod"}
    created = cs.pods.create(p)
    assert created.spec.containers[0].env == {"FOO": "pod"}
    assert not any(v.name == "cache" for v in created.spec.volumes)
    assert not any("podpreset" in k for k in created.meta.annotations)


def test_duplicate_crd_does_not_unregister_claimants_kind(cs):
    """The kinds the chain reads route by the JAX package's plurals and
    scope, so a client of either package reaches the same paths."""
    import kubernetes_tpu.federation.types  # noqa: F401  (Cluster, as each apiserver registers it)
    import kubernetes_tpu_torch.federation.types  # noqa: F401
    from kubernetes_tpu.api.types import CLUSTER_SCOPED_KINDS as JAX_SCOPED
    from kubernetes_tpu.api.types import KIND_PLURALS as JAX_PLURALS
    from kubernetes_tpu_torch.api.types import CLUSTER_SCOPED_KINDS, KIND_PLURALS, kind_for_plural

    slice_kinds = {"Namespace", "Secret", "ServiceAccount", "ResourceQuota", "LimitRange",
                   "PodPreset", "StorageClass", "PriorityClass", "PodSecurityPolicy",
                   "NetworkPolicy"}
    assert slice_kinds <= set(KIND_PLURALS)
    for kind, plural in KIND_PLURALS.items():
        assert JAX_PLURALS[kind] == plural and kind_for_plural(plural) == kind
        assert (kind in CLUSTER_SCOPED_KINDS) == (kind in JAX_SCOPED), kind


def test_namespace_autoprovision_security_context_always_deny():
    from kubernetes_tpu_torch.admission import (
        AlwaysDeny,
        NamespaceAutoProvision,
        SecurityContextDeny,
    )

    cs2 = Clientset(AdmittedStore(AdmissionChain(
        [NamespaceAutoProvision(), SecurityContextDeny()])))
    cs2.pods.create(make_pod("p", namespace="brand-new"))
    assert cs2.namespaces.get("brand-new").phase == "Active"

    bad = make_pod("root", namespace="brand-new")
    bad.spec.containers[0].privileged = True
    with pytest.raises(AdmissionDenied):
        cs2.pods.create(bad)

    locked = Clientset(AdmittedStore(AdmissionChain([AlwaysDeny()])))
    with pytest.raises(AdmissionDenied):
        locked.pods.create(make_pod("x"))


# -- the last four reference plugins ---------------------------------------


def test_deny_escalating_exec():
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import DenyEscalatingExec

    plug = DenyEscalatingExec()
    priv = {"spec": {"containers": [
        {"name": "c", "securityContext": {"privileged": True}}]}}
    plain = {"spec": {"containers": [{"name": "c"}]}}
    attrs = Attributes(operation="CONNECT", kind="Pod", namespace="default",
                       name="p", old_obj=priv)
    assert plug.handles(attrs)
    with pytest.raises(AdmissionDenied):
        plug.validate(attrs)
    ok = Attributes(operation="CONNECT", kind="Pod", namespace="default",
                    name="p", old_obj=plain)
    plug.validate(ok)  # no raise
    # non-CONNECT operations are not handled
    assert not plug.handles(Attributes(operation="CREATE", kind="Pod",
                                       namespace="default", name="p"))


def test_owner_references_permission_enforcement():
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import (
        OwnerReferencesPermissionEnforcement,
    )

    plug = OwnerReferencesPermissionEnforcement()
    old = {"metadata": {"ownerReferences": []}}
    new = {"metadata": {"ownerReferences": [
        {"kind": "ReplicaSet", "name": "rs", "uid": "u1"}]}}
    # ordinary user without delete rights: denied
    attrs = Attributes(operation="UPDATE", kind="Pod", namespace="default",
                       name="p", obj=new, old_obj=old, user="mallory")
    with pytest.raises(AdmissionDenied):
        plug.validate(attrs)
    # controllers (system: identities) pass
    sysattrs = Attributes(operation="UPDATE", kind="Pod", namespace="default",
                          name="p", obj=new, old_obj=old,
                          user="system:serviceaccount:kube-system:gc")
    plug.validate(sysattrs)
    # unchanged ownerRefs pass for anyone
    same = Attributes(operation="UPDATE", kind="Pod", namespace="default",
                      name="p", obj=old, old_obj=old, user="mallory")
    plug.validate(same)
    # with an authorizer granting delete, the user may change refs
    class AllowAll:
        def authorize(self, a):
            from kubernetes_tpu_torch.admission.plugins_ext import ALLOW

            return ALLOW, "ok"

    plug2 = OwnerReferencesPermissionEnforcement(authorizer=AllowAll())
    plug2.validate(attrs)


def test_persistent_volume_label():
    from kubernetes_tpu_torch.admission.framework import Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import PersistentVolumeLabel
    from kubernetes_tpu_torch.cloud import FakeCloud, Instance

    cloud = FakeCloud()
    cloud.add_instance(Instance(name="disk-1", zone="z1", region="r1"))
    plug = PersistentVolumeLabel(cloud=cloud)
    obj = {"kind": "PersistentVolume",
           "metadata": {"name": "pv1"}, "spec": {"diskID": "disk-1"}}
    attrs = Attributes(operation="CREATE", kind="PersistentVolume",
                       namespace="", name="pv1", obj=obj)
    plug.admit(attrs)
    labels = obj["metadata"]["labels"]
    assert labels["failure-domain.beta.kubernetes.io/zone"] == "z1"
    assert labels["failure-domain.beta.kubernetes.io/region"] == "r1"
    # unknown disk: no labels, no crash; existing zone label untouched
    obj2 = {"kind": "PersistentVolume", "metadata": {"name": "pv2"},
            "spec": {"diskID": "ghost"}}
    plug.admit(Attributes(operation="CREATE", kind="PersistentVolume",
                          namespace="", name="pv2", obj=obj2))
    assert "labels" not in obj2["metadata"] or not obj2["metadata"]["labels"]
    # inert without a cloud
    PersistentVolumeLabel().admit(attrs)


def test_initializers_protocol():
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import Initializers

    plug = Initializers()

    def upd(old_pending, new_pending):
        return Attributes(
            operation="UPDATE", kind="Pod", namespace="default", name="p",
            obj={"metadata": {"initializers":
                 {"pending": [{"name": n} for n in new_pending]}}},
            old_obj={"metadata": {"initializers":
                     {"pending": [{"name": n} for n in old_pending]}}})

    # removing the FIRST pending initializer is the protocol
    plug.validate(upd(["a.io", "b.io"], ["b.io"]))
    # removing out of order is denied
    with pytest.raises(AdmissionDenied):
        plug.validate(upd(["a.io", "b.io"], ["a.io"]))
    # adding initializers after creation is denied
    with pytest.raises(AdmissionDenied):
        plug.validate(upd([], ["late.io"]))
    # unchanged passes
    plug.validate(upd(["a.io"], ["a.io"]))
    # create is unrestricted (controllers stamp initializers at birth)
    plug.validate(Attributes(operation="CREATE", kind="Pod",
                             namespace="default", name="p",
                             obj={"metadata": {}}))


def test_deny_escalating_exec_enforced_on_the_wire():
    """The default chain runs DenyEscalatingExec on a CONNECT: exec into a
    privileged or host-PID pod is denied, a plain pod passes (the chain
    driven directly; ``kubectl exec`` through the apiserver: ``test_twin``)."""
    from kubernetes_tpu_torch.admission import AdmittedStore, default_chain
    from kubernetes_tpu_torch.admission.framework import Attributes

    store = AdmittedStore(default_chain())
    cs = Clientset(store)
    priv = make_pod("priv", node_name="n1")
    priv.spec.containers[0].privileged = True
    cs.pods.create(priv)
    cs.pods.create(make_pod("plain", node_name="n1"))
    hostpid = make_pod("hostpid", node_name="n1").to_dict()
    hostpid["spec"]["hostPID"] = True
    store.create("Pod", hostpid)

    def connect(name):
        store.chain.run(Attributes(operation="CONNECT", kind="Pod", namespace="default",
                                   name=name, old_obj=store.get("Pod", "default", name),
                                   store=store))

    with pytest.raises(AdmissionDenied, match="privileged"):
        connect("priv")
    connect("plain")
    with pytest.raises(AdmissionDenied, match="pid"):
        connect("hostpid")


def test_initializers_create_rule():
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import Initializers

    plug = Initializers()
    # pending initializers at create are fine (the admission controller
    # stamps them); a self-declared RESULT is not
    plug.validate(Attributes(
        operation="CREATE", kind="Pod", namespace="default", name="p",
        obj={"metadata": {"initializers": {"pending": [{"name": "a.io"}]}}}))
    with pytest.raises(AdmissionDenied):
        plug.validate(Attributes(
            operation="CREATE", kind="Pod", namespace="default", name="p",
            obj={"metadata": {"initializers": {"pending": [],
                                               "result": {"status": "Failure"}}}}))


def test_pod_security_policy_plugin():
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import PodSecurityPolicyPlugin
    from kubernetes_tpu_torch.api.cluster import PodSecurityPolicy
    from kubernetes_tpu_torch.api import ObjectMeta
    from kubernetes_tpu_torch.store import Store

    store = Store()
    plug = PodSecurityPolicyPlugin()

    def attrs_for(pod):
        return Attributes(operation="CREATE", kind="Pod", namespace="default",
                          name="p", obj=pod, store=store)

    priv_pod = {"spec": {"containers": [
        {"name": "c", "securityContext": {"privileged": True}}]}}
    plain_pod = {"spec": {"containers": [{"name": "c"}]}}

    # no policies registered: inert (cluster hasn't opted into PSP)
    plug.validate(attrs_for(priv_pod))

    # restricted-only: privileged pods denied, plain pods stamped
    store.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="10-restricted")).to_dict())
    with pytest.raises(AdmissionDenied):
        plug.validate(attrs_for(priv_pod))
    pod = dict(plain_pod, metadata={})
    plug.validate(attrs_for(pod))
    assert pod["metadata"]["annotations"]["kubernetes.io/psp"] == "10-restricted"

    # adding a privileged policy admits the privileged pod under ITS name
    store.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="50-privileged"), privileged=True,
        host_pid=True).to_dict())
    pod = dict(priv_pod, metadata={})
    plug.validate(attrs_for(pod))
    assert pod["metadata"]["annotations"]["kubernetes.io/psp"] == "50-privileged"

    # host namespaces gated
    hostpid = {"spec": {"hostPID": True, "containers": [{"name": "c"}]}}
    pod = dict(hostpid, metadata={})
    plug.validate(attrs_for(pod))  # 50-privileged allows hostPID
    assert pod["metadata"]["annotations"]["kubernetes.io/psp"] == "50-privileged"

    # MustRunAs user range enforced
    store.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="00-ranged"),
        run_as_user={"rule": "MustRunAs", "min": 1000, "max": 2000}).to_dict())
    ranged_ok = {"spec": {"containers": [
        {"name": "c", "securityContext": {"runAsUser": 1500}}]}, "metadata": {}}
    plug.validate(attrs_for(ranged_ok))
    # 00-ranged sorts first and admits
    assert ranged_ok["metadata"]["annotations"]["kubernetes.io/psp"] == "00-ranged"

    # volume kinds gated
    store2 = Store()
    store2.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="novol"), allowed_volume_kinds=["pvc"]).to_dict())
    plug2 = PodSecurityPolicyPlugin()
    disky = {"spec": {"containers": [{"name": "c"}],
                      "volumes": [{"name": "v", "diskKind": "gce-pd",
                                   "diskID": "d1"}]}}
    with pytest.raises(AdmissionDenied):
        plug2.validate(Attributes(operation="CREATE", kind="Pod",
                                  namespace="default", name="p",
                                  obj=disky, store=store2))


def test_psp_empty_volume_kinds_denies_all_volumes():
    """allowedVolumeKinds: [] is a real policy (no volumes) — it must not
    fail open to the wildcard."""
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied, Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import PodSecurityPolicyPlugin
    from kubernetes_tpu_torch.api.cluster import PodSecurityPolicy
    from kubernetes_tpu_torch.api import ObjectMeta
    from kubernetes_tpu_torch.store import Store

    store = Store()
    store.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="novols"), allowed_volume_kinds=[]).to_dict())
    assert (store.get("PodSecurityPolicy", "", "novols")["spec"]
            ["allowedVolumeKinds"] == [])
    plug = PodSecurityPolicyPlugin()
    disky = {"spec": {"containers": [{"name": "c"}],
                      "volumes": [{"name": "v", "diskKind": "gce-pd",
                                   "diskID": "d"}]}}
    with pytest.raises(AdmissionDenied):
        plug.validate(Attributes(operation="CREATE", kind="Pod",
                                 namespace="default", name="p",
                                 obj=disky, store=store))


def test_psp_must_run_as_with_typed_containers():
    """runAsUser survives the typed API round trip, so MustRunAs policies
    work for kubectl/typed-client pods."""
    from kubernetes_tpu_torch.api import Container

    c = Container(name="c", run_as_user=1500)
    assert Container.from_dict(c.to_dict()).run_as_user == 1500

    from kubernetes_tpu_torch.admission.framework import Attributes
    from kubernetes_tpu_torch.admission.plugins_ext import PodSecurityPolicyPlugin
    from kubernetes_tpu_torch.api.cluster import PodSecurityPolicy
    from kubernetes_tpu_torch.api import ObjectMeta
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testutil import make_pod

    store = Store()
    store.create("PodSecurityPolicy", PodSecurityPolicy(
        meta=ObjectMeta(name="ranged"),
        run_as_user={"rule": "MustRunAs", "min": 1000, "max": 2000}).to_dict())
    pod = make_pod("p")
    pod.spec.containers[0].run_as_user = 1500
    wire = pod.to_dict()
    PodSecurityPolicyPlugin().validate(Attributes(
        operation="CREATE", kind="Pod", namespace="default", name="p",
        obj=wire, store=store))
    assert wire["metadata"]["annotations"]["kubernetes.io/psp"] == "ranged"


def test_psp_host_namespaces_survive_typed_round_trip():
    """spec.hostPID/... must survive the typed API so the PSP host gate
    is enforceable end-to-end (not only for raw-dict clients)."""
    from kubernetes_tpu_torch.admission import AdmittedStore, default_chain
    from kubernetes_tpu_torch.api import PodSpec
    from kubernetes_tpu_torch.api.cluster import PodSecurityPolicy
    from kubernetes_tpu_torch.api import ObjectMeta
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.store.store import Store
    from kubernetes_tpu_torch.admission.framework import AdmissionDenied
    from kubernetes_tpu_torch.testutil import make_pod

    assert PodSpec.from_dict(PodSpec(host_pid=True).to_dict()).host_pid is True

    cs = Clientset(AdmittedStore(default_chain()))
    cs.client_for("PodSecurityPolicy").create(
        PodSecurityPolicy(meta=ObjectMeta(name="restricted")))
    pod = make_pod("hosty")
    pod.spec.host_pid = True
    with pytest.raises(AdmissionDenied):
        cs.pods.create(pod)
    # allowed once a policy permits it
    cs.client_for("PodSecurityPolicy").create(PodSecurityPolicy(
        meta=ObjectMeta(name="zz-host"), host_pid=True))
    created = cs.pods.create(pod)
    assert created.meta.annotations["kubernetes.io/psp"] == "zz-host"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases("test_admission_ext"))
def test_twin(test, tmp_path):
    twin("test_admission_ext", test, tmp_path, echo=["cli.kubectl:main"])
