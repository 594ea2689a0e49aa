"""Twins of ``tests/test_federation.py``.

Each JAX test runs through both packages (``tests/torch_twin``): both
pass its assertions and leave equal stores (the federation's and each
member's), and every ``kubefed`` call the test makes answers both with
the same exit code and output.  Beside them, one federation over the wire
(its apiserver, two member apiservers, ``kubefed`` over HTTP, members
dialled by each package's ``RemoteStore``) goes through both packages:
fan-out, status rollup, deletion, and a member whose apiserver stops
going Offline must be equal."""

from __future__ import annotations

import importlib
import io
import json

import pytest

from tests.torch_twin import cases, twin

NAME = "test_federation"
ROOTS = ("kubernetes_tpu", "kubernetes_tpu_torch")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path, echo=["federation.kubefed:main"])


def _wire_federation(root: str) -> dict:
    """A federation over the wire, as ``python -m <pkg>.federation`` runs
    it: the federation's apiserver, its controller manager with the
    default member factory (each member dialled by the package's
    ``RemoteStore``), two member apiservers and ``kubefed`` over HTTP.
    A federated Deployment placed on both members fans out, rolls up the
    members' statuses and is deleted from both; then a member's apiserver
    stops and the member goes Offline."""
    m = {k: importlib.import_module(f"{root}.{v}") for k, v in {
        "api": "api", "apiserver": "apiserver", "clientset": "client.clientset",
        "remote": "client.remote", "store": "store.store", "fed": "federation",
        "manager": "federation.manager", "kubefed": "federation.kubefed"}.items()}
    api = m["api"]
    servers = {name: m["apiserver"].APIServer(m["store"].Store())
               for name in ("fed", "m0", "m1")}
    for s in servers.values():
        s.start()
    fed = m["clientset"].Clientset(servers["fed"].store)
    mgr = m["manager"].FederationControllerManager(fed)
    mgr.start(manual=True)
    members = {n: m["clientset"].Clientset(servers[n].store) for n in ("m0", "m1")}
    out: dict = {"kubefed": []}

    def kubefed(*argv):
        buf = io.StringIO()
        rc = m["kubefed"].main(["--host", servers["fed"].url, *argv], out=buf)
        out["kubefed"].append((rc, buf.getvalue().replace(servers["m0"].url, "<m0>")
                               .replace(servers["m1"].url, "<m1>")))

    def drive(rounds=4):
        for _ in range(rounds):
            mgr.tick()
            mgr.reconcile_all()

    def conditions():
        return {c.meta.name: {d["type"]: d["status"] for d in c.conditions}
                for c in fed.client_for("Cluster").list("")[0]}

    try:
        for name in ("m0", "m1"):
            kubefed("join", name, "--cluster-server", servers[name].url, "--zone", f"z-{name}")
        drive()
        out["joined"] = conditions()
        dep = api.Deployment(
            meta=api.ObjectMeta(name="web", namespace="default", annotations={
                m["fed"].PLACEMENT_ANNOTATION: json.dumps(["m0", "m1"])}),
            replicas=5, selector=api.LabelSelector.from_match_labels({"app": "web"}),
            template=api.PodTemplateSpec(labels={"app": "web"}, spec=api.PodSpec(
                containers=[api.Container(name="c", image="app:v1")])))
        fed.deployments.create(dep)
        drive()
        out["members"] = {n: members[n].deployments.get("web").to_dict()["spec"]
                          for n in members}
        for i, n in enumerate(members):
            def _ready(cur, i=i):
                cur.status_replicas = cur.status_ready_replicas = 5 - i
                cur.status_updated_replicas = 5 - i
                return cur

            members[n].deployments.guaranteed_update("web", _ready)
        drive()
        got = fed.deployments.get("web")
        out["rollup"] = (got.status_replicas, got.status_ready_replicas,
                         got.status_updated_replicas)
        fed.deployments.delete("web")
        drive()
        out["deleted"] = {n: [d.meta.name for d in members[n].deployments.list()[0]]
                          for n in members}
        kubefed("get-clusters")
        # the member's process is gone: its listening socket closes too
        # (the JAX server's stop leaves it open, and a connect would wait)
        servers["m1"].stop()
        servers["m1"].httpd.server_close()
        drive()
        out["after_stop"] = conditions()
        kubefed("get-clusters")
        kubefed("unjoin", "m1")
        kubefed("get-clusters")
    finally:
        mgr.stop()
        for s in servers.values():
            s.stop()
    return out


@pytest.mark.timeout(120)
def test_federation_over_the_wire_marks_a_lost_member_offline():
    got = [_wire_federation(root) for root in ROOTS]
    assert got[0] == got[1]
    port = got[1]
    assert port["joined"] == {n: {"Ready": "True", "Offline": "False"} for n in ("m0", "m1")}
    assert port["members"]["m0"]["replicas"] == 5 == port["members"]["m1"]["replicas"]
    assert port["rollup"] == (9, 9, 9)
    assert port["deleted"] == {"m0": [], "m1": []}
    assert port["after_stop"] == {"m0": {"Ready": "True", "Offline": "False"},
                                  "m1": {"Ready": "False", "Offline": "True"}}
    assert [rc for rc, _ in port["kubefed"]] == [0] * 6
