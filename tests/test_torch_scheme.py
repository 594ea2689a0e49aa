"""Twins of ``tests/test_scheme.py`` on the port's ``api/scheme.py``.

Each twin decodes the same reference-era wire documents (the JAX test's
``apps/v1beta1`` Deployment and ``batch/v2alpha1`` CronJob, and seeded
variants of them) through both packages' ``convert_to_internal`` /
``convert_from_internal``; the outputs must be equal dicts, and equal to
what the JAX test asserts.  Exact: no tolerance applies.

Beside them, every JAX test runs whole through both packages
(``tests/torch_twin``), ``kubectl apply`` and the deployment and cronjob
controllers included: both pass its assertions, leave equal stores and
answer every ``kubectl`` call with the same exit code and output.  The
two tests that drive kubectl and the controllers keep a half of their
own beside the twin: the typed object the controller reads, created
through each package's clientset (and, for the Deployment, POSTed to each
package's apiserver), read back, and compared.

The port's decoder copies a hub-form document shallowly (the apiserver's
``:batch`` create relies on it); a spoke's decoder works on a deep copy,
so the caller's document is never changed.
"""

from __future__ import annotations

import copy
import json
import random
import urllib.request

import pytest
import yaml

from kubernetes_tpu.api import scheme as jax_scheme
from kubernetes_tpu_torch.api import scheme as port_scheme
from tests.torch_twin import cases, twin

V1BETA1_DEPLOYMENT = """
apiVersion: apps/v1beta1
kind: Deployment
metadata:
  name: nginx-deployment
  namespace: default
spec:
  replicas: 3
  strategy:
    type: RollingUpdate
    rollingUpdate:
      maxSurge: 2
      maxUnavailable: 0
  template:
    metadata:
      labels:
        app: nginx
    spec:
      containers:
      - name: nginx
        image: nginx:1.7.9
        resources:
          requests:
            cpu: 100m
"""

V2ALPHA1_CRONJOB = """
apiVersion: batch/v2alpha1
kind: CronJob
metadata: {name: backup, namespace: default}
spec:
  schedule: "0 3 * * *"
  jobTemplate:
    spec:
      completions: 1
      template:
        metadata: {labels: {job: backup}}
        spec:
          containers:
          - name: b
            image: backup:latest
"""


def decode_both(doc: dict) -> dict:
    """``convert_to_internal`` in both packages on copies of ``doc``: equal,
    and neither changes its input."""
    jin, pin = copy.deepcopy(doc), copy.deepcopy(doc)
    want = jax_scheme.convert_to_internal(jin)
    got = port_scheme.convert_to_internal(pin)
    assert got == want
    assert jin == doc and pin == doc
    return got


def encode_both(doc: dict, gv: str) -> dict:
    want = jax_scheme.convert_from_internal(copy.deepcopy(doc), gv)
    got = port_scheme.convert_from_internal(copy.deepcopy(doc), gv)
    assert got == want
    return got


def test_v1beta1_deployment_decodes_with_defaulting():
    doc = decode_both(yaml.safe_load(V1BETA1_DEPLOYMENT))
    assert "apiVersion" not in doc
    spec = doc["spec"]
    assert spec["strategy"] == "RollingUpdate"
    assert spec["maxSurge"] == 2 and spec["maxUnavailable"] == 0
    assert spec["selector"] == {"matchLabels": {"app": "nginx"}}


def test_reference_era_yaml_applies_unchanged():
    """The era's YAML, decoded, created through each package's clientset and
    POSTed to each package's apiserver, reads back as the same hub
    Deployment (``kubectl apply`` and the rollout: ``test_twin``)."""
    from kubernetes_tpu.apiserver import APIServer as JaxAPIServer
    from kubernetes_tpu.client import Clientset as JaxClientset
    from kubernetes_tpu.store import Store as JaxStore
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.api import from_dict
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu.api import from_dict as jax_from_dict

    internal = decode_both(yaml.safe_load(V1BETA1_DEPLOYMENT))
    read = []
    for cs, fd in ((JaxClientset(JaxStore()), jax_from_dict), (Clientset(Store()), from_dict)):
        cs.deployments.create(fd(internal))
        dep = cs.deployments.get("nginx-deployment", "default")
        assert dep.replicas == 3 and dep.max_surge == 2 and dep.max_unavailable == 0
        assert dep.selector.match_labels == {"app": "nginx"}
        assert dep.template.spec.containers[0].image == "nginx:1.7.9"
        d = dep.to_dict()
        for k in ("uid", "creationTimestamp", "resourceVersion"):
            d["metadata"].pop(k, None)
        read.append(d)
    assert read[0] == read[1]

    served = []
    for server in (JaxAPIServer(JaxStore()), APIServer(Store())):
        server.start()
        try:
            req = urllib.request.Request(
                server.url + "/api/v1/namespaces/default/deployments",
                data=json.dumps(yaml.safe_load(V1BETA1_DEPLOYMENT)).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 201
            with urllib.request.urlopen(
                    server.url + "/api/v1/namespaces/default/deployments/nginx-deployment",
                    timeout=10) as r:
                d = json.loads(r.read())
        finally:
            server.stop()
        for k in ("uid", "creationTimestamp", "resourceVersion"):
            d["metadata"].pop(k, None)
        served.append(d)
    assert served[0] == served[1]
    assert served[1]["spec"]["maxSurge"] == 2 and "apiVersion" not in served[1]


@pytest.mark.parametrize("seed", range(4))
def test_percentage_surge_resolves_like_the_reference(seed):
    doc = yaml.safe_load(V1BETA1_DEPLOYMENT)
    doc["spec"]["replicas"] = 10
    doc["spec"]["strategy"]["rollingUpdate"] = {"maxSurge": "25%", "maxUnavailable": "25%"}
    spec = decode_both(doc)["spec"]
    assert spec["maxSurge"] == 3
    assert spec["maxUnavailable"] == 2
    doc["spec"]["strategy"]["rollingUpdate"] = {"maxSurge": "5%", "maxUnavailable": "5%"}
    spec = decode_both(doc)["spec"]
    assert spec["maxSurge"] == 1 and spec["maxUnavailable"] == 0
    # seeded replica counts and percentages, ints and strings mixed
    rng = random.Random(seed)
    for _ in range(25):
        replicas = rng.randint(0, 40)
        doc["spec"]["replicas"] = replicas
        ru = {}
        for key in ("maxSurge", "maxUnavailable"):
            pick = rng.random()
            if pick < 0.4:
                ru[key] = f"{rng.randint(0, 100)}%"
            elif pick < 0.8:
                ru[key] = rng.randint(0, 5)
        doc["spec"]["strategy"] = {"type": rng.choice(["RollingUpdate", "Recreate"]),
                                   "rollingUpdate": ru}
        if rng.random() < 0.5:
            doc["spec"]["selector"] = {"matchLabels": {"app": f"a{rng.randint(0, 3)}"}}
        else:
            doc["spec"].pop("selector", None)
        decode_both(doc)


def test_round_trip_encoding():
    internal = decode_both(yaml.safe_load(V1BETA1_DEPLOYMENT))
    for gv in ("apps/v1beta1", "extensions/v1beta1", "v1", "batch/v1"):
        encode_both(internal, gv)
    wire = encode_both(internal, "apps/v1beta1")
    assert wire["apiVersion"] == "apps/v1beta1"
    assert wire["spec"]["strategy"]["rollingUpdate"] == {"maxSurge": 2, "maxUnavailable": 0}
    again = decode_both(wire)
    assert again["spec"]["maxSurge"] == 2
    # Recreate carries no rollingUpdate section
    recreate = dict(internal, spec=dict(internal["spec"], strategy="Recreate"))
    assert "rollingUpdate" not in encode_both(recreate, "apps/v1beta1")["spec"]["strategy"]


def test_batch_v2alpha1_cronjob_decodes():
    from kubernetes_tpu.api import from_dict as jax_from_dict
    from kubernetes_tpu.client import Clientset as JaxClientset
    from kubernetes_tpu.store import Store as JaxStore
    from kubernetes_tpu_torch.api import from_dict
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.store import Store

    internal = decode_both(yaml.safe_load(V2ALPHA1_CRONJOB))
    spec = internal["spec"]
    assert spec["schedule"] == "0 3 * * *"
    assert spec["jobTemplate"]["completions"] == 1
    assert spec["jobTemplate"]["template"]["metadata"]["labels"] == {"job": "backup"}
    # the typed CronJob the cronjob controller reads (its spawn:
    # ``test_twin``): equal in both packages
    read = []
    for cs, fd in ((JaxClientset(JaxStore()), jax_from_dict), (Clientset(Store()), from_dict)):
        cs.cronjobs.create(fd(internal))
        cj = cs.cronjobs.get("backup", "default")
        assert cj.job_template["template"]["metadata"]["labels"] == {"job": "backup"}
        d = cj.to_dict()
        for k in ("uid", "creationTimestamp", "resourceVersion"):
            d["metadata"].pop(k, None)
        read.append(d)
    assert read[0] == read[1]
    # a batch/v2alpha1 document with no jobTemplate.spec passes as it is
    doc = yaml.safe_load(V2ALPHA1_CRONJOB)
    doc["spec"]["jobTemplate"] = {"completions": 2}
    assert decode_both(doc)["spec"]["jobTemplate"] == {"completions": 2}


def test_a_hub_form_document_is_copied_shallowly():
    """A document with no registered decoder comes back as a new top-level
    dict without ``apiVersion`` that shares its nested sections with the
    input (the apiserver's ``:batch`` create parses its bodies for the
    request alone, so a deep copy per pod would be waste); the output equals
    the JAX package's deep copy."""
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p", "namespace": "default", "labels": {"app": "web"}},
           "spec": {"containers": [{"name": "c", "image": "i"}]}}
    before = copy.deepcopy(pod)
    out = port_scheme.convert_to_internal(pod)
    assert out == jax_scheme.convert_to_internal(copy.deepcopy(pod))
    assert out is not pod and "apiVersion" not in out and pod == before
    assert out["metadata"] is pod["metadata"] and out["spec"] is pod["spec"]
    # a spoke's decoder rewrites nested sections: it works on a deep copy
    dep = yaml.safe_load(V1BETA1_DEPLOYMENT)
    before = copy.deepcopy(dep)
    out = port_scheme.convert_to_internal(dep)
    assert dep == before and out["spec"] is not dep["spec"]
    # the decoder lives in scheme.py alone
    from kubernetes_tpu_torch.api import types as port_types

    assert not hasattr(port_types, "convert_to_internal")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases("test_scheme"))
def test_twin(test, tmp_path):
    twin("test_scheme", test, tmp_path, echo=["cli.kubectl:main"])
