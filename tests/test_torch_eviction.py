"""The eviction subresource (``PodClient.evict`` and ``POST
pods/{name}/eviction``) against the JAX package's, on the CPU.

- Under contention: 8 threads evict 20 pods that one PodDisruptionBudget
  with a budget of 7 selects.  Exactly 7 evictions succeed, 13 are
  refused (``EvictionDisallowed`` in process, HTTP 429 over the wire), the
  budget ends at 0 and never reads below it, and the 7 pods are gone.
  The same in both packages, in process and through each package's
  apiserver.
- A pod two budgets select, one of them spent: the eviction is refused and
  the other budget's charge is refunded, in both packages.

Exact counts: no tolerance applies.
"""

from __future__ import annotations

import importlib
import json
import threading
import urllib.error
import urllib.request

import pytest

PKG = {"port": "kubernetes_tpu_torch", "jax": "kubernetes_tpu"}
N_PODS, BUDGET, THREADS = 20, 7, 8


def _world(which: str):
    pkg = PKG[which]
    api = importlib.import_module(f"{pkg}.api")
    cs = importlib.import_module(f"{pkg}.client").Clientset(
        importlib.import_module(f"{pkg}.store").Store())
    tu = importlib.import_module(f"{pkg}.testutil")
    cs.pods.create_many([tu.make_pod(f"web-{i:02d}", labels={"app": "web"})
                         for i in range(N_PODS)])
    cs.poddisruptionbudgets.create(api.PodDisruptionBudget(
        meta=api.ObjectMeta(name="web-pdb", namespace="default"), min_available=N_PODS - BUDGET,
        selector=api.LabelSelector(match_labels={"app": "web"}),
        status_disruptions_allowed=BUDGET))
    return api, cs


def _evict_all(evict) -> list:
    """``evict(name)`` for every pod from ``THREADS`` threads; each result is
    "evicted" or the refusal's name."""
    results: list = []
    mu = threading.Lock()
    names = [f"web-{i:02d}" for i in range(N_PODS)]

    def worker(mine):
        for name in mine:
            out = evict(name)
            with mu:
                results.append((name, out))

    threads = [threading.Thread(target=worker, args=(names[t::THREADS],))
               for t in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def _summary(cs, results) -> dict:
    left = sorted(p.meta.name for p in cs.pods.list()[0])
    evicted = sorted(n for n, out in results if out == "evicted")
    return {"outcomes": sorted(out for _, out in results), "left": len(left),
            "evicted_gone": not set(evicted) & set(left),
            "budget": cs.poddisruptionbudgets.get("web-pdb").status_disruptions_allowed}


def _in_process(which: str) -> dict:
    _, cs = _world(which)
    refusal = importlib.import_module(f"{PKG[which]}.client.clientset").EvictionDisallowed

    def evict(name):
        try:
            cs.pods.evict(name, "default")
            return "evicted"
        except refusal:
            return "disallowed"

    return _summary(cs, _evict_all(evict))


def _over_the_wire(which: str) -> dict:
    _, cs = _world(which)
    server = importlib.import_module(f"{PKG[which]}.apiserver").APIServer(cs.store)
    server.start()

    def evict(name):
        req = urllib.request.Request(
            f"{server.url}/api/v1/namespaces/default/pods/{name}/eviction",
            data=json.dumps({}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return "evicted" if r.status == 201 else r.status
        except urllib.error.HTTPError as e:
            return json.loads(e.read())["reason"] if e.code == 429 else e.code

    try:
        return _summary(cs, _evict_all(evict))
    finally:
        server.stop()


@pytest.mark.parametrize("path", [_in_process, _over_the_wire], ids=["in-process", "wire"])
def test_evictions_under_contention_spend_the_budget_exactly(path):
    got, want = path("port"), path("jax")
    refused = "disallowed" if path is _in_process else "TooManyRequests"
    assert got == want == {"outcomes": sorted(["evicted"] * BUDGET
                                              + [refused] * (N_PODS - BUDGET)),
                           "left": N_PODS - BUDGET, "evicted_gone": True, "budget": 0}


def _refund(which: str) -> list:
    api, cs = _world(which)
    cs.poddisruptionbudgets.create(api.PodDisruptionBudget(
        meta=api.ObjectMeta(name="zz-spent", namespace="default"),
        selector=api.LabelSelector(match_labels={"app": "web"}),
        status_disruptions_allowed=0))
    refusal = importlib.import_module(f"{PKG[which]}.client.clientset").EvictionDisallowed
    with pytest.raises(refusal):
        cs.pods.evict("web-00", "default")
    with pytest.raises(KeyError):
        cs.pods.evict("ghost", "default")
    return [cs.pods.get("web-00").meta.name,
            cs.poddisruptionbudgets.get("web-pdb").status_disruptions_allowed,
            cs.poddisruptionbudgets.get("zz-spent").status_disruptions_allowed]


def test_a_refused_eviction_refunds_the_budgets_it_charged():
    assert _refund("port") == _refund("jax") == ["web-00", BUDGET, 0]
