"""TTL controller: anneal node object-cache TTL annotations with cluster
size (capability of ``pkg/controller/ttl/ttlcontroller.go`` — kubelets
read ``node.alpha.kubernetes.io/ttl`` to decide how long secrets/
configmaps may be cached; bigger clusters get longer TTLs to shed
apiserver load)."""

from __future__ import annotations

from ..api import types as api
from ..store.store import NotFoundError
from .base import Controller

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

# (cluster-size threshold, ttl seconds) — reference ttlcontroller.go
_BOUNDARIES = [(0, 0), (100, 15), (500, 30), (1000, 60), (2000, 300)]


def ttl_for(num_nodes: int) -> int:
    ttl = 0
    for threshold, seconds in _BOUNDARIES:
        if num_nodes >= threshold:
            ttl = seconds
    return ttl


class TTLController(Controller):
    """The cluster size and the node come from the Node informer's cache
    (the reference's node lister and node count); the JAX controller LISTs
    every node and GETs the node over the wire on each node update, which
    at 5000 heartbeating nodes is a LIST of the cluster every few
    milliseconds."""

    name = "ttl"

    def __init__(self, clientset, informers=None, **kw):
        super().__init__(clientset, informers, **kw)
        self.watch("Node", key_fn=lambda n: n.meta.name)

    def sync(self, key: str) -> None:
        nodes = self.informer("Node")
        want = str(ttl_for(len(nodes.keys())))
        node = nodes.get(key)
        if node is None or node.meta.annotations.get(TTL_ANNOTATION) == want:
            return

        def _stamp(cur: api.Node) -> api.Node:
            cur.meta.annotations[TTL_ANNOTATION] = want
            return cur

        try:
            self.clientset.nodes.guaranteed_update(key, _stamp)
        except NotFoundError:
            pass
