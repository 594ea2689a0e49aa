"""Federation: the multi-cluster control plane (SURVEY.md §1-L9 /
§2.10, reference ``federation/``).  A federation = an ordinary wire
apiserver over its own store + the controllers here + ``kubefed``.

Lazy attribute loading (PEP 562): the apiserver imports
``federation.types`` just to register the Cluster kind on the wire — it
must not drag the full controller tree (and through it every core
controller) into its import graph."""

from .types import PLACEMENT_ANNOTATION, Cluster  # noqa: F401  (import-light)

_LAZY = {
    "ClusterController": "controllers",
    "FederatedSyncController": "controllers",
    "MemberRegistry": "controllers",
    "ServiceDNSController": "controllers",
    "FederationControllerManager": "manager",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
