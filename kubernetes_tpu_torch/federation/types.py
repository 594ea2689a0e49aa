"""Federation API types (reference ``federation/apis/federation/types.go``):
the Cluster registry object — one row per member cluster, carrying its
API endpoint + credential reference and health conditions maintained by
the cluster controller."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..api.meta import ObjectMeta
from ..api.types import register_kind

CLUSTER_READY = "Ready"
CLUSTER_OFFLINE = "Offline"

# placement annotation on a federated object: JSON list of member cluster
# names (reference used per-kind preferences; an explicit cluster list is
# the capability essential)
PLACEMENT_ANNOTATION = "federation.kubernetes.io/clusters"


@dataclass
class Cluster:
    """A member cluster (reference ``federation/apis/federation``
    Cluster: serverAddressByClientCIDRs + secretRef + status.conditions)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    server_address: str = ""
    token: str = ""  # credential for the member apiserver ("" = none)
    conditions: list[dict] = field(default_factory=list)
    # zone/region the member reports — consumed by cross-cluster DNS
    zone: str = ""
    region: str = ""

    KIND = "Cluster"

    def __post_init__(self):
        self.meta.namespace = ""

    def condition(self, ctype: str) -> dict | None:
        for c in self.conditions:
            if c.get("type") == ctype:
                return c
        return None

    @property
    def ready(self) -> bool:
        c = self.condition(CLUSTER_READY)
        return c is not None and c.get("status") == "True"

    def set_condition(self, ctype: str, status: str, clock=time.time) -> None:
        c = self.condition(ctype)
        if c is None:
            self.conditions.append(
                {"type": ctype, "status": status, "lastProbeTime": clock()})
        else:
            c["status"] = status
            c["lastProbeTime"] = clock()

    def to_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "metadata": self.meta.to_dict(),
            "spec": {
                "serverAddress": self.server_address,
                "token": self.token,
                "zone": self.zone,
                "region": self.region,
            },
            "status": {"conditions": [dict(c) for c in self.conditions]},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Cluster":
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        return cls(
            meta=ObjectMeta.from_dict(d.get("metadata") or {}),
            server_address=spec.get("serverAddress", ""),
            token=spec.get("token", ""),
            zone=spec.get("zone", ""),
            region=spec.get("region", ""),
            conditions=[dict(c) for c in status.get("conditions") or []],
        )


register_kind(Cluster, cluster_scoped=True)
