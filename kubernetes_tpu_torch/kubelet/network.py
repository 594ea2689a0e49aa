"""The kubelet's network plugin seam — pod address lifecycle.

Capability of ``pkg/kubelet/network`` (the CNI/kubenet plugin manager):
pod sandboxes get their address through a pluggable interface with a real
setup/teardown lifecycle, not an ambient counter.  The kubenet-analogue
plugin runs a real IPAM over the node's allocated podCIDR: addresses are
leased per pod, released on teardown, reused after release, and
exhaustion is a hard error the kubelet surfaces (the reference's CNI
ADD failure keeps the pod from starting).

Host-network pods bypass the plugin entirely and take the node's own
address, exactly like ``hostNetwork: true``.
"""

from __future__ import annotations

import zlib
from typing import Optional


class NetworkSetupError(Exception):
    """CNI ADD failed (exhausted range, plugin misconfigured)."""


class NetworkPlugin:
    """The seam (reference ``network.NetworkPlugin``)."""

    name = "noop"

    def setup_pod(self, pod_key: str) -> str:
        raise NotImplementedError

    def teardown_pod(self, pod_key: str) -> None:
        raise NotImplementedError

    def pod_ip(self, pod_key: str) -> Optional[str]:
        raise NotImplementedError

    def status(self) -> dict:
        return {"name": self.name}


class KubenetPlugin(NetworkPlugin):
    """Kubenet-shaped IPAM over the node's podCIDR.

    One /24-style range per node: .1 is reserved for the bridge (cbr0),
    pods lease .2–.254, leases release on teardown and recycle
    lowest-free-first (the host-local IPAM allocator's behavior)."""

    name = "kubenet"

    def __init__(self, node_name: str, pod_cidr: str = ""):
        self.node_name = node_name
        self.has_cidr = bool(pod_cidr and "/" in pod_cidr)
        if self.has_cidr:
            self.base = pod_cidr.split("/", 1)[0].rsplit(".", 1)[0]
        else:
            # no CIDR allocated (IPAM controller absent): a stable
            # crc32-derived base — never hash(), which is seed-randomized
            h = zlib.crc32(node_name.encode()) & 0xFFFF
            self.base = f"10.{h >> 8}.{h & 0xFF}"
        self._leases: dict[str, int] = {}  # pod key -> host octet
        self._in_use: set[int] = {1}  # .1 = the bridge
        self.stats = {"setups": 0, "teardowns": 0, "exhausted": 0}

    def setup_pod(self, pod_key: str) -> str:
        n = self._leases.get(pod_key)
        if n is None:
            for cand in range(2, 255):  # lowest-free-first (host-local)
                if cand not in self._in_use:
                    n = cand
                    break
            else:
                self.stats["exhausted"] += 1
                raise NetworkSetupError(
                    f"podCIDR {self.base}.0/24 exhausted on {self.node_name}")
            self._in_use.add(n)
            self._leases[pod_key] = n
            self.stats["setups"] += 1
        return f"{self.base}.{n}"

    def adopt(self, pod_key: str, ip: str) -> bool:
        """Seed an existing pod's lease (kubelet restart recovery): a
        fresh plugin must not hand a running pod's address to a new pod.
        Returns False for addresses outside this plugin's range (e.g.
        leased under a pre-CIDR hash base) — those cannot collide with
        this range, so skipping them is safe."""
        prefix = self.base + "."
        if not ip.startswith(prefix):
            return False
        try:
            n = int(ip[len(prefix):])
        except ValueError:
            return False
        # 2-254 only, matching setup_pod's lease range: .1 is the reserved
        # cbr0 bridge address and must never be recorded as a pod lease
        if not 2 <= n <= 254:
            return False
        self._leases[pod_key] = n
        self._in_use.add(n)
        return True

    def teardown_pod(self, pod_key: str) -> None:
        n = self._leases.pop(pod_key, None)
        if n is not None:
            self._in_use.discard(n)
            self.stats["teardowns"] += 1

    def pod_ip(self, pod_key: str) -> Optional[str]:
        n = self._leases.get(pod_key)
        return None if n is None else f"{self.base}.{n}"

    def leased(self) -> set[str]:
        return set(self._leases)

    def status(self) -> dict:
        return {"name": self.name, "cidr": f"{self.base}.0/24",
                "leased": len(self._leases), **self.stats}
