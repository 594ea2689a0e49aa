"""Node agent layer: the hollow kubelet and its fleet (the kubemark
packing of many nodes into one process), with the cgroup ledger, PLEG,
CRI, network, volumes and the kubelet's read and exec API."""

from ..client.informer import PodNodeIndex
from .hollow import HollowFleet, HollowKubelet
