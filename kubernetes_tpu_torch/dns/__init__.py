"""In-cluster DNS: the kube-dns addon analogue (``cluster/addons/dns/``)."""

from .records import DEFAULT_ZONE, DNSRecordStore
from .server import DNSServer, lookup

__all__ = ["DEFAULT_ZONE", "DNSRecordStore", "DNSServer", "lookup"]
