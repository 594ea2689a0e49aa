"""A real DNS server over UDP for the cluster zone.

The skydns half of the kube-dns addon (reference ``cluster/addons/dns/``):
real RFC-1035 wire format — header, QNAME label encoding, A and SRV
answers, NXDOMAIN/NOERROR codes — served from ``DNSRecordStore`` over a
datagram socket.  Pods (hollow or real processes) point their resolver at
this address; `svc.ns.svc.cluster.local` resolution happens over actual
UDP bytes, mirroring how the userspace proxier moves real TCP bytes.

Only the query opcode and IN class are implemented — the subset kube-dns
actually serves.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

from .records import DNSRecordStore

QTYPE_A = 1
QTYPE_SRV = 33
QTYPE_ANY = 255
QCLASS_IN = 1

# the largest UDP payload: what ``lookup`` reads of an answer
MAX_DATAGRAM = 65535

RCODE_OK = 0
RCODE_NXDOMAIN = 3
RCODE_NOTIMPL = 4


def encode_name(name: str) -> bytes:
    out = b""
    for label in name.strip(".").split("."):
        raw = label.encode()
        out += struct.pack("!B", len(raw)) + raw
    return out + b"\x00"


def decode_name(buf: bytes, off: int) -> tuple[str, int]:
    """Decode a (possibly compressed) QNAME; returns (name, next offset)."""
    labels = []
    jumps = 0
    end = None
    while True:
        if off >= len(buf):
            raise ValueError("truncated name")
        length = buf[off]
        if length & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(buf):
                raise ValueError("truncated pointer")
            ptr = ((length & 0x3F) << 8) | buf[off + 1]
            if end is None:
                end = off + 2
            off = ptr
            jumps += 1
            if jumps > 16:
                raise ValueError("pointer loop")
            continue
        off += 1
        if length == 0:
            break
        labels.append(buf[off:off + length].decode(errors="replace"))
        off += length
    return ".".join(labels), (end if end is not None else off)


def build_query(qname: str, qtype: int, txid: int = 0x1234) -> bytes:
    header = struct.pack("!HHHHHH", txid, 0x0100, 1, 0, 0, 0)  # RD set
    return header + encode_name(qname) + struct.pack("!HH", qtype, QCLASS_IN)


def parse_response(buf: bytes):
    """Minimal answer parser (tests / in-cluster resolver client).
    Returns (rcode, [(name, qtype, rdata)]) where rdata is an IP string
    for A and (priority, weight, port, target) for SRV."""
    (txid, flags, qd, an, ns, ar) = struct.unpack("!HHHHHH", buf[:12])
    rcode = flags & 0xF
    off = 12
    for _ in range(qd):
        _, off = decode_name(buf, off)
        off += 4
    answers = []
    for _ in range(an):
        name, off = decode_name(buf, off)
        qtype, qclass, ttl, rdlen = struct.unpack("!HHIH", buf[off:off + 10])
        off += 10
        rdata = buf[off:off + rdlen]
        off += rdlen
        if qtype == QTYPE_A and rdlen == 4:
            answers.append((name, qtype, socket.inet_ntoa(rdata)))
        elif qtype == QTYPE_SRV:
            prio, weight, port = struct.unpack("!HHH", rdata[:6])
            target, _ = decode_name(buf, off - rdlen + 6)
            answers.append((name, qtype, (prio, weight, port, target)))
        else:
            answers.append((name, qtype, rdata))
    return rcode, answers


class DNSServer:
    """UDP datagram server answering A/SRV from a DNSRecordStore."""

    def __init__(self, records: DNSRecordStore, host: str = "127.0.0.1",
                 port: int = 0, ttl: int = 30):
        self.records = records
        self.ttl = ttl
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()  # (host, real port)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"queries": 0, "nxdomain": 0}

    # -- wire building -------------------------------------------------------
    def _answer(self, buf: bytes) -> Optional[bytes]:
        if len(buf) < 12:
            return None
        (txid, flags, qd, _, _, _) = struct.unpack("!HHHHHH", buf[:12])
        opcode = (flags >> 11) & 0xF
        if opcode != 0 or qd < 1:
            header = struct.pack("!HHHHHH", txid, 0x8180 | RCODE_NOTIMPL, qd, 0, 0, 0)
            return header + buf[12:]
        qname, off = decode_name(buf, 12)
        qtype, qclass = struct.unpack("!HH", buf[off:off + 4])
        question = buf[12:off + 4]
        self.stats["queries"] += 1

        rrs = b""
        count = 0
        name_ptr = struct.pack("!H", 0xC000 | 12)  # compression → question
        if qclass == QCLASS_IN and qtype in (QTYPE_A, QTYPE_ANY):
            for ip in self.records.resolve(qname, "A"):
                rdata = socket.inet_aton(ip)
                rrs += name_ptr + struct.pack("!HHIH", QTYPE_A, QCLASS_IN,
                                              self.ttl, len(rdata)) + rdata
                count += 1
        if qclass == QCLASS_IN and qtype in (QTYPE_SRV, QTYPE_ANY):
            for port, target in self.records.resolve(qname, "SRV"):
                rdata = struct.pack("!HHH", 10, 10, port) + encode_name(target)
                rrs += name_ptr + struct.pack("!HHIH", QTYPE_SRV, QCLASS_IN,
                                              self.ttl, len(rdata)) + rdata
                count += 1
        rcode = RCODE_OK if count else RCODE_NXDOMAIN
        if not count:
            self.stats["nxdomain"] += 1
        # QR|AA|RD|RA + rcode
        header = struct.pack("!HHHHHH", txid, 0x8580 | rcode, 1, count, 0, 0)
        return header + question + rrs

    # -- serving -------------------------------------------------------------
    def serve_once(self) -> bool:
        try:
            buf, peer = self._sock.recvfrom(4096)
        except socket.timeout:
            return False
        try:
            resp = self._answer(buf)
        except Exception:
            # a malformed datagram (truncated QNAME, pointer loop, short
            # header) must never kill the serving thread — drop it
            self.stats["malformed"] = self.stats.get("malformed", 0) + 1
            return True
        if resp is not None:
            self._sock.sendto(resp, peer)
        return True

    def _loop(self) -> None:
        while not self._stopped.is_set():
            self.serve_once()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._sock.close()


def lookup(server_addr: tuple, qname: str, qtype: str = "A", timeout: float = 2.0):
    """Client-side resolver: one UDP query against ``server_addr``.
    Returns the list DNSRecordStore.resolve would (IPs, or SRV tuples
    without priority/weight)."""
    qt = QTYPE_A if qtype == "A" else QTYPE_SRV
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(build_query(qname, qt), server_addr)
        # the server answers in one datagram of any size (it never sets
        # TC): read up to the largest, or a headless Service's SRV answer
        # for a hundred pods (~7 KB) comes back cut short
        buf, _ = s.recvfrom(MAX_DATAGRAM)
    rcode, answers = parse_response(buf)
    if rcode != RCODE_OK:
        return []
    if qtype == "A":
        return [rd for _, t, rd in answers if t == QTYPE_A]
    return [(rd[2], rd[3]) for _, t, rd in answers if t == QTYPE_SRV]
