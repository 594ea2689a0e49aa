"""Binary wire format: the protobuf-equivalent serialization, and the
durable store's record format (``store/wal.py``).

The reference stores protobuf in etcd and negotiates
``application/vnd.kubernetes.protobuf`` between clients and the
apiserver (``runtime/serializer/protobuf``; stored values carry a 4-byte
magic prefix).  This codec fills the same role for the wire objects (the
dict form every kind round-trips through): a compact tag/length/value
encoding with an interned key table, so a snapshot of 10k pods does not
repeat ``"metadata"`` ten thousand times the way JSON does.  Its bytes
equal the JAX package's codec byte for byte, so a data directory written
by either package is read by the other.

Layout:
    MAGIC (4 bytes) | key-table | root value
    key-table  = varint count, then count x (varint len | utf8)
    value      = 1 type byte, then payload
        0 null | 1 true | 2 false
        3 int     zigzag varint
        4 float   8-byte IEEE754 big-endian
        5 str     varint len | utf8
        7 list    varint count | values
        8 dict    varint count | (varint key-id | value) pairs
        9 str-interned  varint key-id   (repeated string values)
"""

from __future__ import annotations

import struct

MAGIC = b"ktpu"


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n: int) -> int:
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class _Encoder:
    def __init__(self):
        self.keys: dict[str, int] = {}
        self.body = bytearray()
        self._seen_long: set[str] = set()

    def _key_id(self, key: str) -> int:
        kid = self.keys.get(key)
        if kid is None:
            kid = len(self.keys)
            self.keys[key] = kid
        return kid

    def value(self, v) -> None:
        out = self.body
        if v is None:
            out.append(0)
        elif v is True:
            out.append(1)
        elif v is False:
            out.append(2)
        elif isinstance(v, int):
            out.append(3)
            _write_varint(out, _zigzag(v))
        elif isinstance(v, float):
            out.append(4)
            out += struct.pack(">d", v)
        elif isinstance(v, str):
            # intern repeated strings (label values, phases, kinds): the
            # second occurrence costs 1-3 bytes.  Short strings intern
            # eagerly; long ones (image digests, cert blobs) from their
            # SECOND occurrence, so a unique long string isn't stored
            # twice (inline + table)
            if v in self.keys or (v and (len(v) < 64 or v in self._seen_long)):
                out.append(9)
                _write_varint(out, self._key_id(v))
            else:
                if v:
                    self._seen_long.add(v)
                data = v.encode()
                out.append(5)
                _write_varint(out, len(data))
                out += data
        elif isinstance(v, list):
            out.append(7)
            _write_varint(out, len(v))
            for item in v:
                self.value(item)
        elif isinstance(v, dict):
            out.append(8)
            _write_varint(out, len(v))
            for k, item in v.items():
                _write_varint(out, self._key_id(str(k)))
                self.value(item)
        else:
            # Quantity and friends serialize through their json form
            to_json = getattr(v, "to_json", None)
            if to_json is not None:
                self.value(to_json())
            else:
                raise TypeError(f"unencodable type {type(v)!r}")


def encode(obj) -> bytes:
    enc = _Encoder()
    enc.value(obj)
    table = bytearray()
    _write_varint(table, len(enc.keys))
    for key in enc.keys:  # dicts preserve insertion order = id order
        data = key.encode()
        _write_varint(table, len(data))
        table += data
    return MAGIC + bytes(table) + bytes(enc.body)


def decode(data: bytes):
    if data[:4] != MAGIC:
        raise ValueError("bad magic: not ktpu binary wire data")
    count, pos = _read_varint(data, 4)
    keys: list[str] = []
    for _ in range(count):
        ln, pos = _read_varint(data, pos)
        keys.append(data[pos:pos + ln].decode())
        pos += ln

    def read(pos: int):
        t = data[pos]
        pos += 1
        if t == 0:
            return None, pos
        if t == 1:
            return True, pos
        if t == 2:
            return False, pos
        if t == 3:
            n, pos = _read_varint(data, pos)
            return _unzigzag(n), pos
        if t == 4:
            return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
        if t == 5:
            ln, pos = _read_varint(data, pos)
            return data[pos:pos + ln].decode(), pos + ln
        if t == 7:
            n, pos = _read_varint(data, pos)
            out = []
            for _ in range(n):
                v, pos = read(pos)
                out.append(v)
            return out, pos
        if t == 8:
            n, pos = _read_varint(data, pos)
            d = {}
            for _ in range(n):
                kid, pos = _read_varint(data, pos)
                v, pos = read(pos)
                d[keys[kid]] = v
            return d, pos
        if t == 9:
            kid, pos = _read_varint(data, pos)
            return keys[kid], pos
        raise ValueError(f"bad type tag {t} at {pos - 1}")

    value, _ = read(pos)
    return value
