"""Encryption at rest for the durable store.

Capability of the reference's value-transformer stack
(``staging/src/k8s.io/apiserver/pkg/storage/value/`` — encrypt-on-write,
decrypt-on-read, multi-key chains for rotation, plaintext fallback for
migration).  Record bytes pass through a ``Transformer`` between the
store and disk: the WAL and snapshot hold ciphertext; the in-memory
store never sees it.

Primitive: an authenticated stream cipher built from the stdlib's HMAC
(no external crypto dependency):

- keys: ``enc_key``/``auth_key`` derived from the configured secret via
  HMAC-SHA256 domain separation;
- keystream: HMAC(enc_key, nonce ‖ counter) blocks XORed over the
  payload (HMAC-as-PRF in counter mode — the construction PBKDF2/HKDF
  build on);
- integrity: HMAC(auth_key, header ‖ nonce ‖ ciphertext), verified
  before decryption (encrypt-then-MAC);
- fresh 16-byte ``os.urandom`` nonce per record.

The record format equals the JAX package's, so either package decrypts
the other's data directory with the same keys.

Rotation mirrors the reference's provider config: a chain encrypts with
its FIRST transformer and decrypts with whichever key id a record names;
an ``identity`` tail reads (and optionally writes) plaintext, so turning
encryption on over an existing WAL is a rolling migration, exactly like
``EncryptionConfig`` with ``identity`` as the last provider.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

_MAGIC = b"ktpuenc1"  # 8 bytes, versioned
_NONCE_LEN = 16
_TAG_LEN = 32
_KEYID_LEN = struct.Struct(">H")


class DecryptionError(Exception):
    """Unreadable record: unknown key id, bad tag, or truncation."""


def _derive(secret: bytes, label: bytes) -> bytes:
    return hmac.new(secret, b"ktpu-store-" + label, hashlib.sha256).digest()


class HMACStreamTransformer:
    """One key: authenticated HMAC-CTR stream encryption."""

    def __init__(self, key_id: str, secret: bytes):
        if not secret:
            raise ValueError("empty secret")
        self.key_id = key_id.encode() if isinstance(key_id, str) else key_id
        if len(self.key_id) > 0xFFFF:
            raise ValueError("key id too long")
        self._enc_key = _derive(secret, b"encrypt")
        self._auth_key = _derive(secret, b"authenticate")

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < n:
            out += hmac.new(self._enc_key,
                            nonce + struct.pack(">Q", counter),
                            hashlib.sha256).digest()
            counter += 1
        return bytes(out[:n])

    def encrypt(self, plaintext: bytes) -> bytes:
        nonce = os.urandom(_NONCE_LEN)
        ct = bytes(a ^ b for a, b in
                   zip(plaintext, self._keystream(nonce, len(plaintext))))
        header = _MAGIC + _KEYID_LEN.pack(len(self.key_id)) + self.key_id
        tag = hmac.new(self._auth_key, header + nonce + ct,
                       hashlib.sha256).digest()
        return header + nonce + tag + ct

    def decrypt(self, data: bytes) -> bytes:
        header_len = len(_MAGIC) + _KEYID_LEN.size + len(self.key_id)
        header = data[:header_len]
        rest = data[header_len:]
        if len(rest) < _NONCE_LEN + _TAG_LEN:
            raise DecryptionError("truncated record")
        nonce = rest[:_NONCE_LEN]
        tag = rest[_NONCE_LEN:_NONCE_LEN + _TAG_LEN]
        ct = rest[_NONCE_LEN + _TAG_LEN:]
        want = hmac.new(self._auth_key, header + nonce + ct,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise DecryptionError("integrity check failed")
        return bytes(a ^ b for a, b in
                     zip(ct, self._keystream(nonce, len(ct))))


class TransformerChain:
    """Encrypt with the first key; decrypt by the key id a record names;
    fall through to plaintext for unprefixed (pre-encryption) records."""

    def __init__(self, transformers: list[HMACStreamTransformer],
                 write_plaintext: bool = False):
        if not transformers and not write_plaintext:
            raise ValueError("no transformers and plaintext writes disabled")
        self._by_id = {t.key_id: t for t in transformers}
        self._primary = transformers[0] if transformers else None
        self.write_plaintext = write_plaintext

    @classmethod
    def from_keys(cls, keys: list[tuple[str, bytes]],
                  write_plaintext: bool = False) -> "TransformerChain":
        return cls([HMACStreamTransformer(kid, secret)
                    for kid, secret in keys], write_plaintext)

    def encrypt(self, plaintext: bytes) -> bytes:
        if self._primary is None or self.write_plaintext:
            return plaintext
        return self._primary.encrypt(plaintext)

    def decrypt(self, data: bytes) -> bytes:
        if not data.startswith(_MAGIC):
            return data  # pre-encryption plaintext record (migration)
        off = len(_MAGIC)
        (kid_len,) = _KEYID_LEN.unpack(data[off:off + _KEYID_LEN.size])
        kid = data[off + _KEYID_LEN.size:off + _KEYID_LEN.size + kid_len]
        t = self._by_id.get(kid)
        if t is None:
            raise DecryptionError(f"no key for id {kid!r}")
        return t.decrypt(data)


def identity() -> TransformerChain:
    return TransformerChain([], write_plaintext=True)
