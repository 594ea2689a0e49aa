"""Durable persistence for the store: write-ahead log + snapshot.

The reference's L0 is etcd: every write lands in a raft-replicated WAL
before it is acknowledged, and periodic snapshots bound replay time
(``vendor/github.com/coreos/etcd``; forked WAL code under
``third_party/forked/etcd221``).  This module gives the in-process store
the same durability contract on one node:

- every committed event appends a ``[len][crc32][payload]`` record to
  ``wal.bin`` (the binary wire codec of ``api/wire.py``),
- ``snapshot.bin`` holds a full state image at a revision; opening a
  store replays snapshot + WAL tail,
- compaction rewrites the snapshot and truncates the WAL once it grows
  past ``compact_every`` records,
- a torn final record (crash mid-append) is detected **structurally**
  (short length prefix / short payload) or by a CRC mismatch on the
  file's last record, and truncated on replay — exactly the record that
  was never acknowledged (etcd's ``wal.ReadAll`` tail repair),
- a CRC mismatch on a record that is *not* the tail is different in kind:
  acknowledged history was corrupted, and recovery refuses to guess
  (:class:`CorruptWALError`) rather than silently dropping everything
  after it.

The files are the JAX package's, byte for byte in their framing: a data
directory written by either package recovers in the other.  Replication
and HA keep the reference's split: the store process is the etcd
analogue (``store/replication.py`` ships its events to followers),
stateless apiservers above it restart freely, and the daemons fail over
with leader election.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

from .. import faults
from ..api import wire
from ..utils import tracing

SNAPSHOT = "snapshot.bin"
WAL = "wal.bin"
_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
_HEADER = _LEN.size + _CRC.size
# v2 file marker: CRC-framed records follow.  A log without it is the
# v1 ``[len][payload]`` format and is read that way — an upgrade must
# never misparse acknowledged history as corruption.  (No collision
# risk: a v1 file starts with a 4-byte record length, and b"KTPU" as a
# big-endian length would be a ~1.2 GB record.)
_MAGIC = b"KTPUWAL2"


class CorruptWALError(Exception):
    """A non-tail WAL record failed its checksum: acknowledged history is
    damaged (bad disk, truncation in the middle, wrong file).  Replay
    stops loudly — silently dropping acked records would un-commit writes
    that callers were told succeeded."""


class WriteAheadLog:
    def __init__(self, data_dir: str, compact_every: int = 100_000,
                 fsync: bool = False, transformer=None):
        os.makedirs(data_dir, exist_ok=True)
        self.dir = data_dir
        self.compact_every = compact_every
        self.fsync = fsync
        self._mu = threading.Lock()
        self._wal_path = os.path.join(data_dir, WAL)
        self._snap_path = os.path.join(data_dir, SNAPSHOT)
        self._f = None
        self._records_since_snapshot = 0
        # encryption at rest (store/encryption.py, the reference's
        # storage/value transformer seam): record/snapshot bytes pass
        # through here on the way to and from disk; None = plaintext
        self.transformer = transformer
        # what the last recover() observed — the crash-consistency audit
        # trail the fault matrix asserts on
        self.last_recovery: dict = {"replayed": 0, "truncated_bytes": 0,
                                    "torn_tail": False, "revision": 0}
        # detected on read (recover/open): False for a pre-CRC v1 file,
        # which keeps its framing until compaction rewrites it as v2
        self._crc_format = True

    def _detect_format(self) -> None:
        if os.path.exists(self._wal_path) and os.path.getsize(self._wal_path) > 0:
            with open(self._wal_path, "rb") as f:
                self._crc_format = f.read(len(_MAGIC)) == _MAGIC
        else:
            self._crc_format = True

    # -- recovery ----------------------------------------------------------
    def recover(self) -> tuple[int, dict, int]:
        """Returns (revision, {kind: {key: data}}, replayed_records)."""
        rev = 0
        objects: dict[str, dict[str, dict]] = {}
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                raw = f.read()
            if self.transformer is not None:
                raw = self.transformer.decrypt(raw)
            snap = wire.decode(raw)
            rev = int(snap["rev"])
            objects = snap["objects"]
        replayed = 0
        self._detect_format()
        valid_end = len(_MAGIC) if (self._crc_format and os.path.exists(
            self._wal_path) and os.path.getsize(self._wal_path) > 0) else 0
        for rec, offset in self._read_wal():
            replayed += 1
            valid_end = offset
            rev = max(rev, int(rec["r"]))
            kind, key = rec["k"], rec["key"]
            bucket = objects.setdefault(kind, {})
            if rec["t"] == "DELETED":
                bucket.pop(key, None)
            else:
                bucket[key] = rec["o"]
        # drop the torn/corrupt tail NOW: future appends must follow the
        # last valid record, or they'd be unreachable behind the garbage
        truncated = 0
        if os.path.exists(self._wal_path):
            size = os.path.getsize(self._wal_path)
            if size > valid_end:
                truncated = size - valid_end
                with open(self._wal_path, "r+b") as f:
                    f.truncate(valid_end)
        self._records_since_snapshot = replayed
        self.last_recovery = {"replayed": replayed,
                              "truncated_bytes": truncated,
                              "torn_tail": truncated > 0,
                              "revision": rev}
        return rev, objects, replayed

    def _read_wal(self):
        """Yields (record, end_offset) for every intact record.

        Torn appends (a crash mid-write) are detected two ways, both
        confined to the file TAIL: the length prefix or payload comes up
        short (structural), or the last record's CRC disagrees with its
        payload (the bytes landed but not all of them were the write's).
        Either way that record was never acknowledged and the tail is
        dropped.  A CRC mismatch on a record with valid records *after*
        it — or a structurally complete record mid-file that fails
        decryption/decoding — is real corruption of acknowledged history
        and propagates loudly rather than silently truncating the log."""
        if not os.path.exists(self._wal_path):
            return
        size = os.path.getsize(self._wal_path)
        header_size = _HEADER if self._crc_format else _LEN.size
        with open(self._wal_path, "rb") as f:
            if self._crc_format and size > 0:
                f.read(len(_MAGIC))
            while True:
                head = f.read(header_size)
                if len(head) < header_size:
                    return  # clean EOF or torn header
                (n,) = _LEN.unpack(head[: _LEN.size])
                payload = f.read(n)
                if len(payload) < n:
                    return  # torn record: crash mid-append, never acked
                if self._crc_format:
                    (want_crc,) = _CRC.unpack(head[_LEN.size:])
                    if zlib.crc32(payload) != want_crc:
                        if f.tell() >= size:
                            return  # tail half-written: torn, drop it
                        raise CorruptWALError(
                            f"{self._wal_path}: CRC mismatch at offset "
                            f"{f.tell() - n - header_size} with valid "
                            "records after it — acknowledged history is "
                            "damaged")
                if self.transformer is not None:
                    payload = self.transformer.decrypt(payload)
                yield wire.decode(payload), f.tell()

    # -- append ------------------------------------------------------------
    def open(self) -> None:
        self._detect_format()
        fresh = (not os.path.exists(self._wal_path)
                 or os.path.getsize(self._wal_path) == 0)
        self._f = open(self._wal_path, "ab")
        if fresh:
            # new logs are v2; a surviving v1 log keeps its framing
            # until the next compaction rewrites it
            self._f.write(_MAGIC)
            self._f.flush()

    def append(self, ev_type: str, kind: str, key: str, rev: int,
               obj: dict) -> None:
        fault = faults.hit("store.wal.append", kind=kind, key=key)
        payload = wire.encode({"t": ev_type, "k": kind, "key": key,
                               "r": rev, "o": obj})
        if self.transformer is not None:
            payload = self.transformer.encrypt(payload)
        header = _LEN.pack(len(payload))
        if self._crc_format:
            header += _CRC.pack(zlib.crc32(payload))
        tr = tracing.current()
        # span covers lock wait + write + fsync: the durable-append cost
        # a slow disk charges every txn
        with (tr.span("wal.append", cat="store", kind=kind)
              if tr is not None else tracing.NULL_SPAN), self._mu:
            if self._f is None:
                self.open()
            if fault is not None and fault.mode == "torn":
                # crash mid-append: the header promises more bytes than
                # land.  Flush what DID land (the crash happens after the
                # page made it out) and die like the process would.
                cut = max(0, int(len(payload) * fault.value))
                self._f.write(header)
                self._f.write(payload[:cut])
                self._f.flush()
                if self.fsync:
                    # torn-write fault: flush the partial record like the
                    # dying process would, under the same lock hold
                    # blocking-ok — fault path mirrors the real append's durability point
                    os.fsync(self._f.fileno())
                raise faults.FaultInjected(
                    f"torn WAL append for {kind}/{key} (crash mid-write: "
                    f"{cut}/{len(payload)} payload bytes on disk)")
            self._f.write(header)
            self._f.write(payload)
            self._f.flush()
            if self.fsync:
                # no caller may observe this txn before its bytes are on
                # disk, so the fsync completes inside the append's lock hold
                # blocking-ok — WAL durability IS the commit point
                os.fsync(self._f.fileno())
            self._records_since_snapshot += 1

    def needs_compaction(self) -> bool:
        return self._records_since_snapshot >= self.compact_every

    # -- snapshot / compaction ----------------------------------------------
    def write_snapshot(self, rev: int, objects: dict) -> None:
        """Atomic snapshot + WAL truncation (the never-lose-state order:
        new snapshot durable FIRST, then drop the log it subsumes)."""
        with self._mu:
            tmp = f"{self._snap_path}.tmp"
            blob = wire.encode({"rev": rev, "objects": objects})
            if self.transformer is not None:
                blob = self.transformer.encrypt(blob)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                # blocking-ok — snapshot durable before the rename that retires the WAL
                os.fsync(f.fileno())
            os.replace(tmp, self._snap_path)
            if self._f is not None:
                self._f.close()
            self._f = open(self._wal_path, "wb")  # truncate
            self._f.write(_MAGIC)  # compaction upgrades a v1 log to v2
            self._f.flush()
            self._crc_format = True
            self._records_since_snapshot = 0

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                self._f.close()
                self._f = None
