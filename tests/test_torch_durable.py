"""The port's durable store: the write-ahead log, snapshots, encryption at
rest and recovery (``store/wal.py``, ``store/encryption.py``,
``Store(data_dir=...)``).

Twins of the WAL cases of ``tests/test_store.py``, of the WAL cases of
``tests/test_faults.py`` (torn tails, CRC framing, the v1 log without
CRC, the ``store.wal.append`` torn seam) and of ``tests/test_encryption.py``;
then the cross-package checks: a data directory written by the JAX
``Store`` is recovered by the port's with the same objects and revision,
and the reverse, plain and encrypted, with and without a snapshot; each
package then writes on and the other recovers again.  Tolerance: exact
equality."""

import importlib

import pytest

from kubernetes_tpu_torch import faults
from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.store.encryption import (
    DecryptionError,
    HMACStreamTransformer,
    TransformerChain,
)
from kubernetes_tpu_torch.store.wal import CorruptWALError, WriteAheadLog
from kubernetes_tpu_torch.testutil import make_pod
from kubernetes_tpu_torch.utils import tracing

JAX, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"


# -- the WAL and recovery (twins of tests/test_store.py) ----------------------


def _mk(name, ns="default", labels=None):
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         "labels": dict(labels or {})},
            "spec": {}, "status": {"phase": "Pending"}}


def test_wal_recovery_roundtrip(tmp_path):
    d = str(tmp_path / "state")
    s = Store(data_dir=d)
    s.create("Pod", _mk("a"))
    s.create("Pod", _mk("b", labels={"app": "web"}))
    b = s.get("Pod", "default", "b")
    b["status"]["phase"] = "Running"
    s.update("Pod", b)
    s.delete("Pod", "default", "a")
    rev = s.revision
    s.close()

    s2 = Store(data_dir=d)
    pods, _ = s2.list("Pod", None)
    assert [p["metadata"]["name"] for p in pods] == ["b"]
    assert pods[0]["status"]["phase"] == "Running"
    assert pods[0]["metadata"]["labels"] == {"app": "web"}
    # revision continuity: new writes continue AFTER the recovered rev
    assert s2.revision == rev
    created = s2.create("Pod", _mk("c"))
    assert int(created["metadata"]["resourceVersion"]) == rev + 1
    s2.close()


def test_wal_survives_many_restarts(tmp_path):
    d = str(tmp_path / "state")
    for i in range(5):
        s = Store(data_dir=d)
        s.create("Pod", _mk(f"p{i}"))
        s.close()
    s = Store(data_dir=d)
    assert len(s.list("Pod", None)[0]) == 5
    s.close()


def test_wal_torn_tail_is_dropped(tmp_path):
    """A crash mid-append leaves a torn record; recovery keeps everything
    acknowledged before it and drops only the unacked tail."""
    d = str(tmp_path / "state")
    s = Store(data_dir=d)
    s.create("Pod", _mk("ok1"))
    s.create("Pod", _mk("ok2"))
    s.close()
    wal = tmp_path / "state" / "wal.bin"
    data = wal.read_bytes()
    # simulate torn write: append a length prefix promising more than exists
    wal.write_bytes(data + b"\x00\x00\x10\x00" + b"partial")
    s2 = Store(data_dir=d)
    assert {p["metadata"]["name"] for p in s2.list("Pod", None)[0]} == {"ok1", "ok2"}
    # the store is writable after recovery from a torn tail
    s2.create("Pod", _mk("ok3"))
    s2.close()
    s3 = Store(data_dir=d)
    assert len(s3.list("Pod", None)[0]) == 3
    s3.close()


def test_compaction_snapshot_and_truncate(tmp_path):
    d = str(tmp_path / "state")
    s = Store(data_dir=d, compact_every=50)
    for i in range(120):  # crosses the compaction threshold twice
        s.create("Pod", _mk(f"p{i:03d}"))
    s.close()
    import os

    snap_size = os.path.getsize(tmp_path / "state" / "snapshot.bin")
    assert snap_size > 0
    # WAL holds at most one compaction window, not all 120 records: a
    # broken truncation (e.g. reopening append-mode) would fail here
    from kubernetes_tpu_torch.store.wal import WriteAheadLog

    leftover = sum(1 for _ in WriteAheadLog(d)._read_wal())
    assert leftover < 50, f"WAL not truncated by compaction ({leftover} records)"
    s2 = Store(data_dir=d, compact_every=50)
    assert len(s2.list("Pod", None)[0]) == 120
    s2.close()
    # explicit compact truncates the WAL entirely (only the v2 format
    # magic remains — zero records)
    s3 = Store(data_dir=d)
    s3.compact()
    wal = WriteAheadLog(d)
    wal._detect_format()
    assert sum(1 for _ in wal._read_wal()) == 0
    assert os.path.getsize(tmp_path / "state" / "wal.bin") == 8  # magic only


def test_registry_counts_fired(tmp_path):
    point = faults.registry()["store.wal.append"]
    before = point.fired
    wal = WriteAheadLog(str(tmp_path))
    plan = FaultPlan().on("store.wal.append", mode="error", nth=1)
    with plan.armed():
        with pytest.raises(FaultInjected):
            wal.append("ADDED", "Pod", "default/p", 1, {"metadata": {}})
    assert point.fired == before + 1


# -- torn tails, CRC framing and the v1 log (twins of tests/test_faults.py 2a) --

def _ev(i):
    return ("ADDED", "Pod", f"default/p{i}", i,
            {"metadata": {"name": f"p{i}", "resourceVersion": i}})


def test_wal_torn_payload_truncated_on_replay(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d)
    for i in range(1, 6):
        wal.append(*_ev(i))
    wal.close()
    # tear the tail mid-payload (crash between write() and the last page)
    path = f"{d}/wal.bin"
    with open(path, "r+b") as f:
        f.truncate(max(9, int(f.seek(0, 2)) - 7))
    wal2 = WriteAheadLog(d)
    rev, objects, replayed = wal2.recover()
    assert replayed == 4 and rev == 4  # record 5 was never acked
    assert wal2.last_recovery["torn_tail"]
    assert wal2.last_recovery["truncated_bytes"] > 0
    # the file is clean again: appends continue from the valid end
    wal2.open()
    wal2.append(*_ev(5))
    wal2.close()
    wal3 = WriteAheadLog(d)
    _, _, replayed = wal3.recover()
    assert replayed == 5 and not wal3.last_recovery["torn_tail"]


def test_wal_crc_mismatch_on_tail_is_torn(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d)
    for i in range(1, 4):
        wal.append(*_ev(i))
    wal.close()
    path = f"{d}/wal.bin"
    with open(path, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))  # bit-flip inside the LAST record
    wal2 = WriteAheadLog(d)
    _, _, replayed = wal2.recover()
    assert replayed == 2
    assert wal2.last_recovery["torn_tail"]


def test_wal_crc_mismatch_mid_log_raises_loudly(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d)
    for i in range(1, 4):
        wal.append(*_ev(i))
    wal.close()
    with open(f"{d}/wal.bin", "r+b") as f:
        f.seek(20)  # inside record 1's payload (past magic + header),
        b = f.read(1)  # with records 2..3 intact after it
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    wal2 = WriteAheadLog(d)
    wal2._detect_format()
    with pytest.raises(CorruptWALError):
        list(wal2._read_wal())


def test_wal_v1_file_without_crc_still_recovers(tmp_path):
    """A pre-CRC log ([len][payload], no magic) must replay cleanly —
    the format upgrade cannot read acknowledged history as corruption —
    and compaction rewrites it as v2."""
    import struct

    from kubernetes_tpu_torch.api import wire

    d = str(tmp_path)
    path = f"{d}/wal.bin"
    with open(path, "wb") as f:
        for i in range(1, 4):
            t, k, key, r, o = _ev(i)
            payload = wire.encode({"t": t, "k": k, "key": key, "r": r, "o": o})
            f.write(struct.pack(">I", len(payload)))
            f.write(payload)
    wal = WriteAheadLog(d)
    rev, objects, replayed = wal.recover()
    assert replayed == 3 and rev == 3
    assert not wal._crc_format  # detected v1, kept its framing
    wal.open()
    wal.append(*_ev(4))  # appends continue in v1 framing
    wal.close()
    wal2 = WriteAheadLog(d)
    _, _, replayed = wal2.recover()
    assert replayed == 4
    # compaction upgrades the file to v2
    wal2.write_snapshot(4, objects)
    wal2.append(*_ev(5))
    wal2.close()
    wal3 = WriteAheadLog(d)
    rev, _, replayed = wal3.recover()
    assert wal3._crc_format and replayed == 1 and rev == 5


def test_wal_torn_fault_point_roundtrip(tmp_path):
    """The injected torn write is indistinguishable from a real crash:
    header promises more bytes than landed; recovery truncates."""
    d = str(tmp_path)
    store = Store(data_dir=d)
    cs = Clientset(store)
    cs.pods.create(make_pod("survivor", cpu="100m"))
    plan = FaultPlan().on("store.wal.append", mode="torn", value=0.5)
    with plan.armed():
        with pytest.raises(FaultInjected):
            cs.pods.create(make_pod("casualty", cpu="100m"))
    store.close()  # crash

    store2 = Store(data_dir=d)
    assert store2._wal.last_recovery["torn_tail"]
    assert store2._wal.last_recovery["truncated_bytes"] > 0
    cs2 = Clientset(store2)
    names = {p.meta.name for p in cs2.pods.list()[0]}
    assert names == {"survivor"}  # the unacked create is gone, cleanly
    # and the recovered store accepts writes again
    cs2.pods.create(make_pod("after", cpu="100m"))
    store2.close()


# -- encryption at rest (twins of tests/test_encryption.py) ------------------


def test_roundtrip_and_nonce_freshness():
    t = HMACStreamTransformer("key1", b"secret-material")
    ct1 = t.encrypt(b"hello world")
    ct2 = t.encrypt(b"hello world")
    assert ct1 != ct2  # fresh nonce per record
    assert t.decrypt(ct1) == b"hello world"
    assert t.decrypt(ct2) == b"hello world"
    assert b"hello world" not in ct1


def test_tamper_detection():
    t = HMACStreamTransformer("key1", b"secret-material")
    ct = bytearray(t.encrypt(b"payload"))
    ct[-1] ^= 0x01
    with pytest.raises(DecryptionError):
        t.decrypt(bytes(ct))
    # truncation is also caught
    with pytest.raises(DecryptionError):
        t.decrypt(t.encrypt(b"payload")[:20])


def test_chain_rotation_and_plaintext_fallback():
    old = TransformerChain.from_keys([("k1", b"old-secret")])
    ct_old = old.encrypt(b"written-under-k1")
    # rotated config: new primary, old key still readable
    rotated = TransformerChain.from_keys([("k2", b"new-secret"),
                                          ("k1", b"old-secret")])
    assert rotated.decrypt(ct_old) == b"written-under-k1"
    ct_new = rotated.encrypt(b"written-under-k2")
    assert ct_new[:8] == ct_old[:8]  # same magic
    assert rotated.decrypt(ct_new) == b"written-under-k2"
    # the old chain cannot read the new key's records
    with pytest.raises(DecryptionError):
        old.decrypt(ct_new)
    # pre-encryption plaintext records pass through (migration)
    assert rotated.decrypt(b"plain-old-record") == b"plain-old-record"


def test_encrypted_store_recovers(tmp_path):
    chain = TransformerChain.from_keys([("k1", b"store-secret")])
    store = Store(data_dir=str(tmp_path), transformer=chain)
    cs = Clientset(store)
    cs.pods.create(make_pod("secret-pod", labels={"token": "s3cr3t-value"}))
    cs.pods.create(make_pod("p2"))
    cs.pods.delete("p2")
    rev = store.revision
    store.close()

    # the disk holds NO plaintext: neither names nor label values
    blob = (tmp_path / "wal.bin").read_bytes()
    snap_path = tmp_path / "snapshot.bin"
    if snap_path.exists():
        blob += snap_path.read_bytes()
    assert b"secret-pod" not in blob
    assert b"s3cr3t-value" not in blob

    revived = Store(data_dir=str(tmp_path),
                    transformer=TransformerChain.from_keys(
                        [("k1", b"store-secret")]))
    assert revived.revision == rev
    pods, _ = revived.list("Pod")
    assert [p["metadata"]["name"] for p in pods] == ["secret-pod"]
    assert pods[0]["metadata"]["labels"]["token"] == "s3cr3t-value"


def test_encrypted_snapshot_roundtrip(tmp_path):
    chain = TransformerChain.from_keys([("k1", b"store-secret")])
    store = Store(data_dir=str(tmp_path), transformer=chain, compact_every=5)
    cs = Clientset(store)
    for i in range(12):  # crosses the compaction threshold
        cs.pods.create(make_pod(f"p{i:02d}"))
    store.compact()
    store.close()
    assert b"p00" not in (tmp_path / "snapshot.bin").read_bytes()
    revived = Store(data_dir=str(tmp_path),
                    transformer=TransformerChain.from_keys(
                        [("k1", b"store-secret")]))
    assert len(revived.list("Pod")[0]) == 12


def test_wrong_key_fails_loudly(tmp_path):
    store = Store(data_dir=str(tmp_path),
                  transformer=TransformerChain.from_keys([("k1", b"right")]))
    Clientset(store).pods.create(make_pod("p1"))
    store.close()
    with pytest.raises(DecryptionError):
        Store(data_dir=str(tmp_path),
              transformer=TransformerChain.from_keys([("k1", b"wrong")]))


def test_migration_plaintext_wal_readable_with_encryption_on(tmp_path):
    """Turning encryption on over an existing plaintext WAL: old records
    replay, new records land encrypted (EncryptionConfig + identity)."""
    plain = Store(data_dir=str(tmp_path))
    Clientset(plain).pods.create(make_pod("old-pod"))
    plain.close()
    enc = Store(data_dir=str(tmp_path),
                transformer=TransformerChain.from_keys([("k1", b"s")]))
    cs = Clientset(enc)
    assert cs.pods.get("old-pod").meta.name == "old-pod"
    cs.pods.create(make_pod("new-pod"))
    enc.close()
    blob = (tmp_path / "wal.bin").read_bytes()
    assert b"old-pod" in blob      # the pre-encryption record
    assert b"new-pod" not in blob  # the new one is ciphertext


# -- the wal.append span -------------------------------------------------------


def test_wal_append_runs_in_a_span(tmp_path):
    """With tracing on, each durable append is a ``wal.append`` span inside
    its write's ``store.txn`` span."""
    tr = tracing.enable()
    try:
        s = Store(data_dir=str(tmp_path))
        s.create("Pod", _mk("a"))
        s.create_many("Pod", [_mk("b"), _mk("c")])
        s.close()
    finally:
        tracing.disable()
    txns = [sp for sp in tr.background if sp.name == "store.txn"]
    assert [len([c for c in sp.children if c.name == "wal.append"]) for sp in txns] == [1, 2]
    assert all(c.attrs["kind"] == "Pod" for sp in txns for c in sp.children)


# -- data directories across packages ------------------------------------------


def _write_history(pkg, d, encrypted, compacted):
    """Creates, a batch create, updates, binds, a delete and (``compacted``)
    a snapshot mid-way through ``pkg``'s Store over ``d``.  Returns the
    store's (objects, revision) as listed before close."""
    imp = importlib.import_module
    Store_ = imp(f"{pkg}.store").Store
    tu = imp(f"{pkg}.testutil")
    kw = {"transformer": _chain(pkg)} if encrypted else {}
    s = Store_(data_dir=d, compact_every=25 if compacted else 100_000, **kw)
    s.create("Node", tu.make_node("n1").to_dict())
    s.create_many("Pod", [tu.make_pod(f"p{i:02d}", cpu="100m").to_dict() for i in range(40)])
    s.bind_many([("default", f"p{i:02d}", "n1") for i in range(0, 40, 3)])
    p = s.get("Pod", "default", "p01")
    p["metadata"]["labels"] = {"app": "web"}
    s.update("Pod", p)
    s.delete("Pod", "default", "p02")
    s.create("Pod", tu.make_pod("late", cpu="1").to_dict())
    state = _state(s)
    s.close()
    return state


def _chain(pkg):
    enc = importlib.import_module(f"{pkg}.store.encryption")
    return enc.TransformerChain.from_keys([("k2", b"second"), ("k1", b"first")])


def _state(s):
    return ({kind: s.list(kind)[0] for kind in ("Pod", "Node")}, s.revision)


@pytest.mark.parametrize("compacted", [False, True], ids=["wal", "snapshot"])
@pytest.mark.parametrize("encrypted", [False, True], ids=["plain", "encrypted"])
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_a_data_directory_recovers_across_packages(tmp_path, writer, reader, encrypted,
                                                   compacted):
    d = str(tmp_path / "state")
    want = _write_history(writer, d, encrypted, compacted)
    imp = importlib.import_module
    kw = {"transformer": _chain(reader)} if encrypted else {}
    s = imp(f"{reader}.store").Store(data_dir=d, **kw)
    assert _state(s) == want
    rec = s._wal.last_recovery
    assert rec["revision"] == want[1] and not rec["torn_tail"]
    assert (rec["replayed"] < want[1]) == compacted
    # the reader writes on; the writer recovers both histories
    s.create("Pod", imp(f"{reader}.testutil").make_pod("after").to_dict())
    s.bind_many([("default", "after", "n1")])
    again = _state(s)
    s.close()
    kw = {"transformer": _chain(writer)} if encrypted else {}
    s2 = imp(f"{writer}.store").Store(data_dir=d, **kw)
    assert _state(s2) == again and again[1] == want[1] + 2
    s2.close()
    if encrypted:
        raw = (tmp_path / "state" / "wal.bin").read_bytes()
        assert b"after" not in raw and b"late" not in raw
