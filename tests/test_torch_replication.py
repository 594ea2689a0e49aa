"""The port's store replication (``store/replication.py``): twins of
``tests/test_replication.py``.  Quorum writes, follower consistency,
catch-up by log replay and by snapshot, promotion with no acknowledged
write lost, durable promotion across a restart, and stateless apiservers
over one replicated store.  Tolerance: exact equality."""

import pytest

from kubernetes_tpu_torch.client import Clientset
from kubernetes_tpu_torch.client.remote import RemoteStore
from kubernetes_tpu_torch.store import (
    FollowerReplica,
    NoQuorumError,
    ReplicatedStore,
    Store,
)
from kubernetes_tpu_torch.testutil import make_pod


def _mk_cluster(n_followers=2):
    leader = ReplicatedStore()
    followers = [FollowerReplica(f"r{i}") for i in range(n_followers)]
    for f in followers:
        leader.add_follower(f)
    return leader, followers


def test_writes_replicate_to_followers():
    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    cs.pods.create(make_pod("p1"))
    cs.pods.create(make_pod("p2"))
    for f in (f1, f2):
        names = [d["metadata"]["name"]
                 for d in f.store.list("Pod")[0]]
        assert names == ["p1", "p2"]
        assert f.applied_revision == leader.revision


def test_follower_watch_sees_leader_commits():
    leader, (f1, _) = _mk_cluster()
    w = f1.store.watch("Pod")
    Clientset(leader).pods.create(make_pod("p1"))
    ev = w.get(timeout=2)
    assert ev is not None and ev.type == "ADDED" and ev.key == "default/p1"
    w.stop()


def test_quorum_lost_refuses_writes_without_mutation():
    leader, (f1, f2) = _mk_cluster()  # majority of 3 = 2
    cs = Clientset(leader)
    cs.pods.create(make_pod("p1"))
    f1.fail()
    cs.pods.create(make_pod("p2"))  # leader + f2 = 2, still quorate
    f2.fail()
    rev_before = leader.revision
    with pytest.raises(NoQuorumError):
        cs.pods.create(make_pod("p3"))
    assert leader.revision == rev_before  # refused write mutated nothing
    assert len(leader.list("Pod")[0]) == 2
    # recovery restores availability
    leader.catch_up(f1)
    cs.pods.create(make_pod("p3"))
    assert [d["metadata"]["name"] for d in f1.store.list("Pod")[0]] == [
        "p1", "p2", "p3"]


def test_rejoin_catch_up_via_log_replay():
    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    cs.pods.create(make_pod("p1"))
    f1.fail()
    cs.pods.create(make_pod("p2"))
    cs.pods.delete("p1")
    assert f1.applied_revision < leader.revision
    leader.catch_up(f1)
    assert f1.alive
    assert f1.applied_revision == leader.revision
    assert [d["metadata"]["name"] for d in f1.store.list("Pod")[0]] == ["p2"]


def test_rejoin_catch_up_via_snapshot_when_log_trimmed():
    leader = ReplicatedStore(event_log_window=8)  # tiny watch window
    f1, f2 = FollowerReplica("r0"), FollowerReplica("r1")
    leader.add_follower(f1)
    leader.add_follower(f2)  # quorum survives one loss
    cs = Clientset(leader)
    f1.fail()
    for i in range(50):  # far past the 8-event log window
        cs.pods.create(make_pod(f"p{i:02d}"))
    leader.catch_up(f1)
    assert f1.applied_revision == leader.revision
    assert len(f1.store.list("Pod")[0]) == 50


def test_promotion_keeps_every_acked_write():
    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    for i in range(10):
        cs.pods.create(make_pod(f"p{i}"))
    acked_rev = leader.revision
    # leader dies; the most-caught-up live follower takes over
    new_leader = ReplicatedStore.promote([f1, f2])
    assert new_leader.revision == acked_rev
    names = [d["metadata"]["name"] for d in new_leader.list("Pod")[0]]
    assert names == [f"p{i}" for i in range(10)]
    # the new leader has the OTHER replica as follower and keeps replicating
    assert new_leader.cluster_size() == 2
    cs2 = Clientset(new_leader)
    cs2.pods.create(make_pod("after-failover"))
    assert new_leader.revision > acked_rev
    other = new_leader.followers[0]
    assert other.applied_revision == new_leader.revision


def test_promotion_picks_most_caught_up_replica():
    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    cs.pods.create(make_pod("p1"))
    f1.fail()  # f1 misses the next writes
    cs.pods.create(make_pod("p2"))
    f1.recover()  # alive again but BEHIND f2
    new_leader = ReplicatedStore.promote([f1, f2])
    assert len(new_leader.list("Pod")[0]) == 2  # f2's state won
    # f1 was caught up during enlistment
    assert new_leader.followers[0].applied_revision == new_leader.revision


def test_stateless_apiservers_share_one_replicated_store():
    """Two HTTP apiserver frontends over one leader store: a write through
    either is visible (and watchable) through both — control-plane HA is
    N stateless apiservers x one quorate store."""
    from kubernetes_tpu_torch.apiserver.server import APIServer

    leader, _ = _mk_cluster()
    a = APIServer(leader)
    b = APIServer(leader)
    a.start()
    b.start()
    try:
        cs_a = Clientset(RemoteStore(a.url))
        cs_b = Clientset(RemoteStore(b.url))
        cs_a.pods.create(make_pod("via-a"))
        assert cs_b.pods.get("via-a").meta.name == "via-a"
        cs_b.pods.create(make_pod("via-b"))
        pods, _rev = cs_a.pods.list()
        assert sorted(p.meta.name for p in pods) == ["via-a", "via-b"]
    finally:
        a.stop()
        b.stop()


def test_snapshot_install_survives_restart(tmp_path):
    """A durable follower that was caught up via snapshot must recover the
    snapshot state from disk, not the stale pre-snapshot WAL."""
    leader = ReplicatedStore(event_log_window=8)
    f1 = FollowerReplica("r0", data_dir=str(tmp_path / "f1"))
    f2 = FollowerReplica("r1")
    leader.add_follower(f1)
    leader.add_follower(f2)
    cs = Clientset(leader)
    cs.pods.create(make_pod("before"))
    f1.fail()
    for i in range(30):  # far past the log window -> snapshot path
        cs.pods.create(make_pod(f"p{i:02d}"))
    leader.catch_up(f1)
    assert f1.applied_revision == leader.revision
    f1.store.close()
    revived = Store(data_dir=str(tmp_path / "f1"))
    assert revived.revision == leader.revision
    assert len(revived.list("Pod")[0]) == 31


def test_promoted_durable_leader_survives_restart(tmp_path):
    """promote(..., data_dir=...): the adopted state must be WAL-durable on
    the NEW leader — acked pre-failover writes survive its restart."""
    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    for i in range(5):
        cs.pods.create(make_pod(f"p{i}"))
    new_leader = ReplicatedStore.promote([f1, f2],
                                         data_dir=str(tmp_path / "nl"))
    Clientset(new_leader).pods.create(make_pod("post-failover"))
    final_rev = new_leader.revision
    new_leader.close()
    revived = Store(data_dir=str(tmp_path / "nl"))
    assert revived.revision == final_rev
    names = [d["metadata"]["name"] for d in revived.list("Pod")[0]]
    assert names == [f"p{i}" for i in range(5)] + ["post-failover"]


def test_concurrent_writers_with_follower_churn_and_promotion():
    """The linearizability-flavored chaos case: many writer threads, a
    follower failing and catching up mid-stream, then leader death and
    promotion — every write the store ACKED must exist on the promoted
    leader; refused (NoQuorum) writes must not."""
    import threading

    leader, (f1, f2) = _mk_cluster()
    cs = Clientset(leader)
    acked: list[str] = []
    refused: list[str] = []
    lock = threading.Lock()

    def writer(wid: int):
        for i in range(60):
            name = f"w{wid}-p{i:03d}"
            try:
                cs.pods.create(make_pod(name))
                with lock:
                    acked.append(name)
            except NoQuorumError:
                with lock:
                    refused.append(name)

    churn_stop = threading.Event()

    def churn():
        while not churn_stop.is_set():
            f1.fail()
            leader.catch_up(f1)  # rejoin via log replay or snapshot

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    churner = threading.Thread(target=churn)
    churner.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    churn_stop.set()
    churner.join()
    leader.catch_up(f1)

    assert len(acked) >= 200  # the cluster stayed mostly available
    # leader dies; most-caught-up live follower takes over
    new_leader = ReplicatedStore.promote([f1, f2])
    names = {d["metadata"]["name"] for d in new_leader.list("Pod")[0]}
    missing = [n for n in acked if n not in names]
    assert not missing, f"acked writes lost in promotion: {missing[:5]}"
    ghosts = [n for n in refused if n in names]
    assert not ghosts, f"refused writes materialized: {ghosts[:5]}"
