"""Revisioned in-process store + watch streams, its write-ahead log and
its replication."""

from .store import (
    ADDED,
    DELETED,
    MODIFIED,
    WATCH_GAP,
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    Store,
    Watch,
    WatchEvent,
)
from .replication import (
    FollowerReplica,
    NoQuorumError,
    ReplicaDownError,
    ReplicatedStore,
)
