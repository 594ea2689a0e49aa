"""Revisioned in-process store + watch streams."""

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
