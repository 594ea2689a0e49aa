"""Revisioned in-process store + watch streams."""

from .store import (
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    Store,
    Watch,
    WatchEvent,
)
