"""Interned selector/labelmap matcher used by the tensorizer's
``initial_state`` to count existing pods per spread selector and per
affinity term.  Labelmaps and selectors are registered once and referred to
by integer id; matching is a pure-Python loop over distinct ids (callers
deduplicate labelmaps first)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..api.selectors import Requirement


class MatchEngine:
    def __init__(self):
        self._labelmaps: list[dict] = []
        self._selectors: list[list] = []

    def close(self) -> None:
        """Kept for the engine interface; nothing native to free."""

    def add_labelmap(self, labels: dict) -> int:
        self._labelmaps.append(dict(labels))
        return len(self._labelmaps) - 1

    def add_selector(self, requirements: list[tuple[str, str, list[str]]]) -> int:
        """requirements: [(key, op_name, values)]; op "Eq" = key=value."""
        self._selectors.append(list(requirements))
        return len(self._selectors) - 1

    def match_matrix(self, selector_ids: Sequence[int], labelmap_ids: Sequence[int]) -> np.ndarray:
        out = np.zeros((len(selector_ids), len(labelmap_ids)), dtype=bool)
        for i, sid in enumerate(selector_ids):
            for j, lid in enumerate(labelmap_ids):
                out[i, j] = self._match(sid, lid)
        return out

    def match_any(self, selector_ids: Sequence[int], labelmap_ids: Sequence[int]) -> np.ndarray:
        out = np.zeros(len(labelmap_ids), dtype=bool)
        for j, lid in enumerate(labelmap_ids):
            out[j] = any(self._match(sid, lid) for sid in selector_ids)
        return out

    def _match(self, sid: int, lid: int) -> bool:
        labels = self._labelmaps[lid]
        for key, op_name, values in self._selectors[sid]:
            if op_name == "Eq":
                if labels.get(key) != values[0]:
                    return False
            elif not Requirement(key, op_name, list(values)).matches(labels):
                return False
        return True
