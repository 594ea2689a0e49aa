"""Step-timestamped traces logged only when slow.

Capability of the reference's ``utiltrace.Trace``
(``apiserver/pkg/util/trace/trace.go``): the scheduler wraps every
per-pod schedule with a 100 ms threshold (``generic_scheduler.go:89-90``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    def __init__(self, name: str,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = name
        self._clock = clock
        self._start = clock()
        self.steps: list[tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((self._clock(), msg))

    def log_if_long(self, threshold: float) -> None:
        now = self._clock()
        if now - self._start < threshold:
            return
        lines = [f'Trace "{self.name}" (total {(now - self._start) * 1e3:.1f}ms):']
        prev = self._start
        for t, msg in self.steps:
            lines.append(f"  +{(t - prev) * 1e3:.1f}ms {msg}")
            prev = t
        logger.info("\n".join(lines))
