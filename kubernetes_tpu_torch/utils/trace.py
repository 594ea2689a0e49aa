"""Step-timestamped traces logged only when slow.

Capability of the reference's ``utiltrace.Trace``
(``apiserver/pkg/util/trace/trace.go``): the scheduler wraps every
per-pod schedule with a 100 ms threshold (``generic_scheduler.go:89-90``).

The steps live in a :class:`~.tracing.Span` and the slow rendering is
:func:`~.tracing.format_slow`, the tracer's own.  While tracing is enabled
the whole Trace also lands in the active tracer as a span, so
``schedule_one`` shows in the traces without a second instrumentation.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from . import tracing

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    # time.perf_counter by default, the tracer's clock: a Trace recorded
    # into an active tracer lands in the same time domain
    def __init__(self, name: str,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = name
        self._clock = clock
        self._span = tracing.Span(name, cat="trace", t0=clock())

    @property
    def steps(self) -> list:
        return self._span.steps

    def step(self, msg: str) -> None:
        self._span.step(self._clock(), msg)

    def log_if_long(self, threshold: float) -> None:
        now = self._clock()
        self._finish(now)
        if now - self._span.t0 < threshold:
            return
        logger.info(tracing.format_slow(self.name, self._span.t0, self._span.steps, now))

    def _finish(self, now: float) -> None:
        """Close the span and, with a tracer active, record it there with
        explicit timestamps from this Trace's clock."""
        if self._span.t1 is not None:
            return
        self._span.t1 = now
        tr = tracing.current()
        if tr is not None:
            recorded = tr.complete(self.name, self._span.t0, now, cat="trace")
            recorded.steps = list(self._span.steps)
