"""Host utilities: metrics, slow-operation traces, feature gates and the
health routes."""

from .metrics import Counter, Gauge, Histogram, Registry, SchedulerMetrics
from .trace import Trace
