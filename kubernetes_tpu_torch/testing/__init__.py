"""Test infrastructure: chaos injection and SLO enforcement."""

from .chaos import (
    ChaosMonkey,
    FaultInjection,
    NodePartition,
    PodKiller,
    SchedulerRestart,
)
from .slo import SLOChecker, SLOViolation
