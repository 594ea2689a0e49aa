"""SLO enforcement: metric thresholds that FAIL tests on violation.

Capability of the reference's perf gatekeeping
(``test/e2e/framework/metrics_util.go:44-57`` — scrape component
metrics, compare against thresholds, fail the suite; and
``scheduler_perf/scheduler_test.go:35-38`` — per-interval
pods/s floors: fail < 30, warn < 100)."""

from __future__ import annotations

import logging

logger = logging.getLogger("kubernetes_tpu_torch.testing.slo")

# the reference's scheduler_perf thresholds (scheduler_test.go:35-38)
MIN_THROUGHPUT_PODS_PER_SEC = 30.0
WARN_THROUGHPUT_PODS_PER_SEC = 100.0


class SLOViolation(AssertionError):
    pass


class SLOChecker:
    """Collects checks; ``assert_all`` raises SLOViolation listing every
    breach (the reference fails at suite teardown with the full list)."""

    def __init__(self):
        self.violations: list[str] = []
        self.warnings: list[str] = []

    # -- throughput (scheduler_perf) ---------------------------------------
    def check_throughput(self, pods_per_sec: float, minimum: float = MIN_THROUGHPUT_PODS_PER_SEC,
                         warn: float = WARN_THROUGHPUT_PODS_PER_SEC) -> None:
        if pods_per_sec < minimum:
            self.violations.append(
                f"throughput {pods_per_sec:.1f} pods/s below the {minimum:.0f} floor"
            )
        elif pods_per_sec < warn:
            self.warnings.append(
                f"throughput {pods_per_sec:.1f} pods/s below the {warn:.0f} warn line"
            )

    # -- latency quantiles (metrics_util) ----------------------------------
    def check_latency_quantile(self, name: str, histogram, q: float,
                               max_value: float) -> None:
        got = histogram.quantile(q)
        if got > max_value:
            self.violations.append(
                f"{name} p{int(q * 100)} = {got:.0f} exceeds {max_value:.0f}"
            )

    def check_counter_max(self, name: str, counter, max_value: int) -> None:
        if counter.value > max_value:
            self.violations.append(f"{name} = {counter.value} exceeds {max_value}")

    # -- verdict -----------------------------------------------------------
    def assert_all(self) -> None:
        for w in self.warnings:
            logger.warning("SLO warn: %s", w)
        if self.violations:
            raise SLOViolation("; ".join(self.violations))
