"""Minimal 5-field cron schedule evaluation for the CronJob controller
(the reference vendors robfig/cron; ``pkg/controller/cronjob/utils.go``
getRecentUnmetScheduleTimes drives it the same way: step minute-by-minute
from the last schedule time)."""

from __future__ import annotations

import time
from dataclasses import dataclass


def _parse_field(field: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            rng = range(int(part), int(part) + 1)
        out.update(v for v in rng if (v - rng.start) % step == 0)
    bad = [v for v in out if v < lo or v > hi]
    if bad:
        raise ValueError(f"cron field value {bad} out of range [{lo},{hi}]")
    return frozenset(out)


@dataclass(frozen=True)
class CronSchedule:
    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    weekdays: frozenset[int]  # 0=Sunday (cron convention)
    # standard cron: when BOTH day-of-month and day-of-week are restricted
    # (neither is "*"), a time matches if EITHER field matches
    dom_star: bool = True
    dow_star: bool = True

    @classmethod
    def parse(cls, expr: str) -> "CronSchedule":
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression needs 5 fields, got {expr!r}")
        m, h, dom, mon, dow = fields
        return cls(
            minutes=_parse_field(m, 0, 59),
            hours=_parse_field(h, 0, 23),
            days=_parse_field(dom, 1, 31),
            months=_parse_field(mon, 1, 12),
            weekdays=frozenset(v % 7 for v in _parse_field(dow, 0, 7)),
            dom_star=dom.split("/")[0] in ("*", ""),
            dow_star=dow.split("/")[0] in ("*", ""),
        )

    def matches(self, ts: float) -> bool:
        t = time.gmtime(ts)
        # cron weekday: 0=Sunday; struct_time: 0=Monday
        wd = (t.tm_wday + 1) % 7
        dom_ok = t.tm_mday in self.days
        dow_ok = wd in self.weekdays
        if not self.dom_star and not self.dow_star:
            day_ok = dom_ok or dow_ok  # standard cron OR rule
        else:
            day_ok = dom_ok and dow_ok
        return (
            t.tm_min in self.minutes
            and t.tm_hour in self.hours
            and day_ok
            and t.tm_mon in self.months
        )

    def next_after(self, ts: float, horizon_minutes: int = 366 * 24 * 60) -> float | None:
        """First matching minute strictly after ``ts`` (UTC)."""
        base = int(ts // 60 + 1) * 60
        for i in range(horizon_minutes):
            candidate = base + i * 60
            if self.matches(candidate):
                return float(candidate)
        return None

    def unmet_since(self, last: float, now: float, limit: int = 100) -> list[float]:
        """Schedule times in (last, now] — the controller's missed-run scan
        (``cronjob/utils.go getRecentUnmetScheduleTimes``)."""
        out: list[float] = []
        t = self.next_after(last)
        while t is not None and t <= now and len(out) < limit:
            out.append(t)
            t = self.next_after(t)
        return out
