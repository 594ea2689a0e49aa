"""Deterministic fault injection: named fault points and seeded plans.

- a process-wide **registry** of :class:`FaultPoint` names: the places
  where the code has agreed a failure can be injected (the catalogue is
  ``faults/__init__.py``);
- instrumented sites call :func:`hit` with the point's name.  Disarmed (the
  default, and the only production state) that is one module-global load
  and a ``None`` check;
- a :class:`FaultPlan` (a seeded RNG and per-point :class:`FaultSpec`
  policies) armed by ``with plan.armed():`` makes selected hits misbehave:
  raise, sleep, tear a write or drop an item, deterministically, so a
  failing chaos run replays exactly.

A fired fault also dumps the flight recorder (``utils/tracing.py``), so
each injected failure carries the trace of the wave it fired in.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import tracing


class FaultInjected(Exception):
    """Default error raised by an ``error``-mode fault point."""


class FaultConfigError(Exception):
    """A plan referenced an unregistered point, or a spec is malformed."""


class FaultPoint:
    """One named injection seam.  Instances live in the process-wide
    registry; ``hits``/``fired`` count across every armed plan (the
    coverage gate in tests/test_faults.py reads these)."""

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self.hits = 0  # times an ARMED plan saw this site execute
        self.fired = 0  # times a policy actually misbehaved here

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPoint({self.name!r}, hits={self.hits}, fired={self.fired})"


_REGISTRY: dict[str, FaultPoint] = {}
_ARM_MU = threading.Lock()
_ACTIVE: Optional["FaultPlan"] = None


def register(name: str, description: str = "") -> FaultPoint:
    """Idempotent registration; the canonical catalogue lives in
    ``faults/__init__.py`` so importing the package yields the complete
    registry (the coverage gate depends on that)."""
    point = _REGISTRY.get(name)
    if point is None:
        point = _REGISTRY[name] = FaultPoint(name, description)
    return point


def registry() -> dict[str, FaultPoint]:
    """The live registry (read-only by convention)."""
    return _REGISTRY


def active_plan() -> Optional["FaultPlan"]:
    return _ACTIVE


@dataclass
class Fault:
    """What :func:`hit` returns when a non-raising policy fires.  The
    site interprets ``mode``: ``torn`` → write a partial record, ``drop``
    → discard the item, ``delay`` → already slept."""

    mode: str
    value: float = 0.0
    spec: Optional["FaultSpec"] = None


@dataclass
class FaultSpec:
    """Policy for one fault point inside one plan.

    mode:
      - ``error``: :func:`hit` raises (``error_factory()`` if given, else
        :class:`FaultInjected`) — models the operation failing outright;
      - ``delay``: :func:`hit` sleeps ``value`` seconds, site proceeds;
      - ``torn``: returned to the site, which writes ``value`` fraction
        of the payload then simulates the crash (WAL append);
      - ``drop``: returned to the site, which discards the item (watch
        event, informer delivery, one binding of a batch).

    Triggers (combined with AND; default = every matching hit fires):
      - ``match``: ctx filter — every key must be present and equal in
        the site's ``hit(name, **ctx)`` keywords;
      - ``nth``: fire only on the nth *matching* hit (1-based);
      - ``first_n``: fire on the first n matching hits;
      - ``probability``: fire with probability p from the plan's seeded
        RNG (deterministic per seed);
      - ``max_fires``: stop firing after this many fires.
    """

    mode: str = "error"
    error_factory: Optional[Callable[[], BaseException]] = None
    value: float = 0.5
    match: Optional[dict] = None
    nth: Optional[int] = None
    first_n: Optional[int] = None
    probability: Optional[float] = None
    max_fires: Optional[int] = None
    # runtime counters (per plan arming)
    seen: int = field(default=0, compare=False)
    fires: int = field(default=0, compare=False)

    _MODES = ("error", "delay", "torn", "drop")

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise FaultConfigError(f"unknown fault mode {self.mode!r}")

    def _matches(self, ctx: dict) -> bool:
        if not self.match:
            return True
        return all(k in ctx and ctx[k] == v for k, v in self.match.items())

    def _should_fire(self, rng: random.Random) -> bool:
        # `seen` was already incremented for this matching hit
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth is not None and self.seen != self.nth:
            return False
        if self.first_n is not None and self.seen > self.first_n:
            return False
        if self.probability is not None and rng.random() >= self.probability:
            return False
        return True


class FaultPlan:
    """Seeded set of per-point policies, armed process-wide for a scope.

    One plan may be armed at a time (nesting two plans would make the
    "which policy fired" question ambiguous); arming is test-scoped by
    construction — ``with plan.armed(): ...``."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._specs: dict[str, list[FaultSpec]] = {}
        self.hits: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        # Counter lock: watch/informer threads and the main thread hit
        # armed points concurrently; per-point fire counts must be exact
        # (the nth/first_n/max_fires triggers read them).  The policy
        # decision (seen/fires/rng) happens under the lock; the ACTION
        # (raise / sleep / return) happens outside it so a delay-mode
        # fault never stalls other threads' fault points.
        self._mu = threading.Lock()

    def on(self, point: str, spec: Optional[FaultSpec] = None, **kwargs) -> "FaultPlan":
        """Attach a policy to a registered point.  Chainable."""
        if point not in _REGISTRY:
            raise FaultConfigError(
                f"unknown fault point {point!r} — register it in the "
                f"faults/__init__.py catalogue first (known: {sorted(_REGISTRY)})"
            )
        if spec is None:
            spec = FaultSpec(**kwargs)
        elif kwargs:
            raise FaultConfigError("pass a FaultSpec or kwargs, not both")
        self._specs.setdefault(point, []).append(spec)
        return self

    # -- arming ------------------------------------------------------------
    def armed(self):
        return _Armed(self)

    # -- the hot path (only reached while armed) ---------------------------
    def _fire(self, name: str, ctx: dict) -> Optional[Fault]:
        point = _REGISTRY.get(name)
        if point is None:
            raise FaultConfigError(
                f"hit() on unregistered fault point {name!r} — add it to "
                "the faults/__init__.py catalogue"
            )
        fired_spec: Optional[FaultSpec] = None
        with self._mu:
            point.hits += 1
            self.hits[name] = self.hits.get(name, 0) + 1
            for spec in self._specs.get(name, ()):
                if not spec._matches(ctx):
                    continue
                spec.seen += 1
                if not spec._should_fire(self.rng):
                    continue
                spec.fires += 1
                point.fired += 1
                self.fired[name] = self.fired.get(name, 0) + 1
                fired_spec = spec
                break
        if fired_spec is None:
            return None
        # flight-recorder trigger: every fired fault dumps the
        # trace of the wave it fired into, BEFORE the site misbehaves —
        # a raise below must not lose the recording.  Disarmed runs never
        # reach here, so the production path is untouched.
        tracing.notify_fault(name, ctx, fired_spec.mode)
        if fired_spec.mode == "error":
            raise (fired_spec.error_factory() if fired_spec.error_factory is not None
                   else FaultInjected(f"injected fault at {name}"))
        if fired_spec.mode == "delay":
            time.sleep(fired_spec.value)
            return None  # the site proceeds, just later
        return Fault(fired_spec.mode, fired_spec.value, fired_spec)


class _Armed:
    def __init__(self, plan: FaultPlan):
        self._plan = plan

    def __enter__(self) -> FaultPlan:
        global _ACTIVE
        with _ARM_MU:
            if _ACTIVE is not None:
                raise FaultConfigError("another FaultPlan is already armed")
            _ACTIVE = self._plan
        return self._plan

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _ARM_MU:
            _ACTIVE = None


def hit(name: str, **ctx) -> Optional[Fault]:
    """The instrumented-site entry point.  Disarmed: one global load and
    a None check — safe on every hot path.  Armed: consult the plan
    (may raise, sleep, or return a :class:`Fault` for the site to
    interpret)."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan._fire(name, ctx)
