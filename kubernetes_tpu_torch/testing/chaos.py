"""Chaos injection for control-plane tests.

Capability of the reference's e2e chaos tooling:

- ``chaosmonkey.Do`` (``test/e2e/chaosmonkey/chaosmonkey.go:47,77``):
  register tests, start them, inject a disruption mid-flight, let the
  tests finish, assert.  ``ChaosMonkey.run`` is that protocol collapsed
  into a deterministic tick loop.
- ``network_partition.go``: a zone going silent — here, a subset of
  hollow kubelets simply stops ticking (no heartbeats, no pod status),
  which is exactly what a partition looks like to the control plane.
- component crash/restart (upgrade tests): throw a component away and
  rebuild it from the store — the checkpoint/resume property (the store
  is the checkpoint).

The coarse disruptions above act from the OUTSIDE (remove a kubelet,
drop a scheduler).  :class:`FaultInjection` plugs the deterministic
fault framework (``kubernetes_tpu_torch/faults``) into the same protocol: a
seeded :class:`~kubernetes_tpu_torch.faults.FaultPlan` armed at ``inject_at``
and disarmed at ``recover_at`` makes a named internal seam misbehave —
bind failures, watch-stream cuts — with exact replay.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from ..faults import FaultPlan


class Disruption:
    """begin() at the injection point, end() at recovery."""

    def begin(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def end(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class NodePartition(Disruption):
    """A set of hollow kubelets goes silent (the network-partition
    analogue: heartbeats stop, pod statuses freeze)."""

    def __init__(self, fleet, node_names: set[str]):
        self.fleet = fleet
        self.node_names = set(node_names)
        self._removed = []

    def begin(self) -> None:
        self._removed = [k for k in self.fleet.kubelets if k.node_name in self.node_names]
        self.fleet.kubelets = [
            k for k in self.fleet.kubelets if k.node_name not in self.node_names
        ]

    def end(self) -> None:
        self.fleet.kubelets.extend(self._removed)
        for k in self._removed:
            k._last_heartbeat = -1e18  # heartbeat immediately on next tick
        self._removed = []


class SchedulerRestart(Disruption):
    """Kill the scheduler and rebuild it from the store (LIST+WATCH
    replay): nothing but the store may be needed to resume."""

    def __init__(self, holder: dict, factory: Callable[[], object]):
        self.holder = holder  # {"scheduler": Scheduler} — swapped in place
        self.factory = factory

    def begin(self) -> None:
        self.holder["scheduler"] = None  # the old instance is simply dropped

    def end(self) -> None:
        sched = self.factory()
        sched.start()
        sched.pump()
        self.holder["scheduler"] = sched


class PodKiller(Disruption):
    """Deletes random running pods while active (the reference's
    disruptive e2e pod churn)."""

    def __init__(self, clientset, rate: int = 1, seed: int = 0):
        self.clientset = clientset
        self.rate = rate
        self.rng = random.Random(seed)
        self.active = False
        self.killed = 0

    def begin(self) -> None:
        self.active = True

    def tick(self) -> None:
        if not self.active:
            return
        from ..store.store import NotFoundError

        pods, _ = self.clientset.pods.list()
        victims = [p for p in pods if p.status.phase == "Running"]
        self.rng.shuffle(victims)
        for p in victims[: self.rate]:
            try:
                self.clientset.pods.delete(p.meta.name, p.meta.namespace)
                self.killed += 1
            except NotFoundError:
                pass

    def end(self) -> None:
        self.active = False


class FaultInjection(Disruption):
    """A fault plan as a chaos disruption: the plan's policies are live
    between begin() and end().  Composes with the external disruptions —
    e.g. a node partition WHILE binds are failing — and inherits the
    plan's determinism (same seed, same misbehavior sequence)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._armed = None

    def begin(self) -> None:
        self._armed = self.plan.armed()
        self._armed.__enter__()

    def end(self) -> None:
        if self._armed is not None:
            self._armed.__exit__(None, None, None)
            self._armed = None


class ChaosMonkey:
    """chaosmonkey.Do: drive the workload, inject at ``inject_at``,
    recover at ``recover_at``, stop when ``done`` or ``max_ticks``."""

    def __init__(
        self,
        tick: Callable[[int], None],
        disruptions: list[Disruption],
        inject_at: int,
        recover_at: int,
        done: Optional[Callable[[], bool]] = None,
        max_ticks: int = 200,
    ):
        self.tick = tick
        self.disruptions = disruptions
        self.inject_at = inject_at
        self.recover_at = recover_at
        self.done = done or (lambda: False)
        self.max_ticks = max_ticks
        self.injected = False
        self.recovered = False

    def run(self) -> int:
        """Returns the tick count at completion.  Disruptions that began
        are ALWAYS ended — a tick() that raises mid-fault (likely, since
        faults make workloads throw) must not leak the disruption past
        the run: a still-armed FaultPlan would poison every later test
        in the process (and block the next ``armed()``)."""
        try:
            for t in range(self.max_ticks):
                if t == self.inject_at:
                    for d in self.disruptions:
                        d.begin()
                    self.injected = True
                if t == self.recover_at:
                    for d in self.disruptions:
                        d.end()
                    self.recovered = True
                self.tick(t)
                for d in self.disruptions:
                    tick_fn = getattr(d, "tick", None)
                    if tick_fn is not None:
                        tick_fn()
                if t > self.recover_at and self.done():
                    return t
            return self.max_ticks
        finally:
            if self.injected and not self.recovered:
                for d in self.disruptions:
                    d.end()
                self.recovered = True
