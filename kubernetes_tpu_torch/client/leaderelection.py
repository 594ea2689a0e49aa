"""Leader election: active/passive HA through a lease held in the store.

``client-go/tools/leaderelection`` (``leaderelection.go:152 RunOrDie``,
``:172 acquire``): candidates race to CAS a lease object; the holder
renews within the lease duration, and a standby takes over once the
renewal goes stale.  The scheduler daemon runs one active instance this
way.

The lease is an annotated Event-kind object in ``kube-system`` (the
reference uses an annotated Endpoints or ConfigMap the same way) holding
the holder's identity and its renew time on the injected clock.  Every
write is a CAS, so two holders cannot both win."""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from ..api import types as api
from ..api.meta import ObjectMeta
from ..store.store import AlreadyExistsError, ConflictError, NotFoundError
from .clientset import Clientset

LEASE_ANNOTATION = "control-plane.alpha.kubernetes.io/leader"


class _LostRace(Exception):
    pass


class LeaderElector:
    def __init__(
        self,
        clientset: Clientset,
        lock_name: str,
        identity: str,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        # wall clock, not monotonic: renewTime is compared by other
        # processes and hosts, and monotonic clocks are boot-relative
        clock: Callable[[], float] = time.time,
    ):
        self.clientset = clientset
        self.lock_name = lock_name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self._clock = clock
        self._is_leader = False

    # -- the lease record --------------------------------------------------
    def _read(self) -> Optional[dict]:
        try:
            obj = self.clientset.events.get(self.lock_name, "kube-system")
        except NotFoundError:
            return None
        raw = obj.meta.annotations.get(LEASE_ANNOTATION)
        return json.loads(raw) if raw else None

    def _record(self) -> dict:
        return {
            "holderIdentity": self.identity,
            "renewTime": self._clock(),
            "leaseDurationSeconds": self.lease_duration,
        }

    def _expired(self, rec: dict, now: float) -> bool:
        return now > rec.get("renewTime", 0) + rec.get("leaseDurationSeconds",
                                                       self.lease_duration)

    # -- acquire / renew (leaderelection.go:172 acquire, :202 renew) -------
    def try_acquire_or_renew(self) -> bool:
        """One election round; True while this identity holds the lease."""
        now = self._clock()
        cur = self._read()
        if cur is None:
            try:
                self.clientset.events.create(api.Event(
                    meta=ObjectMeta(
                        name=self.lock_name, namespace="kube-system",
                        annotations={LEASE_ANNOTATION: json.dumps(self._record())}),
                    reason="LeaderElection"))
                self._is_leader = True
                return True
            except AlreadyExistsError:
                cur = self._read()

        holder = cur.get("holderIdentity") if cur else None
        if holder != self.identity and cur is not None and not self._expired(cur, now):
            self._is_leader = False
            return False

        # ours to renew, or stale and up for grabs: CAS it
        def _mutate(obj: api.Event) -> api.Event:
            inner = json.loads(obj.meta.annotations.get(LEASE_ANNOTATION) or "{}")
            if inner.get("holderIdentity") != self.identity and not self._expired(inner, now):
                raise _LostRace()
            obj.meta.annotations[LEASE_ANNOTATION] = json.dumps(self._record())
            return obj

        try:
            self.clientset.events.guaranteed_update(self.lock_name, _mutate, "kube-system")
            self._is_leader = True
            return True
        except (_LostRace, NotFoundError, ConflictError):
            self._is_leader = False
            return False

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def release(self) -> None:
        """Drop the lease voluntarily (clean shutdown)."""
        if not self._is_leader:
            return

        def _mutate(obj: api.Event) -> api.Event:
            inner = json.loads(obj.meta.annotations.get(LEASE_ANNOTATION) or "{}")
            if inner.get("holderIdentity") == self.identity:
                inner["renewTime"] = -1e18  # stale at any clock
                obj.meta.annotations[LEASE_ANNOTATION] = json.dumps(inner)
            return obj

        try:
            self.clientset.events.guaranteed_update(self.lock_name, _mutate, "kube-system")
        except NotFoundError:
            pass  # nothing left to release
        self._is_leader = False
