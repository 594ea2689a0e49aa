"""Audit pipeline (SURVEY.md §5.5 — ``apiserver/pkg/audit`` + policy in
``pkg/apis/audit``): one structured event per request stage, filtered by a
policy, delivered to pluggable backends; wired as a request filter in the
apiserver (``server/config.go:474``)."""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# audit levels (reference audit policy)
NONE = "None"
METADATA = "Metadata"
REQUEST = "Request"
REQUEST_RESPONSE = "RequestResponse"

_LEVELS = [NONE, METADATA, REQUEST, REQUEST_RESPONSE]


@dataclass
class AuditEvent:
    """Reference ``audit.Event`` at the depth the filter records."""

    stage: str  # RequestReceived | ResponseComplete
    user: str
    verb: str
    resource: str
    namespace: str
    name: str
    code: int = 0
    request_object: Optional[dict] = None
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        d = {
            "stage": self.stage,
            "user": self.user,
            "verb": self.verb,
            "resource": self.resource,
            "namespace": self.namespace,
            "name": self.name,
            "code": self.code,
            "timestamp": self.timestamp,
        }
        if self.request_object is not None:
            d["requestObject"] = self.request_object
        return d


@dataclass
class PolicyRule:
    """One audit policy rule: the first rule whose user/verb/resource
    selectors match decides the level (reference ``audit/policy``)."""

    level: str = METADATA
    users: list[str] = field(default_factory=list)  # empty = any
    verbs: list[str] = field(default_factory=list)
    resources: list[str] = field(default_factory=list)

    def matches(self, user: str, verb: str, resource: str) -> bool:
        if self.users and user not in self.users:
            return False
        if self.verbs and verb not in self.verbs:
            return False
        if self.resources and resource not in self.resources:
            return False
        return True


class AuditPolicy:
    def __init__(self, rules: Optional[list[PolicyRule]] = None,
                 default_level: str = METADATA):
        self.rules = rules or []
        self.default_level = default_level

    def level_for(self, user: str, verb: str, resource: str) -> str:
        for rule in self.rules:
            if rule.matches(user, verb, resource):
                return rule.level
        return self.default_level


class Backend:
    def process(self, event: AuditEvent) -> None:
        raise NotImplementedError


class MemoryBackend(Backend):
    def __init__(self):
        self.events: list[AuditEvent] = []
        self._mu = threading.Lock()

    def process(self, event: AuditEvent) -> None:
        with self._mu:
            self.events.append(event)


class LogBackend(Backend):
    """JSON-lines audit log file (reference log backend)."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()

    def process(self, event: AuditEvent) -> None:
        line = json.dumps(event.to_dict())
        with self._mu:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class WebhookBackend(Backend):
    """POST audit events to an external collector (reference webhook
    backend, ``apiserver/plugin/pkg/audit/webhook``): batched in a
    background thread so audit never sits on the request path; a dead
    collector drops batches after ``max_buffer`` (audit must not wedge
    the apiserver)."""

    def __init__(self, url: str, batch_size: int = 100,
                 flush_interval: float = 1.0, max_buffer: int = 10_000,
                 timeout: float = 5.0):
        import queue

        self.url = url
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.timeout = timeout
        self._q: "queue.Queue[AuditEvent]" = queue.Queue(maxsize=max_buffer)
        # `dropped` is bumped from request threads (process) AND the flush
        # thread (_post); += is a lost-update race without this (RL301)
        self._drop_mu = threading.Lock()
        self.dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def process(self, event: AuditEvent) -> None:
        try:
            self._q.put_nowait(event)
        except Exception:  # queue full: shed, never block the request
            with self._drop_mu:
                self.dropped += 1

    def _loop(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            batch: list[AuditEvent] = []
            try:
                batch.append(self._q.get(timeout=self.flush_interval))
            except _queue.Empty:
                continue
            while len(batch) < self.batch_size:
                try:
                    batch.append(self._q.get_nowait())
                except _queue.Empty:
                    break
            try:
                self._post(batch)
            finally:
                # task_done AFTER the POST: stop()'s drain tracks
                # unfinished_tasks, so an in-flight batch counts until it
                # is actually delivered (or given up on)
                for _ in batch:
                    self._q.task_done()

    def _post(self, batch: list[AuditEvent]) -> None:
        import urllib.request

        body = json.dumps({"kind": "EventList",
                           "items": [e.to_dict() for e in batch]}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            urllib.request.urlopen(req, timeout=self.timeout).read()
        except Exception:  # noqa: BLE001 - a dead collector loses batches
            with self._drop_mu:
                self.dropped += len(batch)

    def stop(self, drain_timeout: float = 2.0) -> None:
        import time as _t

        deadline = _t.monotonic() + drain_timeout
        # unfinished_tasks covers the batch IN FLIGHT, not just the queue:
        # a drain must not declare victory while the final POST is running
        while self._q.unfinished_tasks and _t.monotonic() < deadline:
            _t.sleep(0.05)
        self._stop.set()
        self._thread.join(timeout=2)


class Auditor:
    """Policy + backends; the apiserver calls :meth:`record` per request."""

    def __init__(self, policy: Optional[AuditPolicy] = None,
                 backends: Optional[list[Backend]] = None):
        self.policy = policy or AuditPolicy()
        self.backends = backends if backends is not None else [MemoryBackend()]

    @property
    def memory(self) -> Optional[MemoryBackend]:
        for b in self.backends:
            if isinstance(b, MemoryBackend):
                return b
        return None

    def record(self, stage: str, user: str, verb: str, resource: str,
               namespace: str, name: str, code: int = 0,
               request_object: Optional[dict] = None) -> None:
        level = self.policy.level_for(user, verb, resource)
        if level == NONE:
            return
        ev = AuditEvent(
            stage=stage, user=user, verb=verb, resource=resource,
            namespace=namespace, name=name, code=code,
            request_object=request_object if level in (REQUEST, REQUEST_RESPONSE) else None,
        )
        for b in self.backends:
            b.process(ev)
