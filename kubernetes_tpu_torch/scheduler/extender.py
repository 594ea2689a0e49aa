"""Scheduler extender: out-of-process scheduling hooks over HTTP.

Capability of the reference's ``SchedulerExtender``
(``core/extender.go:40 HTTPExtender``, ``Filter :100``, ``Prioritize :157``,
``Bind :199``) — the reference's only sanctioned out-of-process scheduling
seam (SURVEY.md terminology table).  JSON-over-HTTP webhooks:

- Filter: POST {pod, nodeNames} -> {nodeNames, failedNodes{name: reason}}
- Prioritize: POST {pod, nodeNames} -> [{host, score}]  (weighted in)
- Bind (optional): POST {podNamespace, podName, node} -> {error}

An extender that declares ``bind`` says so through ``is_binder``; the
scheduler does not hand it the binding commit (neither does the JAX
package's).
"""

from __future__ import annotations

import json
import urllib.request
from ..api import types as api


class ExtenderError(Exception):
    pass


class HTTPExtender:
    def __init__(
        self,
        url_prefix: str,
        filter_verb: str = "",
        prioritize_verb: str = "",
        bind_verb: str = "",
        weight: int = 1,
        timeout: float = 5.0,
    ):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.weight = weight
        self.timeout = timeout

    @classmethod
    def from_config(cls, spec: dict) -> "HTTPExtender":
        return cls(
            url_prefix=spec["urlPrefix"],
            filter_verb=spec.get("filterVerb", ""),
            prioritize_verb=spec.get("prioritizeVerb", ""),
            bind_verb=spec.get("bindVerb", ""),
            weight=int(spec.get("weight", 1)),
            timeout=float(spec.get("httpTimeout", 5.0)),
        )

    def _post(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001
            raise ExtenderError(f"extender {self.url_prefix}/{verb}: {e}") from e

    # -- the three hooks (GenericScheduler calls these) --------------------
    def filter(self, pod: api.Pod, node_names: list[str]) -> tuple[list[str], dict[str, list[str]]]:
        if not self.filter_verb:
            return node_names, {}
        out = self._post(self.filter_verb, {"pod": pod.to_dict(), "nodeNames": node_names})
        failed = {name: [reason] for name, reason in (out.get("failedNodes") or {}).items()}
        return list(out.get("nodeNames") or []), failed

    def prioritize(self, pod: api.Pod, node_names: list[str]) -> list[int]:
        if not self.prioritize_verb:
            return [0] * len(node_names)
        out = self._post(self.prioritize_verb, {"pod": pod.to_dict(), "nodeNames": node_names})
        by_host = {e["host"]: int(e["score"]) for e in out}
        return [self.weight * by_host.get(n, 0) for n in node_names]

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    def bind(self, binding: api.Binding) -> None:
        out = self._post(self.bind_verb, binding.to_dict())
        if out.get("error"):
            raise ExtenderError(out["error"])
