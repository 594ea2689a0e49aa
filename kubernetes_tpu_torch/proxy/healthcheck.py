"""Proxy health checking (reference ``pkg/proxy/healthcheck/``): two
distinct surfaces —

- :class:`ProxierHealthServer` — the NODE's proxier healthz
  (``healthcheck.go healthzServer``): 200 while rule syncs are recent,
  503 once the proxier stalls past the grace period.  Load balancers use
  this to stop sending new flows to a node whose dataplane is stale.
- :class:`ServiceHealthServer` — per-service endpoint counts for
  externalTrafficPolicy=Local services (``healthcheck.go server``): an LB
  health-probes a node's per-service port and only targets nodes with
  LOCAL ready endpoints.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _HealthHTTPServer:
    """Shared server lifecycle; subclasses implement
    ``handle(path) -> (code, body_dict) | None`` (None = 404)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                result = outer.handle(self.path)
                if result is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                code, payload = result
                if isinstance(payload, str):
                    # raw text responses (Prometheus exposition format)
                    body = payload.encode()
                    ctype = "text/plain"
                else:
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def handle(self, path: str):  # pragma: no cover - abstract
        raise NotImplementedError

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()  # release the bound socket either way


class ProxierHealthServer(_HealthHTTPServer):
    def __init__(self, grace_seconds: float = 60.0, clock=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.grace = grace_seconds
        self.clock = clock or time.monotonic
        self._last_sync = self.clock()
        self._lock = threading.Lock()
        super().__init__(host, port)

    def touch(self) -> None:
        """Called by the proxier after every successful rule sync."""
        with self._lock:
            self._last_sync = self.clock()

    def status(self) -> tuple[bool, float]:
        with self._lock:
            age = self.clock() - self._last_sync
        return age <= self.grace, age

    def handle(self, path: str):
        if path != "/healthz":
            return None
        healthy, age = self.status()
        return (200 if healthy else 503,
                {"lastUpdated": round(age, 3), "healthy": healthy})


class ServiceHealthServer(_HealthHTTPServer):
    """Per-service local-endpoint counts, one shared HTTP server (the
    reference binds one port per service; a path per service keys the
    same contract without exhausting test ports)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        super().__init__(host, port)

    def sync_services(self, counts: dict[str, int]) -> None:
        """Full-state update of tracked services (``SyncServices`` +
        ``SyncEndpoints``): services absent from ``counts`` stop being
        served (404)."""
        with self._lock:
            self._counts = dict(counts)

    def handle(self, path: str):
        key = path.strip("/")
        with self._lock:
            count = self._counts.get(key)
        if count is None:
            return None
        # 0 local endpoints -> 503: the LB must not target this node for a
        # Local-policy service it has no backends on
        return (200 if count > 0 else 503,
                {"service": key, "localEndpoints": count})
