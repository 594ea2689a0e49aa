"""The health routes every daemon serves: ``/healthz`` (liveness, 200
``{"status": "ok"}``) and ``/metrics`` (Prometheus text from the daemon's
registry).  :func:`handle_debug_path` is the routing core, called by the
apiserver's handler and by ``daemon.serve_health``'s small server alike.
The reference package's ``/debug/*`` routes come with wave tracing."""

from __future__ import annotations

from typing import Optional


def handle_debug_path(path: str, registry=None) -> Optional[tuple]:
    """Route one GET path; ``None`` means "not one of ours".  A string body
    is raw text (the Prometheus exposition); a dict is JSON."""
    if path == "/healthz":
        return 200, {"status": "ok"}
    if path == "/metrics" and registry is not None:
        try:
            return 200, registry.expose()
        except Exception as e:  # noqa: BLE001 - a scrape must never crash health
            return 500, {"error": str(e)}
    return None
