"""The health and debug routes every daemon serves:

- ``/healthz``              — liveness (200 ``{"status": "ok"}``)
- ``/metrics``              — Prometheus text from the daemon's registry
- ``/debug/traces``         — Chrome trace-event JSON (Perfetto)
- ``/debug/flightrecorder`` — every flight-recorder dump and the current ring
- ``/debug/timeseries``     — the time-series rings as JSON

:func:`handle_debug_path` is the routing core, called by the apiserver's
handler and by ``daemon.serve_health``'s small server alike.  Probing a
route never perturbs the serving path: with tracing or the time series off
it answers ``{"enabled": false}``, and an export that raises answers 500.
"""

from __future__ import annotations

from typing import Optional


def handle_debug_path(path: str, registry=None) -> Optional[tuple]:
    """Route one GET path; ``None`` means "not one of ours".  A string body
    is raw text (the Prometheus exposition); a dict is JSON."""
    if path == "/healthz":
        return 200, {"status": "ok"}
    if path == "/metrics":
        if registry is None:
            return None
        try:
            return 200, registry.expose()
        except Exception as e:  # noqa: BLE001 - a scrape must never crash health
            return 500, {"error": str(e)}
    if path in ("/debug/traces", "/debug/flightrecorder"):
        from . import tracing

        tr = tracing.current()
        if tr is None:
            return 200, {"enabled": False}
        try:
            return 200, tr.chrome_trace() if path == "/debug/traces" else tr.flight_snapshot()
        except Exception as e:  # noqa: BLE001 - never crash health
            return 500, {"error": str(e)}
    if path == "/debug/timeseries":
        from . import timeseries

        ts = timeseries.current()
        if ts is None:
            return 200, {"enabled": False}
        try:
            return 200, ts.to_dict()
        except Exception as e:  # noqa: BLE001 - never crash health
            return 500, {"error": str(e)}
    return None
