"""Shared daemon runtime: the wire clientset, signals, the leader-election
loop, serve-forever, the health server and the continuous telemetry (the
time-series scraper, the SLO monitor and the shipper's sink).

The reference ships runnable binaries (``cmd/kube-apiserver``,
``plugin/cmd/kube-scheduler``); the port's process-model equivalents are::

    python -m kubernetes_tpu_torch.apiserver --port 6443 [--data-dir DIR]
    python -m kubernetes_tpu_torch.scheduler --apiserver http://127.0.0.1:6443 --leader-elect

Each daemon runs threaded informers over the wire clientset, takes the
leader lease where the reference does (scheduler ``app/server.go:133``),
and shuts down on SIGINT/SIGTERM."""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .client.clientset import Clientset
from .client.leaderelection import LeaderElector
from .client.remote import RemoteStore
from .utils.health import handle_debug_path

logger = logging.getLogger("kubernetes_tpu_torch.daemon")

# how long a stopping lease holder waits for its payload to wind down
# (drain the event sink, report) before it releases the lease anyway
PAYLOAD_JOIN_S = 60.0
# how often a lease holder checks its payload thread and its renew
# deadline
_LIVENESS_POLL_S = 0.2
# the retry period (leaderelection.go RetryPeriod): how often a standby
# tries for the lease and a holder renews it
_ACQUIRE_RETRY_S = 2.0


def remote_clientset(apiserver: str, token: Optional[str] = None) -> Clientset:
    """A clientset over the wire to ``apiserver`` with an optional bearer
    token.  Kubeconfig documents come with the PKI slice."""
    return Clientset(RemoteStore(apiserver, token=token))


def install_signal_stop() -> threading.Event:
    """SIGINT/SIGTERM set the returned event (graceful shutdown)."""
    stop = threading.Event()

    def _handler(signum, frame):
        logger.info("signal %s: shutting down", signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _handler)
        except ValueError:  # not the main thread (tests): the caller sets stop
            pass
    return stop


class _HeldLease:
    """The renewing side of a held lease, on a thread of its own: a
    renewal stuck in the client's retries (an apiserver that is down or
    restarting) cannot delay the holder's check of its renew deadline.

    ``renewed_at`` is the monotonic time at the start of the last round
    that renewed.  The record that round wrote carries a later renew time,
    so the lease is the holder's at least until ``renewed_at +
    lease_duration``, and no standby takes it before then."""

    def __init__(self, elector: LeaderElector, renewed_at: float):
        self.elector = elector
        self.renewed_at = renewed_at
        self.taken = False  # a round answered that the lease is another's
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{elector.lock_name}-renew")
        self._thread.start()

    def _loop(self) -> None:
        # leaderelection.go renew: a round every retry period until one
        # renews, abandoned at the renew deadline by the holder's check
        while not self._stop.wait(_ACQUIRE_RETRY_S):
            started = time.monotonic()
            if self.elector.try_acquire_or_renew():
                self.renewed_at = started
            elif not self.elector.is_leader:
                self.taken = True
                return

    def lost(self) -> bool:
        """Taken by another, or no renewal within the renew deadline.  As in
        ``leaderelection.go`` ``renew``, the deadline starts with the first
        round after the last renewal, a retry period after it: the holder
        gives up leaseDuration - renewDeadline - retryPeriod (3 s at the
        defaults) before the lease it last wrote expires."""
        return self.taken or (time.monotonic() - self.renewed_at
                              >= _ACQUIRE_RETRY_S + self.elector.renew_deadline)

    def expires(self) -> float:
        """The monotonic time from which a standby may hold the lease."""
        return self.renewed_at + self.elector.lease_duration

    def stop(self, wait: float = 0.0) -> None:
        """No more rounds; wait up to ``wait`` seconds for one in flight, so
        that it cannot renew after the holder releases the lease."""
        self._stop.set()
        self._thread.join(timeout=wait)


def _fence_exit(lock_name: str) -> None:
    """A payload that outlives its lease would bind beside the next holder:
    end the process, as the reference's scheduler does when it stops
    leading (``server.go`` ``OnStoppedLeading``: ``klog.Fatalf``)."""
    logger.critical("%s: the payload did not stop before the lease expired; exiting",
                    lock_name)
    logging.shutdown()
    os._exit(1)


def _end_before_expiry(t: threading.Thread, lease: _HeldLease, lock_name: str) -> None:
    """The lease is lost and the payload told to stop: wait for it until
    just before the lease expires, and fence the process if it is still
    running then."""
    t.join(timeout=max(0.0, lease.expires() - _LIVENESS_POLL_S - time.monotonic()))
    if t.is_alive():
        _fence_exit(lock_name)


def run_with_leader_election(
    clientset: Clientset,
    lock_name: str,
    identity: str,
    run: Callable[[threading.Event], None],
    stop: threading.Event,
    leader_elect: bool = True,
) -> bool:
    """RunOrDie (``leaderelection.go:152``): wait until the lease is ours,
    run the payload in a thread, renew until the lease is lost or ``stop``
    is set.  Renewals run every ``_ACQUIRE_RETRY_S`` on a thread of their
    own (``_HeldLease``); a failed one is retried, and the lease is lost
    when a round says it is another's or when no round has renewed within
    the elector's renew deadline, counted from the first round after the
    last one that did (``_HeldLease.lost``).  An apiserver restart shorter
    than that leaves the payload running.  Losing the lease stops the payload and returns to standby;
    the payload must be gone before the lease it last wrote expires, or
    the process exits (``_fence_exit``), so two holders never run at once.

    Returns True after a clean stop and False when the payload thread
    died or did not stop within ``PAYLOAD_JOIN_S``: a lease whose payload
    died is released at once so a standby takes over, and the caller exits
    non-zero.  Without ``leader_elect`` the payload runs on this thread
    and its exception propagates."""
    if not leader_elect:
        run(stop)
        return True
    elector = LeaderElector(clientset, lock_name, identity)
    while not stop.is_set():
        started = time.monotonic()
        if not elector.try_acquire_or_renew():
            stop.wait(_ACQUIRE_RETRY_S)
            continue
        logger.info("%s: became leader (%s)", lock_name, identity)
        lease = _HeldLease(elector, started)
        payload_stop = threading.Event()
        t = threading.Thread(target=run, args=(payload_stop,), daemon=True,
                             name=f"{lock_name}-payload")
        t.start()
        lost = False
        while not stop.is_set():
            if not t.is_alive():
                # a holder doing no work would stall the control plane
                logger.error("%s: payload thread died; releasing the lease", lock_name)
                lease.stop(wait=_ACQUIRE_RETRY_S)
                elector.release()
                return False
            if lease.lost():
                logger.warning("%s: lost the lease (%s)", lock_name,
                               "taken" if lease.taken else
                               f"no renewal in {elector.renew_deadline:.1f} s")
                lost = True
                break
            stop.wait(_LIVENESS_POLL_S)
        payload_stop.set()
        if lost:
            lease.stop()
            _end_before_expiry(t, lease, lock_name)
            # back to standby (a supervised binary would exit and restart
            # into the same loop)
            continue
        # a clean stop: the lease is renewed while the payload winds down
        # (drains the event sink, reports), then released
        deadline = time.monotonic() + PAYLOAD_JOIN_S
        while t.is_alive() and time.monotonic() < deadline:
            if lease.lost():
                _end_before_expiry(t, lease, lock_name)
                break
            t.join(timeout=_LIVENESS_POLL_S)
        lease.stop(wait=_ACQUIRE_RETRY_S)
        if t.is_alive():
            # still running: keep the lease until the process ends and it
            # expires, rather than hand it to a standby beside this payload
            return False
        elector.release()
        return True
    return True


def wait_forever(stop: threading.Event) -> None:
    """Block until ``stop`` is set (by a signal)."""
    while not stop.wait(1.0):
        pass


def telemetry_sink(spec: str):
    """``--telemetry-sink``: an ``http(s)://`` URL is a collector (the
    apiserver's ``/telemetry`` route), anything else a JSON-lines file."""
    from .utils.telemetry import FileSink, HTTPSink

    if spec.startswith("http://") or spec.startswith("https://"):
        return HTTPSink(spec)
    return FileSink(spec)


def enable_continuous_telemetry(registry, interval_s: float = 1.0,
                                sink_spec: Optional[str] = None, slos: bool = True):
    """Start the time-series scraper over ``registry``, attach the burn-rate
    SLO monitor (a breach dumps the flight recorder) and, with a sink, the
    shipper fed with flight dumps and per-scrape time-series deltas.
    Returns the store (``timeseries.disable()`` and ``telemetry.disable()``
    tear it down)."""
    from .utils import slo, telemetry, timeseries

    store = timeseries.enable(registry, interval_s=interval_s)
    if slos:
        slo.monitor(store=store)
    if sink_spec:
        shipper = telemetry.enable(telemetry_sink(sink_spec), registry=registry)
        store.add_observer(telemetry.timeseries_observer(shipper))
    return store


class HealthServer:
    """``/healthz``, ``/metrics`` and the ``/debug/*`` routes
    (``utils/health.py``) on a port of their own (the scheduler's :10251).  ``registry`` may be anything with ``expose()``; None serves
    no ``/metrics``."""

    def __init__(self, port: int, registry=None, host: str = "127.0.0.1"):
        self.registry = registry
        health = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                routed = handle_debug_path(self.path.split("?", 1)[0], health.registry)
                code, payload = routed if routed is not None else (404, {"error": "not found"})
                if isinstance(payload, str):
                    data, ctype = payload.encode(), "text/plain"
                else:
                    data, ctype = json.dumps(payload).encode(), "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.local_port = self.httpd.server_port
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="healthz")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)


def serve_health(port: Optional[int], registry=None,
                 host: str = "127.0.0.1") -> Optional[HealthServer]:
    """Start the daemon's health server (the reference mounts ``/healthz``
    and ``/metrics`` on every daemon, scheduler ``app/server.go:149``).
    Start it before leader election: a standby that answers no liveness
    probe gets killed by its supervisor.  Returns the running server, or
    None when ``port`` is None or negative (0 picks a free port)."""
    if port is None or port < 0:
        return None
    server = HealthServer(port, registry, host)
    server.start()
    return server
