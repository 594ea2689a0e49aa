"""Shared daemon runtime: the wire clientset, signals, the leader-election
loop, serve-forever and the health server.

The reference ships runnable binaries (``cmd/kube-apiserver``,
``plugin/cmd/kube-scheduler``); the port's process-model equivalents are::

    python -m kubernetes_tpu_torch.apiserver --port 6443 --disable-admission
    python -m kubernetes_tpu_torch.scheduler --apiserver http://127.0.0.1:6443 --leader-elect

Each daemon runs threaded informers over the wire clientset, takes the
leader lease where the reference does (scheduler ``app/server.go:133``),
and shuts down on SIGINT/SIGTERM."""

from __future__ import annotations

import json
import logging
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
# how often a lease holder checks that its payload thread is alive, and a
# standby tries for the lease
_LIVENESS_POLL_S = 0.2
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
    is set.  Losing the lease stops the payload and returns to standby.

    Returns True after a clean stop and False when the payload thread
    died: the lease is then released at once so a standby takes over, and
    the caller exits non-zero.  Without ``leader_elect`` the payload runs
    on this thread and its exception propagates."""
    if not leader_elect:
        run(stop)
        return True
    elector = LeaderElector(clientset, lock_name, identity)
    while not stop.is_set():
        if not elector.try_acquire_or_renew():
            stop.wait(_ACQUIRE_RETRY_S)
            continue
        logger.info("%s: became leader (%s)", lock_name, identity)
        lost = False
        payload_stop = threading.Event()
        t = threading.Thread(target=run, args=(payload_stop,), daemon=True,
                             name=f"{lock_name}-payload")
        t.start()
        next_renew = time.monotonic() + elector.renew_deadline / 2
        while not stop.is_set():
            if not t.is_alive():
                # a holder doing no work would stall the control plane
                logger.error("%s: payload thread died; releasing the lease", lock_name)
                elector.release()
                return False
            if time.monotonic() >= next_renew:
                if not elector.try_acquire_or_renew():
                    logger.warning("%s: lost the lease", lock_name)
                    lost = True
                    break
                next_renew = time.monotonic() + elector.renew_deadline / 2
            stop.wait(_LIVENESS_POLL_S)
        payload_stop.set()
        t.join(timeout=PAYLOAD_JOIN_S)
        if not lost:
            elector.release()
            return not t.is_alive()
        # lost the lease: back to standby (a supervised binary would exit
        # and restart into the same loop)
    return True


def wait_forever(stop: threading.Event) -> None:
    """Block until ``stop`` is set (by a signal)."""
    while not stop.wait(1.0):
        pass


class HealthServer:
    """``/healthz`` and ``/metrics`` on a port of their own (the scheduler's
    :10251).  ``registry`` may be anything with ``expose()``; None serves
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
