"""Master↔node secure channel: the SSH-tunnel capability.

Capability of the reference's ``pkg/master/tunneler`` (SSHTunnler /
SSHTunnelList): when nodes are not directly reachable from the master,
apiserver→kubelet traffic (stats scrapes, logs, exec) rides per-node
tunnels that the master dials, health-checks, and re-establishes.  Here
the channel is a REAL byte relay instead of sshd:

- :class:`NodeTunnelAgent` runs node-side next to the kubelet read API
  (which binds loopback): a TCP listener that authenticates one HMAC
  token line (minted under the cluster signing key, like the exec
  credential) and then splices bytes bidirectionally to the local
  kubelet port.  Without the token the agent closes without relaying —
  reaching the agent's port is not enough.
- :class:`Tunneler` runs master-side: per-node registry, lazy dialing,
  TTL-cached liveness (``SecondsSinceSync``'s role), and plain HTTP
  spoken OVER the tunnel socket, so the apiserver's node proxy can route
  through it without the kubelet being directly routable.

Both ends are tick-friendly and carry stats; the apiserver takes an
optional ``tunneler`` and prefers it for node-proxy traffic.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import socket
import threading
import time
from typing import Callable, Optional

from ..auth.authn import CLUSTER_SIGNING_KEY


def tunnel_token(node_name: str, key: bytes = CLUSTER_SIGNING_KEY) -> str:
    """The master's credential for a node's tunnel agent (HMAC under the
    cluster signing key, like ``kubelet_exec_token``)."""
    return hmac.new(key, f"node-tunnel:{node_name}".encode(),
                    hashlib.sha256).hexdigest()


class NodeTunnelAgent:
    """Node-side relay: authenticated TCP in, loopback kubelet out."""

    def __init__(self, node_name: str, target_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 key: bytes = CLUSTER_SIGNING_KEY):
        self.node_name = node_name
        self.target_port = target_port
        self._token = tunnel_token(node_name, key)
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # counters bumped from the accept loop AND per-connection threads;
        # unguarded += loses updates under concurrent dials (RL303)
        self._stats_mu = threading.Lock()
        self.stats = {"accepted": 0, "relayed": 0, "rejected": 0}

    def _bump(self, key: str) -> None:
        with self._stats_mu:
            self.stats[key] += 1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        # close() alone does NOT wake a thread parked in accept() — the
        # kernel keeps the listening socket alive under the blocked
        # syscall and the agent would keep serving; shutdown() forces
        # accept to return, then the join guarantees the port is
        # actually released before stop() returns
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed
            self._bump("accepted")
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _read_line(self, conn: socket.socket, limit: int = 256) -> str:
        buf = b""
        while not buf.endswith(b"\n") and len(buf) < limit:
            chunk = conn.recv(1)
            if not chunk:
                break
            buf += chunk
        return buf.decode(errors="replace").strip()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            line = self._read_line(conn)
            if not (line.startswith("TUNNEL ")
                    and hmac.compare_digest(line[len("TUNNEL "):], self._token)):
                self._bump("rejected")
                conn.close()
                return
            conn.sendall(b"OK\n")
            conn.settimeout(None)
            upstream = socket.create_connection(
                ("127.0.0.1", self.target_port), timeout=5.0)
        except OSError:
            conn.close()
            return
        self._bump("relayed")
        # real byte splicing, one thread per direction (the tunnel IS the
        # transport — HTTP, chunked streams, anything rides it verbatim)
        t = threading.Thread(target=self._pump, args=(conn, upstream),
                             daemon=True)
        t.start()
        self._pump(upstream, conn)
        t.join(timeout=5)

    @staticmethod
    def _pump(src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass


class _TunnelHTTPConnection(http.client.HTTPConnection):
    """HTTPConnection whose transport is an already-handshaken tunnel."""

    def __init__(self, sock: socket.socket):
        super().__init__("tunnel")
        self.sock = sock

    def connect(self) -> None:  # pragma: no cover - sock pre-set
        pass


class Tunneler:
    """Master-side tunnel registry + dialer + health cache.

    ``register(node, host, port)`` records where the node's agent
    listens; ``request(node, ...)`` speaks HTTP over a fresh tunnel;
    ``healthy(node)`` answers from a TTL cache, re-probing on expiry
    (the reference's SSHTunnelList healthcheck loop, tick-shaped)."""

    def __init__(self, key: bytes = CLUSTER_SIGNING_KEY,
                 health_ttl: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self._key = key
        self.health_ttl = health_ttl
        self._clock = clock
        self._agents: dict[str, tuple[str, int]] = {}
        self._health: dict[str, tuple[float, bool]] = {}  # node -> (t, ok)
        self._mu = threading.Lock()
        self.stats = {"dials": 0, "dial_failures": 0, "requests": 0}

    def register(self, node_name: str, host: str, port: int) -> None:
        with self._mu:
            self._agents[node_name] = (host, port)

    def unregister(self, node_name: str) -> None:
        with self._mu:
            self._agents.pop(node_name, None)
            self._health.pop(node_name, None)

    def nodes(self) -> list[str]:
        with self._mu:
            return sorted(self._agents)

    def has(self, node_name: str) -> bool:
        """O(1) membership — the proxy's per-request check must not copy
        and sort a 5k-node registry."""
        with self._mu:
            return node_name in self._agents

    def dial(self, node_name: str, timeout: float = 5.0) -> socket.socket:
        """Open + authenticate a tunnel; raises OSError on any failure."""
        with self._mu:
            addr = self._agents.get(node_name)
        if addr is None:
            raise OSError(f"no tunnel agent registered for node {node_name!r}")
        with self._mu:
            self.stats["dials"] += 1
        try:
            sock = socket.create_connection(addr, timeout=timeout)
            sock.sendall(f"TUNNEL {tunnel_token(node_name, self._key)}\n".encode())
            buf = b""
            while not buf.endswith(b"\n") and len(buf) < 8:
                chunk = sock.recv(1)
                if not chunk:
                    break
                buf += chunk
            if buf.strip() != b"OK":
                sock.close()
                raise OSError("tunnel handshake rejected")
            with self._mu:
                # a successful dial IS a health probe: request traffic
                # keeps the cache warm so healthy() rarely has to probe
                self._health[node_name] = (self._clock(), True)
            return sock
        except OSError:
            with self._mu:
                self.stats["dial_failures"] += 1
                self._health[node_name] = (self._clock(), False)
            raise

    def healthy(self, node_name: str) -> bool:
        """TTL-cached tunnel liveness; a probe IS a full handshake."""
        now = self._clock()
        with self._mu:
            cached = self._health.get(node_name)
        if cached is not None and now - cached[0] < self.health_ttl:
            return cached[1]
        try:
            self.dial(node_name).close()
            ok = True
        except OSError:
            ok = False
        with self._mu:
            self._health[node_name] = (now, ok)
        return ok

    def check_all(self) -> dict[str, bool]:
        """One health sweep (the reference's healthcheck loop body)."""
        return {n: self.healthy(n) for n in self.nodes()}

    def request(self, node_name: str, method: str, path: str,
                body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout: float = 10.0) -> tuple[int, bytes, str]:
        """HTTP over the tunnel: (status, body, content-type)."""
        sock = self.dial(node_name, timeout=timeout)
        sock.settimeout(timeout)
        with self._mu:
            self.stats["requests"] += 1
        conn = _TunnelHTTPConnection(sock)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return (resp.status, data,
                    resp.headers.get("Content-Type", "application/json"))
        finally:
            conn.close()
