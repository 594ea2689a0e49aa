"""Userspace proxy mode: a real per-connection TCP forwarder.

Capability of the reference's legacy userspace proxier
(``pkg/proxy/userspace/proxier.go`` + ``roundrobin.go`` LoadBalancerRR,
2,088 LoC): one listening socket per service port; each accepted
connection picks a backend via round-robin (or the caller's sticky
affinity entry) and bytes are pumped both ways until either side closes.
Where the iptables mode synthesizes NAT rules (``proxier.py``), this mode
actually terminates and re-dials connections — the trade the reference
retired it over (two copies through userspace per byte), kept here both
for mode parity and because it is the one proxier a test can point real
sockets at.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class _Backend:
    host: str
    port: int


@dataclass
class _ServiceState:
    listener: socket.socket
    proxy_port: int
    backends: list[_Backend] = field(default_factory=list)
    rr_index: int = 0
    affinity: str = "None"
    # client ip -> backend index (ClientIP affinity, roundrobin.go
    # affinityState)
    sticky: dict[str, int] = field(default_factory=dict)
    conns: int = 0


class UserspaceProxier:
    """Listens on ephemeral localhost ports, one per service key, and
    forwards accepted connections to the service's backends."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self._services: dict[str, _ServiceState] = {}
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()

    # -- service table (OnServiceUpdate / OnEndpointsUpdate) ---------------
    def set_service(self, key: str, backends: list[tuple[str, int]],
                    affinity: str = "None", local_port: int = 0) -> int:
        """Create/update a proxied service; returns the local proxy port
        (the reference allocates a node port per userspace service).
        ``local_port`` pins the listener (port-forward's LOCAL:REMOTE);
        0 = ephemeral."""
        with self._lock:
            st = self._services.get(key)
            if st is None:
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                listener.bind((self.host, local_port))
                listener.listen(64)
                st = _ServiceState(listener=listener,
                                   proxy_port=listener.getsockname()[1])
                self._services[key] = st
                t = threading.Thread(target=self._accept_loop, args=(key, st),
                                     daemon=True)
                t.start()
                self._threads.append(t)
            old = {(b.host, b.port) for b in st.backends}
            st.backends = [_Backend(h, p) for h, p in backends]
            st.affinity = affinity
            new = {(b.host, b.port) for b in st.backends}
            if old != new:
                # endpoints changed: sticky entries pointing at removed
                # backends are stale (proxier.go deleteEndpointConnections)
                st.sticky.clear()
                st.rr_index = 0
            return st.proxy_port

    def remove_service(self, key: str) -> None:
        with self._lock:
            st = self._services.pop(key, None)
        if st is not None:
            try:
                st.listener.close()
            except OSError:
                pass

    def proxy_port(self, key: str) -> Optional[int]:
        with self._lock:
            st = self._services.get(key)
            return st.proxy_port if st else None

    def stats(self, key: str) -> dict:
        with self._lock:
            st = self._services.get(key)
            if st is None:
                return {}
            return {"conns": st.conns, "backends": len(st.backends)}

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            for st in self._services.values():
                try:
                    st.listener.close()
                except OSError:
                    pass
            self._services.clear()

    # -- data path ----------------------------------------------------------
    def _pick(self, st: _ServiceState, client_ip: str) -> Optional[_Backend]:
        """LoadBalancerRR.NextEndpoint: sticky hit first, else advance the
        round-robin cursor (and record it when affinity is on)."""
        if not st.backends:
            return None
        if st.affinity == "ClientIP":
            idx = st.sticky.get(client_ip)
            if idx is not None and idx < len(st.backends):
                return st.backends[idx]
        idx = st.rr_index % len(st.backends)
        st.rr_index += 1
        if st.affinity == "ClientIP":
            st.sticky[client_ip] = idx
        return st.backends[idx]

    def _accept_loop(self, key: str, st: _ServiceState) -> None:
        while not self._stopped.is_set():
            try:
                conn, addr = st.listener.accept()
            except OSError:
                return  # listener closed (service removed / stop)
            with self._lock:
                if self._services.get(key) is not st:
                    conn.close()
                    return
                backend = self._pick(st, addr[0])
                st.conns += 1
            if backend is None:
                conn.close()  # no endpoints: REJECT analogue
                continue
            threading.Thread(target=self._proxy_conn,
                             args=(conn, backend), daemon=True).start()

    def _proxy_conn(self, client: socket.socket, backend: _Backend) -> None:
        try:
            upstream = socket.create_connection((backend.host, backend.port),
                                                timeout=5)
        except OSError:
            client.close()
            return

        done = {"count": 0}
        done_lock = threading.Lock()

        def pump(src, dst):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                # propagate EOF as a half-close only: a client that shuts
                # its write side (FIN-delimited request) must still be able
                # to READ the backend's reply through the other pump
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                with done_lock:
                    done["count"] += 1
                    finished = done["count"] == 2
                if finished:
                    for s in (src, dst):
                        try:
                            s.close()
                        except OSError:
                            pass

        threading.Thread(target=pump, args=(client, upstream), daemon=True).start()
        threading.Thread(target=pump, args=(upstream, client), daemon=True).start()
