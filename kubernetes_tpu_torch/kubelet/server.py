"""Kubelet read API: the node's HTTP server (logs, healthz, pods).

Capability of ``pkg/kubelet/server`` (3,911 LoC) at this framework's
depth: the :10250 read surface the apiserver proxies pod subresources
to —

  GET /healthz
  GET /pods                                   (the node's pod list)
  GET /stats/summary                          (cadvisor-style usage)
  GET /containerLogs/{ns}/{pod}/{container}[?tailLines=N]
  POST /exec/{ns}/{pod}/{container}       {"command": [...]}

Exec is the CRI ExecSync capability: the reference streams over SPDY;
the command-in/stdout+exit-out contract rides JSON here.

Log content comes from the fake runtime's per-container buffers, which
the hollow kubelet writes lifecycle lines into (started/restarted/
probe failures) and tests/workloads can append to."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class KubeletServer:
    def __init__(self, kubelet, host: str = "127.0.0.1", port: int = 0,
                 exec_token: str = ""):
        self.kubelet = kubelet
        # exec is a WRITE capability: when a token is set, exec requests
        # must present it (the reference kubelet delegates authn/authz to
        # the apiserver; the shared-secret bearer is that contract's
        # minimal form — the read-only endpoints stay open like :10255)
        self.exec_token = exec_token
        handler = _make_handler(kubelet, self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def _make_handler(kubelet, server_ref=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _send(self, code: int, data: bytes, ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if url.path == "/healthz":
                return self._send(200, b"ok", "text/plain")
            if url.path == "/stats/summary":
                return self._send(200, json.dumps(kubelet.stats_summary()).encode())
            if url.path == "/pods":
                pods = [p.to_dict() for p in kubelet._my_pods()]
                return self._send(200, json.dumps({"items": pods}).encode())
            if len(parts) == 4 and parts[0] == "containerLogs":
                _, ns, pod, container = parts
                q = parse_qs(url.query)
                lines = kubelet.runtime.read_logs(f"{ns}/{pod}", container)
                if lines is None:
                    return self._send(404, b"container not found", "text/plain")
                tail = q.get("tailLines", [None])[0]
                if tail is not None:
                    if not tail.isdigit():
                        return self._send(400, b"tailLines must be an integer",
                                          "text/plain")
                    lines = lines[-int(tail):]
                return self._send(200, ("\n".join(lines) + "\n" if lines else "").encode(),
                                  "text/plain")
            if len(parts) == 4 and parts[0] == "attach":
                # attach = the container's live output stream; at this
                # depth (no TTY) it serves the stream so far, like the
                # reference's attach without stdin.  A silent container is
                # an EMPTY stream, not a 404 — existence is judged by the
                # pod spec, not by whether it has logged yet.
                _, ns, pod, container = parts
                key = f"{ns}/{pod}"
                target = next((p2 for p2 in kubelet._my_pods() if p2.meta.key == key), None)
                if target is None:
                    return self._send(404, b"pod not on this node", "text/plain")
                if container not in [c.name for c in target.spec.containers]:
                    return self._send(404, b"container not found", "text/plain")
                lines = kubelet.runtime.read_logs(key, container) or []
                return self._send(200, ("\n".join(lines) + "\n" if lines else "").encode(),
                                  "text/plain")
            if len(parts) == 4 and parts[0] == "cp":
                # cp READ is an exec-class capability too (it exfiltrates
                # container files): same token gate as exec/cp-write
                resolved = self._resolve_cp(parts)
                if resolved is None:
                    return
                key, container = resolved
                q = parse_qs(url.query)
                path = q.get("path", [""])[0]
                data = kubelet.runtime.read_file(key, container, path)
                if data is None:
                    return self._send(404, b"file not found", "text/plain")
                return self._send(200, data, "application/octet-stream")
            return self._send(404, b"not found", "text/plain")

        def _resolve_cp(self, parts):
            """Shared cp validation: exec token + pod-on-node +
            container-in-spec (the same gates exec/attach apply).  Returns
            (pod_key, container) or None after writing the error."""
            token = server_ref.exec_token
            if token:
                auth = self.headers.get("Authorization", "")
                if auth != f"Bearer {token}":
                    self._send(401, b"unauthorized", "text/plain")
                    return None
            _, ns, pod, container = parts
            key = f"{ns}/{pod}"
            target = next((p2 for p2 in kubelet._my_pods() if p2.meta.key == key), None)
            if target is None:
                self._send(404, b"pod not on this node", "text/plain")
                return None
            if container not in [c.name for c in target.spec.containers]:
                self._send(404, b"container not found", "text/plain")
                return None
            return key, container

        def do_PUT(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if len(parts) == 4 and parts[0] == "cp":
                resolved = self._resolve_cp(parts)
                if resolved is None:
                    return
                key, container = resolved
                q = parse_qs(url.query)
                path = q.get("path", [""])[0]
                if not path:
                    return self._send(400, b"path required", "text/plain")
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length) if length else b""
                kubelet.runtime.write_file(key, container, path, data)
                return self._send(200, b"{}")
            return self._send(404, b"not found", "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if len(parts) == 4 and parts[0] == "exec":
                token = server_ref.exec_token
                if token:
                    auth = self.headers.get("Authorization", "")
                    if auth != f"Bearer {token}":
                        return self._send(401, b"unauthorized", "text/plain")
                _, ns, pod, container = parts
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length)) if length else {}
                except ValueError:
                    return self._send(400, b"bad json", "text/plain")
                command = body.get("command") or []
                if not isinstance(command, list) or not command:
                    return self._send(400, b"command required", "text/plain")
                key = f"{ns}/{pod}"
                target = next((p2 for p2 in kubelet._my_pods() if p2.meta.key == key), None)
                if target is None:
                    return self._send(404, b"pod not on this node", "text/plain")
                if container not in [c.name for c in target.spec.containers]:
                    return self._send(404, b"container not found", "text/plain")
                stdout, code = kubelet.runtime.exec(key, container, [str(c) for c in command])
                out = json.dumps({"stdout": stdout, "exitCode": int(code)}).encode()
                return self._send(200, out)
            return self._send(404, b"not found", "text/plain")

    return Handler
