"""HTTP API server: the store served over REST, with watch streaming.

The core of the reference's generic API server + kube-apiserver: resource
routes per kind (``apiserver/pkg/endpoints/installer.go``), per-verb
handlers (``handlers/rest.go:150 GetResource``, ``:276 ListResource``
with the watch upgrade, ``:388 createHandler``), the Binding subresource
(``pkg/registry/core/pod/storage/storage.go:128``), and of the filter
chain (``server/config.go:469``) the panic recovery and the request
metrics.  It answers the reference package's ``RemoteStore`` as it
answers the port's: the same paths, ``kind: Status`` error bodies, watch
lines and ``resourceVersion`` semantics.

Wire form: JSON.  A watch is a chunked stream of JSON lines, one event a
line (``type``, ``kind``, ``key``, ``revision``, ``object``), resumable
with ``resourceVersion`` and ended by the server after ``timeoutSeconds``.

Routes:
  GET    /healthz  /metrics  /version  /api  /api/v1
  GET    /api/v1/{resource}[?namespace=&labelSelector=&fieldSelector=]
  GET    /api/v1/{resource}?watch=true[&resourceVersion=N&timeoutSeconds=S]
  POST   /api/v1/{resource}
  GET    /api/v1/namespaces/{ns}/{resource}[?watch=true]
  POST   /api/v1/namespaces/{ns}/{resource}
  GET    /api/v1/namespaces/{ns}/{resource}/{name}
  PUT    /api/v1/namespaces/{ns}/{resource}/{name}
  DELETE /api/v1/namespaces/{ns}/{resource}/{name}
  POST   /api/v1/namespaces/{ns}/pods/{name}/binding
  POST   /api/v1/bindings:batch          (one store txn for a wave's binds)
  POST   /api/v1/{resource}:batch        (batch create: one store txn)
Cluster-scoped objects use ns "-" in paths.  Any other route answers 404,
a known route with another method 405.  Authentication, authorization,
audit, admission, TLS, PATCH and the overload throttle are not part of
this server yet.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from .. import __version__
from ..api.selectors import parse_selector_string
from ..api.types import CLUSTER_SCOPED_KINDS, KIND_PLURALS, convert_to_internal, kind_for_plural
from ..store.store import (
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    Store,
    WatchEvent,
)
from ..utils.health import handle_debug_path
from ..utils.metrics import APIServerMetrics

logger = logging.getLogger("kubernetes_tpu_torch.apiserver")

# the most watch lines written in one chunk: a burst (a wave's 2000 ADDED
# events) goes out in a few writes, not one write and flush a line
_WATCH_LINES_PER_CHUNK = 256

# the fields a fieldSelector may name (the ones the reference's own
# callers select on)
_FIELD_GETTERS: dict[str, Callable[[dict], str]] = {
    "spec.nodeName": lambda i: (i.get("spec") or {}).get("nodeName") or "",
    "metadata.name": lambda i: (i.get("metadata") or {}).get("name"),
    "metadata.namespace": lambda i: (i.get("metadata") or {}).get("namespace"),
    "status.phase": lambda i: (i.get("status") or {}).get("phase") or "",
}


def event_wire_bytes(ev: WatchEvent) -> bytes:
    """One watch line (JSON + newline) for ``ev``, encoded once and shared
    by every stream: the line is cached on the event, which every
    watcher's queue shares read-only.  Concurrent first encoders write the
    same bytes."""
    got = ev.__dict__.get("_wire")
    if got is None:
        got = json.dumps({"type": ev.type, "kind": ev.kind, "key": ev.key,
                          "revision": ev.revision, "object": ev.object}).encode() + b"\n"
        object.__setattr__(ev, "_wire", got)
    return got


def compile_selectors(q: dict) -> tuple[Optional[Callable[[dict], bool]], Optional[str]]:
    """``labelSelector`` and ``fieldSelector`` query values as one predicate
    over wire objects, parsed once per request.  Returns (predicate or None
    when there are no selectors, error message or None)."""
    tests: list[Callable[[dict], bool]] = []
    label_sel = q.get("labelSelector", [None])[0]
    field_sel = q.get("fieldSelector", [None])[0]
    if label_sel:
        try:
            sel = parse_selector_string(label_sel)
        except ValueError as e:
            return None, f"bad labelSelector: {e}"
        tests.append(lambda i: sel.matches((i.get("metadata") or {}).get("labels") or {}))
    if field_sel:
        for clause in field_sel.split(","):
            m = re.fullmatch(r"([^=!]+?)\s*(==|!=|=)\s*(.*)", clause.strip())
            if m is None:
                return None, f"bad fieldSelector clause {clause!r}"
            key, op, value = m.group(1), m.group(2), m.group(3)
            get = _FIELD_GETTERS.get(key)
            if get is None:
                return None, f"unsupported fieldSelector {key!r}"
            if op == "!=":
                tests.append(lambda i, g=get, v=value: g(i) != v)
            else:  # '=' and '==' are one operator
                tests.append(lambda i, g=get, v=value: g(i) == v)
    if not tests:
        return None, None
    return (lambda i: all(t(i) for t in tests)), None


class APIServer:
    """HTTP front end over a ``Store``: one thread per connection, so each
    watch stream holds a thread of its own."""

    def __init__(self, store: Store, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self.metrics = APIServerMetrics()
        self.registry = self.metrics.registry
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="apiserver")
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting, then close the listening socket.  Open watch
        streams end at their own timeout (their threads are daemons)."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _make_handler(server: APIServer):
    store = server.store
    metrics = server.metrics

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        # -- plumbing ------------------------------------------------------
        def _send(self, code: int, obj) -> None:
            self._send_bytes(code, json.dumps(obj).encode(), "application/json")

        def _send_bytes(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, reason: str, message: str) -> None:
            self._send(code, {"kind": "Status", "code": code, "reason": reason,
                              "message": message})

        def _body(self):
            if self._parsed is None:
                self._parsed = json.loads(self._raw) if self._raw else {}
            return self._parsed

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        # -- the filter chain: metrics and panic recovery ------------------
        def _route(self, method: str) -> None:
            start = time.perf_counter()
            metrics.request_count.inc()
            length = int(self.headers.get("Content-Length") or 0)
            # read the whole body up front: a connection kept alive must not
            # find an unread body where its next request line should be
            self._raw = self.rfile.read(length) if length else b""
            self._parsed = None
            try:
                self._dispatch(method)
            except NotFoundError as e:
                self._error(404, "NotFound", str(e))
            except AlreadyExistsError as e:
                self._error(409, "AlreadyExists", str(e))
            except ConflictError as e:
                self._error(409, "Conflict", str(e))
            except ExpiredRevisionError as e:
                self._error(410, "Expired", str(e))
            except BrokenPipeError:
                pass  # the client hung up; there is no one to answer
            except Exception as e:  # noqa: BLE001 - panic recovery filter
                logger.exception("handler panic")
                try:
                    self._error(500, "InternalError", str(e))
                except Exception:  # noqa: BLE001 - client gone mid-error; counted
                    metrics.error_write_failures.inc()
            finally:
                metrics.request_latency.observe((time.perf_counter() - start) * 1e6)

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_PUT(self):
            self._route("PUT")

        def do_PATCH(self):
            self._route("PATCH")

        def do_DELETE(self):
            self._route("DELETE")

        # -- dispatch ------------------------------------------------------
        def _dispatch(self, method: str) -> None:
            url = urlparse(self.path)
            q = parse_qs(url.query)
            path = url.path

            shared = handle_debug_path(path, server.registry)
            if shared is not None:
                if method != "GET":
                    return self._error(405, "MethodNotAllowed", method)
                code, payload = shared
                if isinstance(payload, str):
                    return self._send_bytes(code, payload.encode(), "text/plain")
                return self._send(code, payload)
            if path in ("/api", "/api/v1"):
                if method != "GET":
                    return self._error(405, "MethodNotAllowed", method)
                return self._serve_discovery(path)
            if path == "/version":
                return self._send(200, {"version": __version__})
            if path == "/api/v1/bindings:batch" and method == "POST":
                items = self._body().get("bindings", [])
                errors = store.bind_many([(b.get("podNamespace", "default"), b["podName"],
                                           b["nodeName"]) for b in items])
                return self._send(200, {"errors": errors})
            if path.startswith("/api/v1/") and path.endswith(":batch") and method == "POST":
                res = path[len("/api/v1/"):-len(":batch")]
                kind = kind_for_plural(res)
                if kind is None:
                    return self._error(404, "NotFound", f"unknown resource {res}")
                items = [convert_to_internal(d) for d in self._body().get("items", [])]
                if kind in CLUSTER_SCOPED_KINDS:
                    for d in items:
                        d.setdefault("metadata", {})["namespace"] = ""
                # the bodies were parsed for this request: the store may keep them
                return self._send(201, {"items": store.create_many(kind, items, _trusted=True)})

            parts = [p for p in path.split("/") if p]
            if len(parts) < 3 or parts[0] != "api" or parts[1] != "v1":
                return self._error(404, "NotFound", f"no route for {path}")
            parts = parts[2:]

            # collection: /api/v1/{resource}
            if len(parts) == 1:
                kind = kind_for_plural(parts[0])
                if kind is None:
                    return self._error(404, "NotFound", f"unknown resource {parts[0]}")
                if method == "GET":
                    return self._serve_list(kind, q.get("namespace", [None])[0], q)
                if method == "POST":
                    body = convert_to_internal(self._body())
                    if kind in CLUSTER_SCOPED_KINDS:
                        body.setdefault("metadata", {})["namespace"] = ""
                    return self._send(201, store.create(kind, body, _trusted=True))
                return self._error(405, "MethodNotAllowed", method)

            if parts[0] != "namespaces" or len(parts) not in (3, 4, 5):
                return self._error(404, "NotFound", f"no route for {path}")
            ns = "" if parts[1] == "-" else parts[1]
            kind = kind_for_plural(parts[2])
            if kind is None:
                return self._error(404, "NotFound", f"unknown resource {parts[2]}")

            # namespaced collection: /api/v1/namespaces/{ns}/{resource}
            if len(parts) == 3:
                if method == "GET":
                    return self._serve_list(kind, ns, q)
                if method == "POST":
                    body = convert_to_internal(self._body())
                    body.setdefault("metadata", {})["namespace"] = (
                        "" if kind in CLUSTER_SCOPED_KINDS else ns)
                    return self._send(201, store.create(kind, body, _trusted=True))
                return self._error(405, "MethodNotAllowed", method)

            # object: /api/v1/namespaces/{ns}/{resource}/{name}[/binding]
            name = parts[3]
            if len(parts) == 5:
                if parts[4] == "binding" and kind == "Pod" and method == "POST":
                    errors = store.bind_many([(ns, name, self._body()["nodeName"])])
                    if errors[0] is not None:
                        return self._error(409, "Conflict", errors[0])
                    return self._send(201, {"status": "bound"})
                return self._error(404, "NotFound", f"unknown subresource {parts[4]}")
            if method == "GET":
                return self._send(200, store.get(kind, ns, name))
            if method == "PUT":
                return self._send(200, store.update(kind, convert_to_internal(self._body()),
                                                    _trusted=True))
            if method == "DELETE":
                return self._send(200, store.delete(kind, ns, name))
            return self._error(405, "MethodNotAllowed", method)

        def _serve_discovery(self, path: str) -> None:
            """``/api`` lists the versions, ``/api/v1`` the resources of the
            live type registry (reference ``endpoints/discovery``)."""
            if path == "/api":
                return self._send(200, {"kind": "APIVersions", "versions": ["v1"]})
            resources = [{"name": plural, "kind": kind,
                          "namespaced": kind not in CLUSTER_SCOPED_KINDS}
                         for kind, plural in sorted(KIND_PLURALS.items())]
            return self._send(200, {"kind": "APIResourceList", "groupVersion": "v1",
                                    "resources": resources})

        def _serve_list(self, kind: str, namespace: Optional[str], q: dict) -> None:
            """LIST, or the watch upgrade with ``watch=true``."""
            pred, err = compile_selectors(q)
            if err is not None:
                return self._error(400, "BadRequest", err)
            if q.get("watch", ["false"])[0] == "true":
                return self._serve_watch(kind, namespace, pred, q)
            items, rev = store.list(kind, namespace)
            if pred is not None:
                items = [i for i in items if pred(i)]
            return self._send(200, {"items": items, "resourceVersion": rev})

        # -- watch streaming (handlers/rest.go:276 watch upgrade) ----------
        def _serve_watch(self, kind: str, namespace: Optional[str],
                         pred: Optional[Callable[[dict], bool]], q: dict) -> None:
            from_rev = int(q["resourceVersion"][0]) if "resourceVersion" in q else None
            timeout = float(q.get("timeoutSeconds", ["30"])[0])
            if namespace:
                ns_pred = pred
                pred = (lambda i: (i.get("metadata") or {}).get("namespace") == namespace
                        and (ns_pred is None or ns_pred(i)))
            # an expired revision raises here, before any byte is sent: 410
            watch = store.watch(kind, from_revision=from_rev)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                deadline = time.monotonic() + timeout
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    ev = watch.get(timeout=min(0.5, left))
                    if ev is None:
                        continue
                    batch = [ev]
                    while len(batch) < _WATCH_LINES_PER_CHUNK:
                        nxt = watch.get(timeout=0)
                        if nxt is None:
                            break
                        batch.append(nxt)
                    lines = [event_wire_bytes(e) for e in batch
                             if pred is None or pred(e.object)]
                    if lines:
                        self._write_chunk(b"".join(lines))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # the watcher went away
            finally:
                watch.stop()

    return Handler
