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

Wire form: JSON, or the binary wire form (``api/wire.py``) for a client
whose ``Accept`` names ``application/vnd.ktpu.binary``; a request body
in that form says so in its ``Content-Type``.  A watch is a chunked
stream of JSON lines, one event a line (``type``, ``kind``, ``key``,
``revision``, ``object``), resumable with ``resourceVersion`` and ended by
the server after ``timeoutSeconds``.
With ``frames=1`` a ``create_many``/``bind_many`` txn is one line, a
``WatchFrame`` (``store/frames.py``); with ``columnar=1`` a Pod or Node
LIST is one packed column batch (``store/columns.py``).  Both are the
reference package's wire forms.

Routes:
  GET    /healthz  /metrics  /version  /api  /api/v1  /apis
  GET    /openapi/v2  /swagger.json   (the schema of every registered kind)
  GET    /debug/traces  /debug/flightrecorder  /debug/timeseries
  POST   /telemetry   (the telemetry shipper's collector: ndjson records)
  GET    /telemetry   (the records held, newest last)
  GET    /api/v1/{resource}[?namespace=&labelSelector=&fieldSelector=&columnar=1]
  GET    /api/v1/{resource}?watch=true[&resourceVersion=N&timeoutSeconds=S&frames=1]
  POST   /api/v1/{resource}
  GET    /api/v1/namespaces/{ns}/{resource}[?watch=true]
  POST   /api/v1/namespaces/{ns}/{resource}
  GET    /api/v1/namespaces/{ns}/{resource}/{name}
  PUT    /api/v1/namespaces/{ns}/{resource}/{name}
  PATCH  /api/v1/namespaces/{ns}/{resource}/{name}   (merge, strategic-merge
         or JSON patch by Content-Type; 415 for another type, 422 when the
         patch cannot apply)
  DELETE /api/v1/namespaces/{ns}/{resource}/{name}
  POST   /api/v1/namespaces/{ns}/pods/{name}/binding
  POST   /api/v1/namespaces/{ns}/pods/{name}/eviction   (429 while a
         PodDisruptionBudget allows no disruption)
  POST   /api/v1/bindings:batch          (one store txn for a wave's binds)
  POST   /api/v1/{resource}:batch        (batch create: one store txn)
  POST   /apis/authorization.k8s.io/v1/selfsubjectaccessreviews
  ANY    /apis/{group}/...   (proxied to the backend its APIService names)
Cluster-scoped objects use ns "-" in paths.  Any other route answers 404,
a known route with another method 405.

The filter chain runs in the JAX server's order (reference
``server/config.go:469 DefaultBuildHandlerChain``): panic recovery →
request info (verb, resource, namespace, name) → max in flight (with
``max_in_flight`` > 0, a request over the cap answers 429 at once; a
watch is exempt) → authentication (with ``tls.client_ca``, a verified
client certificate's subject first) → impersonation → audit
(RequestReceived, under the impersonated user with the real one beside
it) → authorization → dispatch, and audit again (ResponseComplete, with
the status code) once the response is written.  ``tokens`` is the
static-token shorthand; ``authenticator``,
``authorizer`` and ``auditor`` take the ``auth`` package's objects; with
none of them every request runs as the empty (anonymous) identity.  The
request info maps ``POST /api/v1/{resource}:batch`` to ``create`` on
``{resource}`` and ``POST /api/v1/bindings:batch`` to ``bind`` on
``pods`` (the single binding route's verb), where the JAX server names
the resource ``{resource}:batch``.  With ``tls`` the server speaks HTTPS,
and each connection's handshake runs in its own request thread with a
10 s limit, never in the accept loop.

The create paths pass an overload gate first: ``admission_throttle`` (a
``utils.overload.AdmissionThrottle``, or anything with ``admit(resource,
bodies) -> Optional[retry_after_s]``) and the ``apiserver.admit`` fault
point may answer 429 with a ``Retry-After`` header, which ``RemoteStore``
honours.  Over an ``AdmittedStore`` (``admission/framework.py``) the
writes then pass the admission chain, and a plugin's denial answers 403
Forbidden.

The kubelet proxies: ``/api/v1/nodes/{name}/proxy/<path>`` reaches the
node's kubelet read API (through the node's tunnel when ``tunneler``
holds one, else at ``status.kubeletURL``), and the pod subresources
``log``, ``exec``, ``attach`` and ``cp`` reach the kubelet of the pod's
node after a CONNECT admission (``DenyEscalatingExec``).  Like the
aggregation proxy they dial the kubelet directly, never through an
environment proxy (``_PROXY_OPENER``), and a ``cp`` PUT forwards the body
the handler read up front.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import re
import socket
import ssl
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from .. import __version__, faults
from ..admission.framework import AdmissionDenied
from ..auth import (
    ALLOW,
    ANONYMOUS,
    AuthzAttributes,
    TokenFileAuthenticator,
    UnionAuthenticator,
    UserInfo,
    X509CertificateAuthenticator,
)
from ..auth.authn import kubelet_exec_token
from ..api import wire
from ..api.patch import CONTENT_TYPES, apply_patch
from ..api.scheme import convert_from_internal, convert_to_internal
from ..api.selectors import parse_selector_string
from ..api.types import CLUSTER_SCOPED_KINDS, KIND_PLURALS, kind_for_plural
from ..client.clientset import EvictionDisallowed, PodClient
from ..store.store import (
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    Store,
)
from ..store.frames import FRAME, event_wire_bytes
from ..utils import tracing
from ..utils.health import handle_debug_path
from ..utils.metrics import APIServerMetrics
from .openapi import build_openapi

# link the federation API group into the wire surface (the reference's
# federation-apiserver compiles its types in the same way): importing
# registers the Cluster kind; federation/__init__ is import-light (lazy
# controller loading), so this does not pull in the controller tree
from ..federation import types as _federation_types  # noqa: F401

logger = logging.getLogger("kubernetes_tpu_torch.apiserver")

# SelfSubjectAccessReview (reference authorization.k8s.io group), answered
# by the live authorizer for the calling identity
SSAR_PATH = "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews"
# paths every identity the authenticator let through may read: discovery,
# and "may I?" (the reference's system:discovery and system:basic-user)
_OPEN_PATHS = frozenset({"/api", "/api/v1", "/apis", "/openapi/v2", "/swagger.json",
                         SSAR_PATH})
# how long the aggregation proxy waits on a backend: a watch holds its
# stream open, a plain request fails fast
PROXY_WATCH_TIMEOUT_S = 300.0
PROXY_TIMEOUT_S = 30.0
# the longest a client may take over its TLS handshake
HANDSHAKE_TIMEOUT_S = 10.0
# how long a refused handshake's connection waits for the client to close
# before the server closes it
REFUSED_LINGER_S = 2.0
# the listening socket's accept queue (the kernel caps it at somaxconn)
LISTEN_BACKLOG = 4096

# the client of the aggregation and kubelet proxies: never an environment
# proxy, since a backend or a kubelet is reached directly at the address
# its APIService or Node names
_PROXY_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))

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


class TLSConfig:
    """Serving-side TLS (reference ``--tls-cert-file``/
    ``--tls-private-key-file``/``--client-ca-file``).  With ``client_ca``
    the handshake asks for (does not require) a client certificate and
    verifies it against the CA; a verified certificate's subject is the
    request's identity (CN the user, O the groups).  Clients with a token
    and no certificate authenticate as before."""

    def __init__(self, certfile: str, keyfile: str, client_ca: Optional[str] = None):
        self.certfile = certfile
        self.keyfile = keyfile
        self.client_ca = client_ca

    def context(self):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        if self.client_ca:
            ctx.load_verify_locations(self.client_ca)
            ctx.verify_mode = ssl.CERT_OPTIONAL
        return ctx


def _linger(sock) -> None:
    """A refused handshake's close, done so the client reads the alert.
    Under TLS 1.3 a client finishes its side of the handshake before the
    server checks its certificate, and sends its request; closing a socket
    with that request unread sends a reset, which can reach the client
    before it reads the alert, so it sees a dropped connection where it
    should see a refusal.  So: end the writing side after the alert, read
    and drop what the client sends until it closes, for at most
    ``REFUSED_LINGER_S``.  Plain-socket calls: the TLS session is dead."""
    try:
        socket.socket.shutdown(sock, socket.SHUT_WR)
        sock.settimeout(REFUSED_LINGER_S)
        deadline = time.monotonic() + REFUSED_LINGER_S
        while time.monotonic() < deadline and socket.socket.recv(sock, 65536):
            pass
    except OSError:
        pass  # the client is gone: nothing left to wait for


class _HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with the listen backlog of a Go listener
    (``net.Listen`` takes the kernel's ``somaxconn``), not socketserver's
    5: once the accept queue is full the kernel drops a client's SYN,
    which the client resends only after a second.  It knows which kept-
    alive connections wait for their next request, so that ``stop``
    closes them: a stopped server answers nothing more, while a request
    in flight and a watch stream run to their end, and their connection
    closes after."""

    request_queue_size = LISTEN_BACKLOG

    def __init__(self, address, handler):
        self._conn_mu = threading.Lock()
        self._idle: set = set()
        self._stopping = False
        super().__init__(address, handler)

    def await_request(self, conn) -> bool:
        """``conn`` waits for its next request; False once the server
        stops (the connection then closes)."""
        with self._conn_mu:
            if self._stopping:
                return False
            self._idle.add(conn)
            return True

    def begin_request(self, conn) -> None:
        with self._conn_mu:
            self._idle.discard(conn)

    def close_idle(self) -> None:
        """Stop keeping connections alive and close those that wait for a
        request now: their handler threads read the end and return."""
        with self._conn_mu:
            self._stopping = True
            idle, self._idle = self._idle, set()
        for conn in idle:
            try:
                # the raw socket's shutdown: an SSLSocket's own would drop
                # its TLS state under a thread still using it
                socket.socket.shutdown(conn, socket.SHUT_RDWR)
            except OSError:
                pass  # the client closed it first


class _TLSServer(_HTTPServer):
    """``_HTTPServer`` over TLS.  ``accept`` only wraps the socket;
    the handshake runs in the connection's own thread with a time limit,
    so a client that connects and sends nothing (or trickles its hello)
    holds its own thread, never the accept loop."""

    def __init__(self, address, handler, ctx):
        self._ctx = ctx
        super().__init__(address, handler)

    def get_request(self):
        sock, addr = self.socket.accept()
        return self._ctx.wrap_socket(sock, server_side=True,
                                     do_handshake_on_connect=False), addr

    def finish_request(self, request, client_address):
        request.settimeout(HANDSHAKE_TIMEOUT_S)
        try:
            request.do_handshake()
        except ssl.SSLError:
            _linger(request)
            raise
        request.settimeout(None)
        super().finish_request(request, client_address)

    def handle_error(self, request, client_address):
        # dropped, refused and garbage handshakes are routine traffic
        if isinstance(sys.exc_info()[1], OSError):  # ssl.SSLError and timeouts are OSErrors
            return
        super().handle_error(request, client_address)


class APIServer:
    """HTTP front end over a ``Store``: one thread per connection, so each
    watch stream holds a thread of its own."""

    def __init__(self, store: Store, host: str = "127.0.0.1", port: int = 0,
                 tokens: Optional[dict] = None, authenticator=None, authorizer=None,
                 auditor=None, tls: Optional[TLSConfig] = None, max_in_flight: int = 0,
                 tunneler=None):
        self.store = store
        self.tls = tls
        # the master-to-node channel (tunneler.Tunneler): the node proxy
        # rides a node's tunnel when it has one
        self.tunneler = tunneler
        # the max-in-flight filter (server/filters/maxinflight.go): a
        # semaphore, never a queue; 0 = unlimited (the reference's default
        # is 400)
        self._inflight = (threading.Semaphore(max_in_flight)
                          if max_in_flight > 0 else None)
        # tokens: token -> user name or UserInfo, the static token file
        self.authenticator = authenticator
        if authenticator is None and tokens is not None:
            self.authenticator = UnionAuthenticator(TokenFileAuthenticator(tokens),
                                                    allow_anonymous=False)
        self.authorizer = authorizer
        self.auditor = auditor
        self.metrics = APIServerMetrics()
        self.registry = self.metrics.registry
        # the overload gate of the create paths (None: always admit)
        self.admission_throttle = None
        self.admission_throttled = self.metrics.admission_throttled
        # /telemetry: records the daemons' shippers POST, bounded (the
        # oldest go first; the shippers count their own drops)
        self.telemetry_records: deque = deque(maxlen=4096)
        self._telemetry_mu = threading.Lock()
        if tls is not None:
            self.httpd = _TLSServer((host, port), _make_handler(self), tls.context())
        else:
            self.httpd = _HTTPServer((host, port), _make_handler(self))
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        scheme = "https" if self.tls is not None else "http"
        return f"{scheme}://{self.httpd.server_address[0]}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="apiserver")
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting, close the kept-alive connections that wait for a
        request, then close the listening socket.  A request in flight
        is answered; open watch streams end at their own timeout (their
        threads are daemons)."""
        self.httpd.shutdown()
        self.httpd.close_idle()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def ingest_telemetry(self, records: list) -> int:
        with self._telemetry_mu:
            self.telemetry_records.extend(records)
        self.metrics.telemetry_accepted.inc(len(records))
        return len(records)

    def telemetry_snapshot(self) -> list:
        with self._telemetry_mu:
            return list(self.telemetry_records)


def _make_handler(server: APIServer):
    store = server.store
    metrics = server.metrics

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a kept-alive connection writes an answer's headers and body as two
        # segments: under Nagle the body would wait for the client's
        # delayed ACK of the headers
        disable_nagle_algorithm = True

        def send_response(self, code, message=None):
            super().send_response(code, message)
            if not self.close_connection:
                # ``_route`` reads every body whole, so a client may send
                # its next request on this connection: say so
                self.send_header("Connection", "keep-alive")

        def handle_one_request(self):
            # idle until the request line arrives (``_route`` marks it
            # busy); a stopped server closes the connection instead
            if not self.server.await_request(self.connection):
                self.close_connection = True
                return
            try:
                super().handle_one_request()
            finally:
                self.server.begin_request(self.connection)

        def log_message(self, *args):
            pass

        # -- plumbing ------------------------------------------------------
        def _send(self, code: int, obj, headers: tuple = ()) -> None:
            # content negotiation: the binary wire form when the request's
            # Accept names it (the reference's protobuf negotiation)
            if wire.CONTENT_TYPE in (self.headers.get("Accept") or ""):
                self._send_bytes(code, wire.encode(obj), wire.CONTENT_TYPE, headers)
            else:
                self._send_bytes(code, json.dumps(obj).encode(), "application/json", headers)

        def _send_bytes(self, code: int, data: bytes, ctype: str,
                        headers: tuple = ()) -> None:
            self._last_code = code
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, reason: str, message: str,
                   retry_after: Optional[float] = None) -> None:
            # Retry-After in whole seconds, rounded up: a sub-second hint
            # never becomes an immediate retry
            headers = (("Retry-After", str(max(1, math.ceil(retry_after)))),) \
                if retry_after is not None else ()
            self._send(code, {"kind": "Status", "code": code, "reason": reason,
                              "message": message}, headers)

        def _admission_gate(self, resource: str, bodies: list) -> bool:
            """The overload gate of a create path: False when the request
            was throttled (the 429 with its Retry-After is written).  The
            ``apiserver.admit`` fault point injects a throttle (drop mode;
            its value is the hint in seconds)."""
            retry_after: Optional[float] = None
            fault = faults.hit("apiserver.admit", resource=resource, verb="create",
                               n=len(bodies))
            if fault is not None and fault.mode == "drop":
                retry_after = float(fault.value or 1.0)
            elif server.admission_throttle is not None:
                retry_after = server.admission_throttle.admit(resource, bodies)
            if retry_after is None:
                return True
            server.admission_throttled.inc()
            tr = tracing.current()
            if tr is not None:
                tr.instant("apiserver.admit.throttle", resource=resource, n=len(bodies),
                           retry_after=retry_after)
            self._error(429, "TooManyRequests",
                        f"admission throttled under overload ({len(bodies)} {resource})",
                        retry_after=retry_after)
            return False

        def _serve_telemetry(self, method: str) -> None:
            """POST: ndjson records (the shipper's wire form), or a JSON
            document (``{"items": [...]}``, a list, or one record).  GET:
            the records held."""
            if method == "GET":
                records = server.telemetry_snapshot()
                return self._send(200, {"kind": "TelemetryRecordList", "count": len(records),
                                        "items": records})
            if method != "POST":
                return self._error(405, "MethodNotAllowed", method)
            try:
                text = self._raw.decode()
                if "ndjson" in self.headers.get("Content-Type", ""):
                    records = [json.loads(line) for line in text.splitlines() if line.strip()]
                else:
                    doc = json.loads(text) if text.strip() else []
                    records = doc.get("items", [doc]) if isinstance(doc, dict) else list(doc)
            except (UnicodeDecodeError, ValueError) as e:
                return self._error(400, "BadRequest", f"undecodable telemetry payload: {e}")
            self._send(200, {"kind": "Status", "code": 200,
                             "accepted": server.ingest_telemetry(records)})

        def _body(self):
            """The request body, decoded once: the binary wire form when
            its Content-Type names it, else JSON."""
            if self._parsed is None:
                if not self._raw:
                    self._parsed = {}
                elif wire.CONTENT_TYPE in (self.headers.get("Content-Type") or ""):
                    self._parsed = wire.decode(self._raw)
                else:
                    self._parsed = json.loads(self._raw)
            return self._parsed

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        # -- the filter chain ----------------------------------------------
        def _request_info(self, method: str) -> tuple[str, str, str, str, str]:
            """(verb, resource, namespace, name, subresource): the
            request-info filter (reference ``endpoints/filters/requestinfo``),
            over this server's routes; worked out once a request, before
            dispatch (the store may fill in the body it was given)."""
            if self._info is None:
                self._info = self._parse_request_info(method)
            return self._info

        def _parse_request_info(self, method: str) -> tuple[str, str, str, str, str]:
            url, q = self._url, self._q
            parts = [p for p in url.path.split("/") if p]
            verb = {"POST": "create", "PUT": "update", "DELETE": "delete",
                    "PATCH": "patch"}.get(method, "get")
            resource, ns, name, sub = "", "", "", ""
            if len(parts) >= 2 and parts[0] == "apis":
                # an aggregated group: "<group>/<resource>", so an RBAC
                # rule can scope access a group at a time
                group, rest = parts[1], parts[3:]  # parts[2] is the version
                if len(rest) >= 3 and rest[0] == "namespaces":
                    ns, resource = rest[1], f"{group}/{rest[2]}"
                    name = rest[3] if len(rest) >= 4 else ""
                    sub = rest[4] if len(rest) >= 5 else ""
                else:
                    resource = f"{group}/{rest[0]}" if rest else group
                    name = rest[1] if len(rest) >= 2 else ""
                    sub = rest[2] if len(rest) >= 3 else ""
                if method == "GET":
                    if q.get("watch", ["false"])[0] == "true":
                        verb = "watch"
                    elif not name:
                        verb = "list"
                return verb, resource, ns, name, sub
            if len(parts) < 3 or parts[:2] != ["api", "v1"]:
                return verb, resource, ns, name, sub  # a non-resource path
            rest = parts[2:]
            if len(rest) == 1:
                resource = rest[0]
                if method == "GET":
                    verb = "watch" if q.get("watch", ["false"])[0] == "true" else "list"
                    ns = q.get("namespace", [""])[0] or ""
                elif method == "POST" and resource == "bindings:batch":
                    verb, resource = "bind", "pods"
                elif method == "POST" and resource.endswith(":batch"):
                    resource = resource[:-len(":batch")]
                elif method == "POST":
                    # a collection create carries its namespace in the body
                    try:
                        ns = (self._body().get("metadata") or {}).get("namespace", "") or ""
                    except (ValueError, AttributeError):
                        ns = ""
            elif rest[0] == "namespaces" and len(rest) >= 3:
                ns = "" if rest[1] == "-" else rest[1]
                resource = rest[2]
                if len(rest) == 3:  # the namespaced collection
                    if method == "GET":
                        verb = "watch" if q.get("watch", ["false"])[0] == "true" else "list"
                else:
                    name = rest[3]
                    sub = rest[4] if len(rest) >= 5 else ""
                    if len(rest) == 5 and rest[4] == "binding":
                        verb = "bind"
                    elif len(rest) == 5 and rest[4] in ("exec", "attach", "cp"):
                        # their own verb: create rights on pods must not
                        # imply running commands in them
                        verb = "exec"
                    elif len(rest) == 5 and rest[4] == "eviction":
                        verb = "evict"
            elif rest[0] == "nodes" and len(rest) >= 3 and rest[2] == "proxy":
                # reaching a node's kubelet is its own subresource: reading
                # the Node object must not imply it
                resource, name = "nodes/proxy", rest[1]
            return verb, resource, ns, name, sub

        def _audit(self, stage: str, code: int = 0) -> None:
            verb, resource, ns, name, _ = self._request_info(self.command)
            server.auditor.record(stage, self._audit_user or (
                self._user.name if self._user is not None else ""),
                verb, resource, ns, name, code=code)

        def _auth_filters(self, method: str) -> bool:
            """authentication → impersonation → audit (RequestReceived) →
            authorization.  False when the 401 or 403 is already written."""
            if server.authenticator is not None:
                user = None
                if server.tls is not None and server.tls.client_ca:
                    # the handshake verified the chain: the subject is the user
                    peercert = getattr(self.connection, "getpeercert", lambda: None)()
                    user = X509CertificateAuthenticator.from_peercert(peercert)
                if user is None:
                    user = server.authenticator.authenticate(self.headers)
                if user is None:
                    self._error(401, "Unauthorized", "invalid or missing credentials")
                    return False
                target = self.headers.get("Impersonate-User", "")
                if target:
                    # endpoints/filters/impersonation.go: the REAL identity
                    # needs "impersonate" on the user and on every group
                    if server.authorizer is None:
                        self._error(403, "Forbidden", "impersonation requires an authorizer")
                        return False
                    groups = [g.strip() for raw in (self.headers.get_all("Impersonate-Group")
                                                    or [])
                              for g in raw.split(",") if g.strip()]
                    for resource, name in [("users", target)] + [("groups", g) for g in groups]:
                        decision, reason = server.authorizer.authorize(AuthzAttributes(
                            user=user, verb="impersonate", resource=resource, name=name))
                        if decision != ALLOW:
                            self._error(403, "Forbidden", f"cannot impersonate "
                                        f"{resource[:-1]} {name!r}: {reason}")
                            return False
                    # the audit trail keeps the real actor
                    self._audit_user = f"{target} (impersonated-by {user.name})"
                    user = UserInfo(name=target, groups=groups)
                self._user = user
            if server.auditor is not None:
                self._audit("RequestReceived")
            path = self._url.path
            if path not in _OPEN_PATHS and server.authorizer is not None:
                # no authenticator: authorize as anonymous (fail closed,
                # never skip an authorizer that was given)
                verb, resource, ns, name, _ = self._request_info(method)
                decision, reason = server.authorizer.authorize(AuthzAttributes(
                    user=self._user if self._user is not None else ANONYMOUS, verb=verb,
                    resource=resource, namespace=ns, name=name, path=path))
                if decision != ALLOW:
                    self._error(403, "Forbidden", reason)
                    return False
            if self._user is not None:
                store.user = self._user.name
            return True

        def _route(self, method: str) -> None:
            self.server.begin_request(self.connection)
            start = time.perf_counter()
            metrics.request_count.inc()
            length = int(self.headers.get("Content-Length") or 0)
            # read the whole body up front: a connection kept alive must not
            # find an unread body where its next request line should be
            self._raw = self.rfile.read(length) if length else b""
            self._parsed = None
            self._url = urlparse(self.path)
            self._q = parse_qs(self._url.query)
            # every request starts with no identity, for the admission
            # plugins (thread-local on an AdmittedStore) and the audit: a
            # connection kept alive never carries one request's into the next
            store.user = ""
            self._user: Optional[UserInfo] = None
            self._audit_user: Optional[str] = None
            self._info: Optional[tuple[str, str, str, str, str]] = None
            self._last_code = 0
            # max in flight, before the auth filters: a request over the cap
            # is answered 429 at once (queueing under overload only turns
            # it into latency).  A watch is exempt (maxinflight.go's
            # long-running check, judged from the parsed query, so no other
            # parameter can opt out): held streams must not starve short
            # requests.  The TLS handshake ran before this, in the same
            # thread, and holds no slot.
            acquired = False
            if server._inflight is not None and self._q.get("watch", ["false"])[0] != "true":
                acquired = server._inflight.acquire(blocking=False)
                if not acquired:
                    return self._error(429, "TooManyRequests", "server overloaded (max in flight)")
            try:
                self._count_request(method)
                if self._auth_filters(method):
                    self._dispatch(method)
            except AdmissionDenied as e:
                self._error(403, "Forbidden", str(e))
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
                if acquired:
                    server._inflight.release()
                metrics.request_latency.observe((time.perf_counter() - start) * 1e6)
                if server.auditor is not None:
                    self._audit("ResponseComplete", self._last_code)

        def _count_request(self, method: str) -> None:
            verb, resource, _, _, sub = self._request_info(method)
            metrics.requests.inc(verb, f"{resource}/{sub}" if sub else resource)

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
            url, q = self._url, self._q
            path = url.path

            if path == "/telemetry":
                return self._serve_telemetry(method)
            shared = handle_debug_path(path, server.registry)
            if shared is not None:
                if method != "GET":
                    return self._error(405, "MethodNotAllowed", method)
                code, payload = shared
                if isinstance(payload, str):
                    return self._send_bytes(code, payload.encode(), "text/plain")
                return self._send(code, payload)
            if path in ("/api", "/api/v1", "/apis"):
                if method != "GET":
                    return self._error(405, "MethodNotAllowed", method)
                return self._serve_discovery(path)
            if path in ("/openapi/v2", "/swagger.json"):
                # the published schema (routes/openapi.go; the era also
                # served /swagger.json), built per request from the live
                # registry so a kind registered later appears at once
                if method != "GET":
                    return self._error(405, "MethodNotAllowed", method)
                return self._send(200, build_openapi())
            if path == "/version":
                return self._send(200, {"version": __version__})
            if path == SSAR_PATH:
                if method != "POST":
                    return self._error(405, "MethodNotAllowed", method)
                return self._serve_ssar()
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
                if not self._admission_gate(res, self._body().get("items", [])):
                    return
                items = [convert_to_internal(d) for d in self._body().get("items", [])]
                if kind in CLUSTER_SCOPED_KINDS:
                    for d in items:
                        d.setdefault("metadata", {})["namespace"] = ""
                # the bodies were parsed for this request: the store may keep them
                return self._send(201, {"items": store.create_many(kind, items, _trusted=True)})

            parts = [p for p in path.split("/") if p]
            if len(parts) >= 2 and parts[0] == "apis":
                return self._proxy_aggregated(method, parts[1], url)
            if len(parts) < 3 or parts[0] != "api" or parts[1] != "v1":
                return self._error(404, "NotFound", f"no route for {path}")
            parts = parts[2:]

            # node proxy: /api/v1/nodes/{name}/proxy/<kubelet path>, the
            # path the HPA's metrics client scrapes kubelet stats through
            if len(parts) >= 4 and parts[0] == "nodes" and parts[2] == "proxy" and method == "GET":
                return self._proxy_node(parts[1], "/".join(parts[3:]), url.query)

            # collection: /api/v1/{resource}
            if len(parts) == 1:
                kind = kind_for_plural(parts[0])
                if kind is None:
                    return self._error(404, "NotFound", f"unknown resource {parts[0]}")
                if method == "GET":
                    return self._serve_list(kind, q.get("namespace", [None])[0], q)
                if method == "POST":
                    if not self._admission_gate(parts[0], [self._body()]):
                        return
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
                    if not self._admission_gate(parts[2], [self._body()]):
                        return
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
                if parts[4] == "eviction" and kind == "Pod" and method == "POST":
                    # pods/eviction: a delete every PodDisruptionBudget
                    # selecting the pod must allow (eviction.go)
                    try:
                        PodClient(store).evict(name, ns)
                    except EvictionDisallowed as e:
                        return self._error(429, "TooManyRequests", str(e))
                    return self._send(201, {"status": "evicted"})
                if kind == "Pod":
                    if parts[4] == "log" and method == "GET":
                        return self._proxy_pod_log(ns, name, q)
                    if parts[4] == "exec" and method == "POST":
                        return self._proxy_pod_exec(ns, name, q)
                    if parts[4] == "attach" and method == "GET":
                        return self._proxy_pod_simple(ns, name, q, "attach", "attach stream")
                    if parts[4] == "cp":
                        return self._proxy_pod_cp(ns, name, q, method)
                return self._error(404, "NotFound", f"unknown subresource {parts[4]}")
            if method == "GET":
                return self._send(200, store.get(kind, ns, name))
            if method == "PUT":
                return self._send(200, store.update(kind, convert_to_internal(self._body()),
                                                    _trusted=True))
            if method == "PATCH":
                return self._serve_patch(kind, ns, name)
            if method == "DELETE":
                return self._send(200, store.delete(kind, ns, name))
            return self._error(405, "MethodNotAllowed", method)

        def _serve_patch(self, kind: str, ns: str, name: str) -> None:
            """PATCH (reference ``handlers/rest.go`` PatchResource): the patch
            type comes from the Content-Type, and the patch applies on the
            server under the store's CAS loop, so concurrent writers never
            lose an update.  An unknown type answers 415 (a mislabeled
            body is never merged as if it were one), a patch that cannot
            apply 422."""
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            patch_type = CONTENT_TYPES.get(ctype)
            if patch_type is None:
                return self._error(415, "UnsupportedMediaType",
                                   f"patch content type {ctype!r}; want one of "
                                   f"{sorted(CONTENT_TYPES)}")
            patch_doc = self._body()
            gv = patch_doc.get("apiVersion", "") if isinstance(patch_doc, dict) else ""

            def mutate(cur: dict) -> dict:
                if gv:
                    # a versioned patch applies in wire space: encode the
                    # stored hub object to the spoke, patch, decode back,
                    # so nested wire keys land where the conversion puts
                    # them (the reference patches the versioned object)
                    return convert_to_internal(
                        apply_patch(convert_from_internal(cur, gv), patch_doc, patch_type))
                return apply_patch(cur, patch_doc, patch_type)

            try:
                out = store.guaranteed_update(kind, ns, name, mutate)
            except NotFoundError:
                raise  # a KeyError, but the object's absence: 404 by _route
            except (KeyError, IndexError, ValueError, TypeError) as e:
                return self._error(422, "Invalid", f"cannot apply patch: {e}")
            return self._send(200, out)

        def _serve_ssar(self) -> None:
            """SelfSubjectAccessReview: may the CALLING identity do this?
            Answered by the live authorizer (reference
            ``pkg/registry/authorization/selfsubjectaccessreview``); the
            spec names only the action, never the user."""
            attrs = (self._body().get("spec") or {}).get("resourceAttributes") or {}
            if server.authorizer is None:
                return self._send(201, {"status": {"allowed": True,
                                                   "reason": "no authorizer configured"}})
            decision, reason = server.authorizer.authorize(AuthzAttributes(
                user=self._user if self._user is not None else ANONYMOUS,
                verb=attrs.get("verb", ""), resource=attrs.get("resource", ""),
                namespace=attrs.get("namespace", ""), name=attrs.get("name", "")))
            return self._send(201, {"status": {"allowed": decision == ALLOW,
                                               "reason": reason}})

        def _serve_discovery(self, path: str) -> None:
            """``/api`` lists the versions, ``/api/v1`` the resources of the
            live type registry, ``/apis`` the aggregated groups with
            whether any APIService of each was last seen available
            (reference ``endpoints/discovery``)."""
            if path == "/api":
                return self._send(200, {"kind": "APIVersions", "versions": ["v1"]})
            if path == "/api/v1":
                resources = [{"name": plural, "kind": kind,
                              "namespaced": kind not in CLUSTER_SCOPED_KINDS}
                             for kind, plural in sorted(KIND_PLURALS.items())]
                return self._send(200, {"kind": "APIResourceList", "groupVersion": "v1",
                                        "resources": resources})
            by_group: dict[str, bool] = {}
            for svc in store.list("APIService", "")[0]:
                g = (svc.get("spec") or {}).get("group", "")
                if g:
                    by_group[g] = by_group.get(g, False) or bool(
                        (svc.get("status") or {}).get("available"))
            return self._send(200, {"kind": "APIGroupList", "groups": [
                {"name": g, "available": a} for g, a in sorted(by_group.items())]})

        # -- aggregation (kube-aggregator) ---------------------------------
        def _lookup_apiservice(self, group: str) -> Optional[dict]:
            """The APIService named ``group``, else the first whose
            ``spec.group`` is ``group`` (the reference names them
            ``<version>.<group>``)."""
            try:
                return store.get("APIService", "", group)
            except NotFoundError:
                pass
            for svc in store.list("APIService", "")[0]:
                if (svc.get("spec") or {}).get("group") == group:
                    return svc
            return None

        def _mark_available(self, svc: dict, available: bool) -> None:
            """The availability condition, from the proxy's own outcomes (the
            reference's availability controller folded into the proxy).
            Best effort: the next proxied request observes it again."""
            name = (svc.get("metadata") or {}).get("name", "")
            if bool((svc.get("status") or {}).get("available")) == available:
                return

            def mark(d: dict) -> dict:
                d.setdefault("status", {})["available"] = available
                return d

            try:
                store.guaranteed_update("APIService", "", name, mark)
            except Exception as e:  # noqa: BLE001 - advisory status; counted
                logger.debug("APIService %s availability update failed: %s", name, e)
                metrics.apiservice_status_failures.inc()

        # -- the kubelet proxies --------------------------------------------
        def _resolve_pod_kubelet(self, ns: str, name: str, q):
            """Pod -> node -> kubelet endpoint and a container of the pod,
            after the CONNECT admission (``DenyEscalatingExec`` runs here).
            Returns (kubelet_url, container, node_name), or None once the
            error is written."""
            try:
                pod = store.get("Pod", ns, name)
            except NotFoundError:
                self._error(404, "NotFound", f"pod {ns}/{name}")
                return None
            chain = getattr(store, "chain", None)
            if chain is not None:
                from ..admission.framework import Attributes

                try:
                    chain.run(Attributes(operation="CONNECT", kind="Pod", namespace=ns,
                                         name=name, old_obj=pod,
                                         user=getattr(store, "user", "")))
                except AdmissionDenied as e:
                    self._error(403, "Forbidden", str(e))
                    return None
            node_name = (pod.get("spec") or {}).get("nodeName", "")
            if not node_name:
                self._error(400, "BadRequest", "pod is not scheduled yet")
                return None
            try:
                node = store.get("Node", "", node_name)
            except NotFoundError:
                self._error(502, "BadGateway", f"node {node_name} not found")
                return None
            kubelet_url = (node.get("status") or {}).get("kubeletURL", "")
            if not kubelet_url:
                self._error(502, "BadGateway", f"node {node_name} exposes no kubelet endpoint")
                return None
            known = [c.get("name", "") for c in (pod.get("spec") or {}).get("containers") or []]
            container = q.get("container", [None])[0] or (known[0] if known else "")
            if container not in known:
                # also keeps a crafted name from reaching another kubelet path
                self._error(400, "BadRequest", f"container {container!r} not in pod {ns}/{name}")
                return None
            return kubelet_url, container, node_name

        def _relay(self, req, timeout: float, what: str, ctype: str) -> None:
            """Send ``req`` to a kubelet and answer with what it returned:
            its own error status passes through, an unreachable kubelet is
            502."""
            try:
                with _PROXY_OPENER.open(req, timeout=timeout) as resp:
                    data = resp.read()
            except urllib.error.HTTPError as e:
                return self._error(e.code, "KubeletError", e.read().decode()[:200])
            except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
                return self._error(502, "BadGateway", f"kubelet {what} failed: {e}")
            self._send_bytes(200, data, ctype)

        def _proxy_pod_log(self, ns: str, name: str, q) -> None:
            """pods/log: the kubelet's /containerLogs (the reference's
            LogREST)."""
            resolved = self._resolve_pod_kubelet(ns, name, q)
            if resolved is None:
                return
            kubelet_url, container, _ = resolved
            target = f"{kubelet_url}/containerLogs/{ns}/{name}/{container}"
            if "tailLines" in q:
                tail = q["tailLines"][0]
                if not tail.isdigit():
                    return self._error(400, "BadRequest", "tailLines must be an integer")
                target += f"?tailLines={tail}"
            try:
                with _PROXY_OPENER.open(target, timeout=10) as resp:
                    data = resp.read()
            except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
                return self._error(502, "BadGateway", f"kubelet log fetch failed: {e}")
            self._send_bytes(200, data, "text/plain")

        def _proxy_pod_simple(self, ns: str, name: str, q, endpoint: str, what: str) -> None:
            """A GET pod subresource passed to the kubelet as it is (attach,
            the reference's AttachREST)."""
            resolved = self._resolve_pod_kubelet(ns, name, q)
            if resolved is None:
                return
            kubelet_url, container, _ = resolved
            self._relay(f"{kubelet_url}/{endpoint}/{ns}/{name}/{container}", 10, what,
                        "text/plain")

        def _proxy_pod_cp(self, ns: str, name: str, q, method: str) -> None:
            """pods/cp: a file read (GET) or write (PUT) in the container,
            through the kubelet's file API under the exec credential (the
            reference streams tar over exec: the same capability)."""
            from urllib.parse import quote

            resolved = self._resolve_pod_kubelet(ns, name, q)
            if resolved is None:
                return
            kubelet_url, container, node_name = resolved
            path = q.get("path", [""])[0]
            if not path:
                return self._error(400, "BadRequest", "path required")
            target = f"{kubelet_url}/cp/{ns}/{name}/{container}?path={quote(path)}"
            # both directions carry the exec credential: reading a file is
            # an exec-class capability on the kubelet too
            auth = {"Authorization": f"Bearer {kubelet_exec_token(node_name)}"}
            if method == "GET":
                req = urllib.request.Request(target, headers=auth)
            elif method == "PUT":
                # the body was read whole before routing: reading rfile again
                # would wait on a kept-alive connection's next request
                req = urllib.request.Request(target, data=self._raw, method="PUT", headers=auth)
            else:
                return self._error(405, "MethodNotAllowed", method)
            self._relay(req, 30, "cp", "application/octet-stream")

        def _proxy_pod_exec(self, ns: str, name: str, q) -> None:
            """pods/exec: the command to the kubelet's exec endpoint under
            the cluster-key exec token (the SPDY exec path's capability, as
            JSON)."""
            resolved = self._resolve_pod_kubelet(ns, name, q)
            if resolved is None:
                return
            kubelet_url, container, node_name = resolved
            command = self._body().get("command")
            if not isinstance(command, list) or not command:
                return self._error(400, "BadRequest", "command (list) required")
            req = urllib.request.Request(
                f"{kubelet_url}/exec/{ns}/{name}/{container}",
                data=json.dumps({"command": command}).encode(),
                headers={"Content-Type": "application/json",
                         "Authorization": f"Bearer {kubelet_exec_token(node_name)}"},
                method="POST")
            self._relay(req, 30, "exec", "application/json")

        def _proxy_node(self, name: str, subpath: str, query: str = "") -> None:
            """A GET to the node's kubelet read API, path and query as
            given: over the node's tunnel when the tunneler holds one (a
            node need not be routable, pkg/master/tunneler), else at its
            ``status.kubeletURL``."""
            try:
                node = store.get("Node", "", name)
            except NotFoundError:
                return self._error(404, "NotFound", f'node "{name}" not found')
            if query:
                subpath = f"{subpath}?{query}"
            tun = server.tunneler
            if tun is not None and tun.has(name):
                if not tun.healthy(name):
                    return self._error(502, "BadGateway", f'tunnel to node "{name}" is down')
                try:
                    status, data, ctype = tun.request(name, "GET", f"/{subpath}")
                except (OSError, http.client.HTTPException) as e:
                    # a kubelet dying mid-answer is a gateway failure
                    return self._error(502, "BadGateway", f"tunnel request failed: {e}")
                if status != 200:
                    return self._error(status, "KubeletError",
                                       data.decode(errors="replace")[:200])
                return self._send_bytes(200, data, ctype)
            kubelet_url = (node.get("status") or {}).get("kubeletURL") or ""
            if not kubelet_url:
                return self._error(502, "BadGateway", f'node "{name}" has no kubelet endpoint')
            try:
                with _PROXY_OPENER.open(f"{kubelet_url}/{subpath}", timeout=10) as resp:
                    data = resp.read()
                    ctype = resp.headers.get("Content-Type", "application/json")
            except urllib.error.HTTPError as e:
                return self._error(e.code, "KubeletError", e.read().decode()[:200])
            except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
                return self._error(502, "BadGateway", f"kubelet proxy failed: {e}")
            self._send_bytes(200, data, ctype)

        def _proxy_aggregated(self, method: str, group: str, url) -> None:
            """``/apis/<group>/...`` to the backend its APIService names
            (``kube-aggregator``'s proxy handler).  Identity crosses only as
            the front-proxy headers ``X-Remote-User``/``X-Remote-Group``:
            the client's ``Authorization`` is never forwarded (it would hand
            a bearer token to whoever registered the APIService).  An
            unregistered group answers 404, a backend that cannot be
            reached 502; the backend's own status codes pass through, and a
            chunked answer (a watch) streams chunk by chunk."""
            svc = self._lookup_apiservice(group)
            if svc is None:
                return self._error(404, "NotFound", f"no APIService for group {group!r}")
            base = (svc.get("spec") or {}).get("url", "")
            if not base:
                return self._error(503, "ServiceUnavailable",
                                   f"APIService {group} has no backend")
            is_watch = parse_qs(url.query).get("watch", ["false"])[0] == "true"
            req = urllib.request.Request(
                base.rstrip("/") + url.path + (f"?{url.query}" if url.query else ""),
                data=self._raw or None, method=method)
            for h in ("Content-Type", "Accept"):
                if self.headers.get(h):
                    req.add_header(h, self.headers[h])
            if self._user is not None and self._user.name:
                req.add_header("X-Remote-User", self._user.name)
                if self._user.groups:
                    req.add_header("X-Remote-Group", ",".join(self._user.groups))
            try:
                resp = _PROXY_OPENER.open(
                    req, timeout=PROXY_WATCH_TIMEOUT_S if is_watch else PROXY_TIMEOUT_S)
            except urllib.error.HTTPError as e:
                return self._send_bytes(e.code, e.read(),
                                        e.headers.get("Content-Type", "application/json"))
            except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
                self._mark_available(svc, False)
                return self._error(502, "BadGateway", f"APIService {group} backend error: {e}")
            self._mark_available(svc, True)
            with resp:
                self._last_code = resp.status
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 resp.headers.get("Content-Type", "application/json"))
                # once the answer has started, a failure may only close the
                # stream: a second status line would corrupt it
                try:
                    if resp.headers.get("Transfer-Encoding", "") == "chunked":
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        while chunk := resp.read1(65536):
                            self._write_chunk(chunk)
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        data = resp.read()
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                except OSError:
                    self.close_connection = True

        def _serve_list(self, kind: str, namespace: Optional[str], q: dict) -> None:
            """LIST, or the watch upgrade with ``watch=true``."""
            pred, err = compile_selectors(q)
            if err is not None:
                return self._error(400, "BadRequest", err)
            if q.get("watch", ["false"])[0] == "true":
                return self._serve_watch(kind, namespace, pred, q)
            if q.get("columnar", ["0"])[0] in ("1", "true") and pred is None:
                # the packed column batch (store/columns.py), for the kinds
                # that have one; selector LISTs take the item path
                batch = store.list_columns(kind, namespace)
                if batch is not None:
                    return self._send(200, batch.to_wire())
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
            # ?frames=1: one line a correlated batch txn (a WatchFrame,
            # filtered at the column level under a selector)
            want_frames = q.get("frames", ["0"])[0] in ("1", "true")
            # an expired revision raises here, before any byte is sent: 410
            watch = store.watch(kind, from_revision=from_rev, frames=want_frames)
            try:
                self._last_code = 200
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
                    lines = []
                    for e in batch:
                        if e.type == FRAME:
                            frame = e if pred is None else e.select(
                                [i for i, o in enumerate(e.objects) if o is not None and pred(o)])
                            if frame is not None:
                                lines.append(frame.wire_bytes())
                        elif pred is None or pred(e.object):
                            lines.append(event_wire_bytes(e))
                    if lines:
                        self._write_chunk(b"".join(lines))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # the watcher went away
            finally:
                watch.stop()

    return Handler
