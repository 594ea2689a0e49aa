"""Remote store: the ``Store`` interface spoken over HTTP to an apiserver.

``Clientset(RemoteStore(url))`` behaves like an in-process clientset:
informers, the scheduler and the leader lock run unchanged against a
network apiserver (the reference's ``client-go/rest`` under the generated
clientsets).  It speaks the wire of ``kubernetes_tpu_torch.apiserver`` and
of the reference package's apiserver alike: JSON bodies, ``kind: Status``
error bodies, and watches as chunked JSON lines (``type``, ``kind``,
``key``, ``revision``, ``object``) resumable by ``resourceVersion``.

Failure handling (``client-go/rest`` request retry + ``reflector.go``
relist):

- every request classifies its failure: transport errors, 5xx and 429 are
  retried with exponential backoff and seeded jitter within
  ``max_retries`` (a non-idempotent verb only when the request provably
  never reached the server); any other status is fatal and maps to the
  store's typed errors;
- a watch stream that breaks reconnects from its last revision with its
  own backoff; a resume refused with **410 Gone** cannot heal itself, so
  the watch emits a :data:`~..store.store.WATCH_GAP` event and ends, and
  the informer above relists;
- ``RemoteWatch.stop()`` shuts the stream's socket down, which unblocks
  the reader thread at once.

``watch(frames=True)`` asks for ``?frames=1``: a ``create_many``/
``bind_many`` txn arrives as one ``WatchFrame`` line, fenced by its last
revision; a frame line whose columns are broken loses its events as a
unit, so the watch emits ``WATCH_GAP`` and ends, as on a 410.
``watch(label_selector=, field_selector=)`` filters on the server; with
frames a txn arrives as the sub-frame of its matching entries.
``list_columns`` is the ``?columnar=1`` LIST.  A write an admission
plugin denies raises ``ForbiddenError`` (HTTP 403).

``https://`` servers are spoken to over TLS with one ``SSLContext`` a
store (``ca_file`` pins the server's CA; ``client_cert``/``client_key``
present a client identity, the kubeconfig's certificate-authority and
client-certificate), for requests and watch streams alike.  A refused
certificate (the server's chain does not verify, or the server refused
ours) is fatal at once: no retry can make it verify.

A request goes out on its thread's connection, kept alive from one
request to the next (``client-go``'s pooled transport) when the server's
answer says ``Connection: keep-alive``, as the port's apiserver does; any
other server gets a connection a request, as before.  An idle connection
the server has closed is dropped before a request would be sent on it, so
a write never lands on a dead connection it could not safely be retried
from.  Watch streams hold connections of their own.

``binary=True`` negotiates the binary wire form (``api/wire.py``,
``application/vnd.ktpu.binary``): request bodies go in it, and the
``Accept`` header asks for it back; an answer is decoded by its
Content-Type, so a JSON answer still reads.  ``patch`` is the server-side
PATCH verb in its three patch types (``api/patch.py``).

Every failure path bumps a counter of ``utils.metrics.ClientMetrics``."""

from __future__ import annotations

import http.client
import io
import ipaddress
import json
import logging
import os
import queue as queue_mod
import random
import select
import socket
import ssl
import threading
import time
import urllib.error
from typing import Callable, Optional
from urllib.parse import quote, urlsplit

from .. import faults
from ..api import wire
from ..api.patch import CONTENT_TYPES
from ..api.types import KIND_PLURALS
from ..store.frames import FRAME, WatchFrame
from ..store.store import (
    WATCH_GAP,
    AlreadyExistsError,
    ConflictError,
    ExpiredRevisionError,
    NotFoundError,
    WatchEvent,
)
from ..utils import tracing
from ..utils.metrics import ClientMetrics

logger = logging.getLogger("kubernetes_tpu_torch.client.remote")

# the server ends each watch stream after this long and the watch resumes
# from its last revision: a dead peer is noticed within it
WATCH_TIMEOUT_S = 5
# exponential backoff between request retries and watch reconnects
BACKOFF_MIN_S = 0.05
BACKOFF_MAX_S = 2.0


class RemoteError(Exception):
    pass


class ForbiddenError(RemoteError):
    """HTTP 403: authorization said no."""


class RetryExhaustedError(RemoteError):
    """A retryable failure outlived the retry budget; the message carries
    the last underlying error."""


class WatchStatusError(RemoteError):
    """A watch request answered with a status other than 200."""

    def __init__(self, code: int, body: bytes, headers):
        super().__init__(f"watch answered {code}: {body[:200]!r}")
        self.code = code
        self.headers = headers


# statuses worth retrying: the server never started (or refused to start)
# the work.  Any other 4xx means the request itself is wrong.
RETRYABLE_STATUS = frozenset({429, 500, 502, 503, 504})


def _raise_for_status(body: dict) -> None:
    if body.get("kind") != "Status":
        return
    code, msg = body.get("code"), body.get("message", "")
    if code == 404:
        raise NotFoundError(msg)
    if code == 403:
        raise ForbiddenError(msg)
    if code == 409:
        if body.get("reason") == "AlreadyExists":
            raise AlreadyExistsError(msg)
        raise ConflictError(msg)
    if code == 410:
        raise ExpiredRevisionError(msg)
    raise RemoteError(f"{code}: {msg}")


def _parse_retry_after(headers) -> Optional[float]:
    """A 429/503 response's backoff hint, delta-seconds form only (RFC 7231
    7.1.3); None when there is no usable hint."""
    value = headers.get("Retry-After") if headers is not None else None
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return None


def tls_refused(e: BaseException) -> bool:
    """Did the TLS handshake refuse a certificate (ours or the server's)?
    Deterministic: a retry would be refused the same way.  A connection
    dropped mid-handshake is not a refusal."""
    reason = e.reason if isinstance(e, urllib.error.URLError) else e
    return isinstance(reason, ssl.SSLError) and not isinstance(
        reason, (ssl.SSLEOFError, ssl.SSLZeroReturnError, ssl.SSLSyscallError))


def _dropped(sock) -> bool:
    """Has the server closed this idle connection?  An idle socket that
    polls readable holds an end of stream (or bytes no request asked
    for): either way it must not carry the next request."""
    if sock is None:
        return False  # closed on our side: http.client opens a new one
    try:
        poller = select.poll()
        poller.register(sock, select.POLLIN)
        return bool(poller.poll(0))
    except (OSError, ValueError):
        return True


class _Stream:
    """One open watch response and the connection that carries it."""

    def __init__(self, conn: http.client.HTTPConnection, resp: http.client.HTTPResponse):
        self.conn = conn
        self.resp = resp

    def close(self) -> None:
        # shutdown, not just close: a reader blocked in recv on this socket
        # returns at once (close alone leaves it blocked until the peer
        # writes or the server-side timeout ends the stream).  On an
        # SSLSocket this shuts the raw socket down, and a reader blocked in
        # SSL_read sees the end of the stream just the same
        sock = self.conn.sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already disconnected: nothing left to unblock
        self.conn.close()


class RemoteWatch:
    """Chunked-stream consumer with reconnect from the last revision.

    The read loop classifies its failures:

    - **410 Gone** on resume: the server's event-log window slid past the
      bookmark and no reconnect can recover the lost deltas.  Emit
      ``WATCH_GAP`` and end; the informer relists and builds a new watch.
    - **a broken frame** (a ``frames=1`` line that parsed as JSON but whose
      columns do not hold together): its events are lost as a unit and
      the bookmark cannot be trusted past it.  The same as a 410:
      ``WATCH_GAP`` and end, never a partial apply.
    - **stopped**: clean shutdown.
    - anything else (reset, timeout, truncated line, 5xx on reconnect):
      transient.  Count it, back off exponentially (honoring a 429/503
      ``Retry-After``), reconnect from ``resourceVersion=last seen``.  The
      backoff resets once events flow again.
    """

    def __init__(self, resource: str, from_revision: Optional[int],
                 opener: Callable[[str], _Stream], metrics: ClientMetrics,
                 sleep: Callable[[float], None] = time.sleep, frames: bool = False,
                 label_selector: Optional[str] = None, field_selector: Optional[str] = None):
        self._resource = resource
        self._frames = frames
        # a selector watch: the server filters events, and frames at the
        # column level (a matching sub-frame); every reconnect keeps them
        self._label_selector = label_selector
        self._field_selector = field_selector
        self._opener = opener
        self.metrics = metrics
        self._sleep = sleep
        # unbounded by design: the consumer (an informer) drains it
        self._queue: "queue_mod.Queue[Optional[WatchEvent]]" = queue_mod.Queue()
        self._stopped = threading.Event()
        self._last_rev = from_revision
        # the open stream: set by the reader thread, shut by stop()
        self._stream_mu = threading.Lock()
        self._stream: Optional[_Stream] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"remote-watch-{resource}")
        self._thread.start()

    def _path(self) -> str:
        path = f"/api/v1/{self._resource}?watch=true&timeoutSeconds={WATCH_TIMEOUT_S}"
        if self._frames:
            path += "&frames=1"
        if self._label_selector:
            path += f"&labelSelector={quote(self._label_selector)}"
        if self._field_selector:
            path += f"&fieldSelector={quote(self._field_selector)}"
        if self._last_rev is not None:
            path += f"&resourceVersion={self._last_rev}"
        return path

    def _connect(self) -> _Stream:
        tr = tracing.current()
        # the (re)connect is the slow, failure-prone edge of the stream:
        # one span a dial, nothing an event
        with (tr.span("remote.watch.connect", cat="client", resource=self._resource)
              if tr is not None else tracing.NULL_SPAN):
            faults.hit("remote.watch.stream", phase="connect", resource=self._resource)
            return self._opener(self._path())

    def _gap(self, cause: str) -> None:
        """The stream cannot heal itself: a gap for the informer's relist."""
        self.metrics.watch_gaps.inc()
        tr = tracing.current()
        if tr is not None:
            tr.instant("remote.watch.gap", resource=self._resource, cause=cause)
        self._queue.put(WatchEvent(WATCH_GAP, "", "", self._last_rev or 0, {}))

    def _run(self) -> None:
        backoff = BACKOFF_MIN_S
        while not self._stopped.is_set():
            stream = None
            try:
                stream = self._connect()
                with self._stream_mu:
                    if self._stopped.is_set():
                        return
                    self._stream = stream
                for raw in stream.resp:
                    if self._stopped.is_set():
                        return
                    line = raw.strip()
                    if not line:
                        continue
                    faults.hit("remote.watch.stream", phase="event", resource=self._resource)
                    self.metrics.ingest_bytes.inc(len(line))
                    t_parse = time.perf_counter()
                    d = json.loads(line)
                    if d.get("type") == FRAME:
                        try:
                            faults.hit("remote.watch.stream", phase="frame",
                                       resource=self._resource)
                            frame = WatchFrame.from_wire(d)
                            self.metrics.watch_parse_seconds.inc(time.perf_counter() - t_parse)
                        except Exception as e:  # noqa: BLE001 - a frame lost as a unit
                            logger.warning("watch %s: undecodable frame (%s: %s): emitting a "
                                           "gap for a relist", self._resource,
                                           type(e).__name__, e)
                            self.metrics.watch_errors.inc()
                            self._gap("bad-frame")
                            return
                        # the frame's fence: a replayed frame at or below
                        # the bookmark was seen already
                        if self._last_rev is not None and frame.revision <= self._last_rev:
                            continue
                        self._last_rev = frame.revision
                        backoff = BACKOFF_MIN_S
                        self._queue.put(frame)
                        continue
                    ev = WatchEvent(d["type"], d["kind"], d["key"], d["revision"], d["object"])
                    self.metrics.watch_parse_seconds.inc(time.perf_counter() - t_parse)
                    self._last_rev = ev.revision
                    backoff = BACKOFF_MIN_S  # a healthy stream resets it
                    self._queue.put(ev)
                # a clean end is the server-side timeout: resume at once
            except Exception as e:  # noqa: BLE001 - classified below
                if self._stopped.is_set():
                    return
                self.metrics.watch_errors.inc()
                code = getattr(e, "code", None)
                if code == 410:
                    logger.warning("watch %s: revision %s too old (410): emitting a gap "
                                   "for a relist", self._resource, self._last_rev)
                    self._gap("410")
                    return
                sleep_s = backoff
                if code in (429, 503):
                    hint = _parse_retry_after(getattr(e, "headers", None))
                    if hint is not None:
                        sleep_s = min(max(hint, backoff), BACKOFF_MAX_S)
                        self.metrics.retry_after_honored.inc()
                # warn on the way into a broken state; the retries of an
                # outage that persists log at debug
                log = logger.warning if backoff == BACKOFF_MIN_S else logger.debug
                log("watch %s: transient %s: %s; reconnecting from revision %s in %.2fs",
                    self._resource, type(e).__name__, e, self._last_rev, sleep_s)
                self._sleep(sleep_s)
                backoff = min(backoff * 2, BACKOFF_MAX_S)
                self.metrics.watch_reconnects.inc()
            finally:
                if stream is not None:
                    with self._stream_mu:
                        if self._stream is stream:
                            self._stream = None
                    self._close(stream)

    def _close(self, stream: _Stream) -> None:
        try:
            stream.close()
        except Exception:  # noqa: BLE001 - torn down either way; counted
            self.metrics.watch_close_errors.inc()

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self._queue.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def stop(self) -> None:
        self._stopped.set()
        with self._stream_mu:
            stream, self._stream = self._stream, None
        if stream is not None:
            self._close(stream)
        self._queue.put(None)


class RemoteStore:
    """Store-interface adapter over the REST API."""

    def __init__(self, base_url: str, token: Optional[str] = None, timeout: float = 10.0,
                 max_retries: int = 3, retry_seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 ca_file: Optional[str] = None, client_cert: Optional[str] = None,
                 client_key: Optional[str] = None, binary: bool = False):
        """``max_retries`` re-issues of a request after a retryable failure,
        with exponential backoff jittered per instance.  ``retry_seed``
        defaults to fresh entropy (a shared fixed seed would march every
        client through the same jitter); ``retry_seed`` and ``sleep`` are
        for tests.  ``ca_file`` pins the CA of an ``https://`` server and
        ``client_cert``/``client_key`` present an x509 client identity.
        ``binary=True`` negotiates the binary wire form (``api/wire.py``)
        for request bodies and answers; watch streams stay JSON lines."""
        parts = urlsplit(base_url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"RemoteStore speaks http:// or https://: {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self._prefix = parts.path.rstrip("/")
        self._host = parts.hostname
        self._port = parts.port or (443 if parts.scheme == "https" else 80)
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if parts.scheme == "https":
            self._ssl_ctx = ssl.create_default_context(cafile=ca_file)
            if ca_file:
                try:
                    ipaddress.ip_address(self._host)
                    # an IP-addressed server under a PINNED CA: the chain is
                    # still verified against it, only the name check goes
                    # (certificates rarely carry IP SANs).  Without a pinned
                    # CA the name check stays: any public certificate would
                    # pass otherwise.  DNS names are always checked.
                    self._ssl_ctx.check_hostname = False
                except ValueError:
                    pass
            if client_cert:
                self._ssl_ctx.load_cert_chain(client_cert, client_key)
        self.token = token
        self.binary = binary
        self.timeout = timeout
        self.max_retries = max_retries
        self._retry_rng = random.Random(retry_seed)
        self._sleep = sleep
        self.metrics = ClientMetrics()
        # each thread's kept-alive connection, and the process that opened
        # it (a forked child must not write on its parent's socket)
        self._local = threading.local()

    # -- http --------------------------------------------------------------
    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _new_connection(self) -> http.client.HTTPConnection:
        if self._ssl_ctx is not None:
            return http.client.HTTPSConnection(self._host, self._port, timeout=self.timeout,
                                               context=self._ssl_ctx)
        return http.client.HTTPConnection(self._host, self._port, timeout=self.timeout)

    def _connection(self) -> http.client.HTTPConnection:
        """This thread's kept-alive connection, new when there is none, when
        the server closed it while it was idle, or when it was opened by
        another process."""
        local = self._local
        conn = getattr(local, "conn", None)
        if conn is not None and (local.pid != os.getpid() or _dropped(conn.sock)):
            if local.pid == os.getpid():
                conn.close()
            conn = None
        if conn is None:
            conn = local.conn = self._new_connection()
            local.pid = os.getpid()
        return conn

    def _drop_connection(self) -> None:
        """Close this thread's connection after a failure: its state
        (a half-sent request, an unread answer) cannot carry another."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            if self._local.pid == os.getpid():
                conn.close()
            self._local.conn = None

    def _open_stream(self, path: str) -> _Stream:
        """GET ``path`` on a connection of its own and return the open
        response; a status other than 200 raises ``WatchStatusError``."""
        conn = self._new_connection()
        try:
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status != 200:
                raise WatchStatusError(resp.status, resp.read(), resp.headers)
        except BaseException:
            conn.close()
            raise
        return _Stream(conn, resp)

    @staticmethod
    def _transport_retry_safe(method: str, e: BaseException) -> bool:
        """May this transport failure be retried without running the
        request twice?  GET always; other verbs only when the error proves
        the request never reached the server (connection refused): a reset
        mid-POST may have committed, and a re-send would turn one create
        into two.  A refused certificate is never retried."""
        if tls_refused(e):
            return False
        if method == "GET":
            return True
        return isinstance(getattr(e, "reason", e), ConnectionRefusedError)

    def _retry_delay(self, attempt: int, retry_after: Optional[float] = None) -> float:
        """Exponential backoff jittered into [0.5x, 1.5x) of the nominal
        step; a server ``Retry-After`` hint (clamped to the maximum)
        replaces the step, with the same jitter."""
        if retry_after is not None:
            nominal = min(max(retry_after, 0.0), BACKOFF_MAX_S)
        else:
            nominal = min(BACKOFF_MIN_S * (2 ** attempt), BACKOFF_MAX_S)
        return nominal * (0.5 + self._retry_rng.random())

    def _request_with_retries(self, send: Callable[[], object], method: str, path: str):
        """Run ``send`` (one HTTP attempt) under the retry policy and return
        the live response.  A retryable status or transport error loops; a
        fatal ``HTTPError`` is re-raised for the caller to decode (its
        Status body says which typed error it is); an exhausted budget
        raises ``RetryExhaustedError``."""
        last_err: Optional[BaseException] = None
        retry_after: Optional[float] = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                tr = tracing.current()
                if tr is not None:
                    # each retry is latency the caller ate: a point event
                    tr.instant("remote.request.retry", method=method, path=path,
                               attempt=attempt)
                self._sleep(self._retry_delay(attempt - 1, retry_after))
                if retry_after is not None:
                    self.metrics.retry_after_honored.inc()
                retry_after = None
                self.metrics.remote_retries.inc()
            try:
                faults.hit("remote.request", method=method, path=path, attempt=attempt)
                return send()
            except urllib.error.HTTPError as e:
                if e.code not in RETRYABLE_STATUS:
                    self.metrics.remote_fatal.inc()
                    raise
                if e.code in (429, 503):
                    retry_after = _parse_retry_after(e.headers)
                try:
                    e.read()
                    e.close()
                except Exception:  # noqa: BLE001 - the retry opens a new connection; counted
                    self.metrics.remote_drain_errors.inc()
                last_err = e
                logger.warning("%s %s: retryable HTTP %d (attempt %d/%d)", method, path,
                               e.code, attempt + 1, self.max_retries + 1)
            except (urllib.error.URLError, http.client.HTTPException, OSError) as e:
                if not self._transport_retry_safe(method, e):
                    self.metrics.remote_fatal.inc()
                    raise
                last_err = e
                logger.warning("%s %s: transport error %s: %s (attempt %d/%d)", method, path,
                               type(e).__name__, e, attempt + 1, self.max_retries + 1)
        self.metrics.remote_retry_exhausted.inc()
        raise RetryExhaustedError(f"{method} {path} failed after {self.max_retries + 1} "
                                  f"attempts: {type(last_err).__name__}: {last_err}")

    def _send(self, method: str, path: str, data: Optional[bytes], headers: dict,
              timeout: Optional[float] = None) -> http.client.HTTPResponse:
        """One attempt on this thread's connection: the answer, its body
        unread; a status other than 2xx raises urllib's ``HTTPError``.
        ``timeout`` replaces the connection's own until ``_set_timeout``
        puts it back."""
        conn = self._connection()
        if timeout is not None:
            self._set_timeout(timeout)
        try:
            try:
                conn.request(method, self._prefix + path, body=data, headers=headers)
            except OSError as e:  # a failed connect or send, in urllib's form
                raise urllib.error.URLError(e) from e
            resp = conn.getresponse()
        except BaseException:
            self._drop_connection()
            raise
        if (resp.getheader("Connection") or "").lower() != "keep-alive":
            # only a server that says so reads every request body whole
            # (the reference package's reads one body a connection):
            # the answer takes the socket along and closes it once read
            self._local.conn = None
            sock, conn.sock = conn.sock, None
            if sock is not None:
                sock.close()
        if not 200 <= resp.status < 300:
            # urllib's form of an error answer, its body still unread
            raise urllib.error.HTTPError(f"{self.base_url}{path}", resp.status,
                                         resp.reason, resp.headers, resp)
        return resp

    def raw(self, method: str, path: str, body=None,
            timeout: Optional[float] = None) -> bytes:
        """Raw request carrying the store's credential and TLS context:
        the path for non-resource endpoints (discovery, /version,
        /healthz, subresource streams).  ``body`` may be a dict (sent as
        JSON) or bytes (sent as they are, e.g. file payloads through
        kubectl proxy).  The retry policy is the resource verbs'; an
        error answer raises urllib's ``HTTPError`` with its body."""
        if isinstance(body, (bytes, bytearray)):
            data = bytes(body)
            headers = {}
        else:
            data = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if data else {}
        headers.update(self._headers())

        def send():
            return self._send(method, path, data, headers, timeout)

        try:
            with self._request_with_retries(send, method, path) as resp:
                try:
                    return resp.read()
                except (http.client.HTTPException, OSError):
                    self._drop_connection()
                    raise
        except urllib.error.HTTPError as e:
            # read the body here, so the kept-alive connection is free
            raise urllib.error.HTTPError(e.url, e.code, e.msg, e.headers,
                                         io.BytesIO(e.read())) from None
        finally:
            if timeout is not None:
                self._set_timeout(self.timeout)

    def _set_timeout(self, timeout: float) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)

    def _call(self, method: str, path: str, body=None,
              content_type: Optional[str] = None) -> dict:
        """One request under the retry policy; the answer decoded by its
        Content-Type.  With ``binary`` the body goes in the binary wire
        form and the binary form is asked for back.  ``content_type``
        (a PATCH's patch type) sends the body as JSON under that type;
        the binary Accept still applies to the answer."""
        if content_type is None and self.binary:
            data = wire.encode(body) if body is not None else None
            headers = {"Content-Type": wire.CONTENT_TYPE}
        else:
            data = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": content_type or "application/json"}
        if self.binary:
            headers["Accept"] = wire.CONTENT_TYPE
        headers.update(self._headers())

        def send():
            return self._send(method, path, data, headers)

        try:
            with self._request_with_retries(send, method, path) as resp:
                try:
                    out = self._decode(resp.read(), resp.headers)
                except (http.client.HTTPException, OSError):
                    self._drop_connection()
                    raise
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                out = self._decode(raw, e.headers)
            except ValueError:
                raise RemoteError(f"{e.code}: {raw[:200]!r}") from e
            _raise_for_status(out)
            raise RemoteError(f"{e.code}: {out}") from e
        _raise_for_status(out)
        return out

    @staticmethod
    def _decode(raw: bytes, headers) -> dict:
        if wire.CONTENT_TYPE in ((headers.get("Content-Type") if headers is not None else "")
                                 or ""):
            return wire.decode(raw)
        return json.loads(raw)

    @staticmethod
    def _ns_path(namespace: str) -> str:
        return namespace if namespace else "-"

    @staticmethod
    def _resource(kind: str) -> str:
        plural = KIND_PLURALS.get(kind)
        if plural is None:
            raise RemoteError(f"unknown kind {kind}")
        return plural

    def _object_path(self, kind: str, namespace: str, name: str) -> str:
        return (f"/api/v1/namespaces/{self._ns_path(namespace)}/"
                f"{self._resource(kind)}/{name}")

    # -- Store interface ----------------------------------------------------
    # ``_trusted`` is accepted because the typed client passes it to any
    # store; over the wire every body is serialized, so it changes nothing.
    def create(self, kind: str, obj: dict, _trusted: bool = False) -> dict:
        return self._call("POST", f"/api/v1/{self._resource(kind)}", obj)

    def create_many(self, kind: str, objs: list[dict], _trusted: bool = False) -> list:
        """Batch create (``POST /api/v1/{resource}:batch``): one request and
        one server-side store txn; a slot that failed comes back None."""
        out = self._call("POST", f"/api/v1/{self._resource(kind)}:batch", {"items": objs})
        return out.get("items", [])

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._call("GET", self._object_path(kind, namespace, name))

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[str] = None,
             field_selector: Optional[str] = None) -> tuple[list[dict], int]:
        params = []
        if namespace is not None:
            params.append(f"namespace={quote(namespace)}")
        if label_selector:
            params.append(f"labelSelector={quote(label_selector)}")
        if field_selector:
            params.append(f"fieldSelector={quote(field_selector)}")
        path = f"/api/v1/{self._resource(kind)}"
        if params:
            path += "?" + "&".join(params)
        out = self._call("GET", path)
        return out["items"], int(out["resourceVersion"])

    def list_columns(self, kind: str = "Pod", namespace: Optional[str] = None):
        """Columnar LIST (``?columnar=1``): the server ships the batch's raw
        views in one response and the columns are rebuilt here.  None for
        a kind without a columnar form, or a server that answered with
        plain items."""
        # numpy's import, here only: a client that never asks for columns
        # (kubectl, a command a process) starts without it
        from ..store.columns import COLUMN_BATCH_KINDS

        batch_cls = COLUMN_BATCH_KINDS.get(kind)
        if batch_cls is None:
            return None
        path = f"/api/v1/{self._resource(kind)}?columnar=1"
        if namespace is not None:
            path += f"&namespace={quote(namespace)}"
        out = self._call("GET", path)
        if out.get("kind") != f"{kind}ColumnBatch":
            return None
        return batch_cls.from_wire(out)

    def update(self, kind: str, obj: dict, expect_rev: Optional[int] = None,
               _trusted: bool = False) -> dict:
        meta = obj.get("metadata") or {}
        if expect_rev is not None:
            obj = {**obj, "metadata": {**meta, "resourceVersion": expect_rev}}
        return self._call("PUT", self._object_path(kind, meta.get("namespace", "default"),
                                                   meta.get("name", "")), obj)

    def guaranteed_update(self, kind: str, namespace: str, name: str,
                          mutate: Callable[[dict], dict]) -> dict:
        """Read-modify-write over the wire: GET, mutate, CAS PUT, and again
        on a conflict."""
        while True:
            cur = self.get(kind, namespace, name)
            rev = int(cur["metadata"]["resourceVersion"])
            try:
                return self.update(kind, mutate(cur), expect_rev=rev)
            except ConflictError:
                continue

    def patch(self, kind: str, namespace: str, name: str, patch,
              patch_type: str = "merge") -> dict:
        """Server-side PATCH (the reference's PATCH verb): the server
        applies the patch under its CAS loop, so the client makes no
        read-modify-write round trips.  ``patch_type`` is ``merge``,
        ``strategic`` or ``json`` (``api.patch.CONTENT_TYPES``)."""
        ctype = next((c for c, t in CONTENT_TYPES.items() if t == patch_type),
                     "application/merge-patch+json")
        return self._call("PATCH", self._object_path(kind, namespace, name), patch,
                          content_type=ctype)

    def delete(self, kind: str, namespace: str, name: str) -> dict:
        return self._call("DELETE", self._object_path(kind, namespace, name))

    def bind_many(self, items: list[tuple[str, str, str]]) -> list[Optional[str]]:
        out = self._call("POST", "/api/v1/bindings:batch", {"bindings": [
            {"podNamespace": ns, "podName": name, "nodeName": node} for ns, name, node in items]})
        return out["errors"]

    def watch(self, kind: Optional[str] = None, from_revision: Optional[int] = None,
              frames: bool = False, label_selector: Optional[str] = None,
              field_selector: Optional[str] = None) -> RemoteWatch:
        if kind is None:
            raise RemoteError("a remote watch needs a kind")
        return RemoteWatch(self._resource(kind), from_revision, self._open_stream,
                           self.metrics, sleep=self._sleep, frames=frames,
                           label_selector=label_selector, field_selector=field_selector)
