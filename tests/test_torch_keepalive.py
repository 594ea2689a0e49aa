"""Kept-alive connections between the port's ``RemoteStore`` and the port's
apiserver, on the CPU.

The port's client sends a thread's requests on one connection while the
server's answers say ``Connection: keep-alive``; the reference package's
server says nothing of the kind (it reads one request body a connection),
so the port's client opens a connection a request there, as the JAX
client does everywhere.  A stopped server closes the connections that
wait for a request, and a connection the server closed while it was idle
never carries a write: the next request opens a new one.
"""

from __future__ import annotations

import importlib
import socket
import threading

import pytest

PKG = {"port": "kubernetes_tpu_torch", "jax": "kubernetes_tpu"}


def _server(pkg: str, port: int = 0):
    srv = importlib.import_module(f"{PKG[pkg]}.apiserver")
    store = importlib.import_module(f"{PKG[pkg]}.store")
    server = srv.APIServer(store.Store(), port=port)
    accepted = []
    inner = server.httpd.process_request

    def counting(request, client_address):
        accepted.append(client_address)
        inner(request, client_address)

    server.httpd.process_request = counting
    server.start()
    return server, accepted


def _pod(name: str) -> dict:
    from kubernetes_tpu_torch import testutil

    return testutil.make_pod(name).to_dict()


def _cas_sequence(rs, errors) -> dict:
    """Create, two reads, one update that lands and one that conflicts (a
    409 answered to a request with a body), then a read: each on the same
    thread's connection where the server keeps it alive."""
    rs.create("Pod", _pod("p1"))
    a = rs.get("Pod", "default", "p1")
    b = rs.get("Pod", "default", "p1")
    a["metadata"]["annotations"] = {"x": "1"}
    rs.update("Pod", a, expect_rev=int(a["metadata"]["resourceVersion"]))
    b["metadata"]["annotations"] = {"x": "2"}
    with pytest.raises(errors.ConflictError):
        rs.update("Pod", b, expect_rev=int(b["metadata"]["resourceVersion"]))
    return rs.get("Pod", "default", "p1")


@pytest.mark.timeout(60)
def test_requests_share_one_kept_alive_connection():
    from kubernetes_tpu_torch.apiserver import server as server_mod
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.store import store as errors

    server, accepted = _server("port")
    try:
        rs = RemoteStore(server.url)
        got = _cas_sequence(rs, errors)
        assert got["metadata"]["annotations"] == {"x": "1"}
        assert rs.list("Pod")[0][0]["metadata"]["name"] == "p1"
        # seven requests, one connection; the listen backlog is a Go
        # listener's, not socketserver's 5
        assert len(accepted) == 1
        assert server.httpd.request_queue_size == server_mod.LISTEN_BACKLOG
    finally:
        server.stop()


@pytest.mark.timeout(60)
def test_port_client_opens_a_connection_a_request_on_the_jax_server():
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.store import store as errors

    server, accepted = _server("jax")
    try:
        rs = RemoteStore(server.url)
        got = _cas_sequence(rs, errors)
        assert got["metadata"]["annotations"] == {"x": "1"}
        assert len(accepted) == 6  # no keep-alive said: one a request
    finally:
        server.stop()


@pytest.mark.timeout(60)
def test_stopped_server_answers_nothing_on_a_kept_alive_connection():
    from kubernetes_tpu_torch.client.remote import RemoteStore, RetryExhaustedError

    server, accepted = _server("port")
    rs = RemoteStore(server.url, timeout=5.0, max_retries=0)
    rs.create("Pod", _pod("p1"))
    conn = rs._local.conn
    server.stop()
    # the server shut the idle connection: it reads as ended at once
    conn.sock.settimeout(5.0)
    assert conn.sock.recv(1) == b""
    with pytest.raises(RetryExhaustedError):
        rs.get("Pod", "default", "p1")
    assert len(accepted) == 1


@pytest.mark.timeout(60)
def test_a_write_after_a_restart_goes_out_on_a_new_connection():
    """The server on the same port stops and a new one starts: the kept-
    alive connection to the old one is dropped before the POST would be
    written on it (a POST on a dead connection could not be retried)."""
    from kubernetes_tpu_torch.client.remote import RemoteStore

    first, accepted_first = _server("port")
    port = first.port
    rs = RemoteStore(first.url, max_retries=0)
    rs.create("Pod", _pod("p1"))
    first.stop()
    second, accepted_second = _server("port", port=port)
    try:
        rs.create("Pod", _pod("p2"))
        names = [p["metadata"]["name"] for p in rs.list("Pod")[0]]
        assert names == ["p2"]
        assert (len(accepted_first), len(accepted_second)) == (1, 1)
    finally:
        second.stop()


@pytest.mark.timeout(60)
def test_a_connection_another_process_opened_is_left_to_it():
    """After a fork the child holds its parent's connection object: it
    opens its own and leaves the parent's socket open (the pid the
    connection was opened under stands in for the fork here)."""
    from kubernetes_tpu_torch.client.remote import RemoteStore

    server, accepted = _server("port")
    try:
        rs = RemoteStore(server.url)
        rs.create("Pod", _pod("p1"))
        parents = rs._local.conn
        rs._local.pid = -1  # as a forked child sees it
        assert rs.get("Pod", "default", "p1")["metadata"]["name"] == "p1"
        assert rs._local.conn is not parents
        assert parents.sock is not None and parents.sock.fileno() >= 0
        assert len(accepted) == 2
        parents.close()
    finally:
        server.stop()


@pytest.mark.timeout(60)
def test_each_thread_keeps_a_connection_of_its_own():
    from kubernetes_tpu_torch.client.remote import RemoteStore

    server, accepted = _server("port")
    try:
        rs = RemoteStore(server.url)
        errors: list = []

        def work(i: int) -> None:
            try:
                rs.create("Pod", _pod(f"p{i}"))
                for _ in range(5):
                    assert rs.get("Pod", "default", f"p{i}")["metadata"]["name"] == f"p{i}"
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert len(rs.list("Pod")[0]) == 4
        assert len(accepted) == 5  # four threads and this one
    finally:
        server.stop()


@pytest.mark.timeout(60)
def test_an_answer_without_keep_alive_closes_the_connection():
    """A request that asks for ``Connection: close`` is not told to keep
    the connection alive, and the port's server closes it after the
    answer."""
    server, _ = _server("port")
    try:
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        head = data.split(b"\r\n\r\n", 1)[0].lower()
        assert b"200" in head.split(b"\r\n", 1)[0]
        assert b"connection: keep-alive" not in head
        with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            head = s.recv(65536).split(b"\r\n\r\n", 1)[0].lower()
        assert b"connection: keep-alive" in head
    finally:
        server.stop()
