"""kube-apiserver daemon (reference ``cmd/kube-apiserver/app/server.go:112``).

    python -m kubernetes_tpu_torch.apiserver [--host 127.0.0.1] [--port 6443] \
        [--event-log-window 300000] [--disable-admission] \
        [--data-dir DIR [--fsync]] \
        [--token-file tokens.csv] [--authorization-mode AlwaysAllow|RBAC] \
        [--audit-log audit.jsonl] \
        [--tls-cert-file apiserver.crt --tls-private-key-file apiserver.key \
         [--client-ca-file ca.crt]]

It starts as the JAX package's apiserver starts: the store is an
``AdmittedStore`` over ``admission.default_chain()`` unless
``--disable-admission``, and ``--data-dir`` makes it durable (a
write-ahead log and snapshots; a restart over the same directory recovers
the cluster and its revision, and the start-up log gives the recovery:
revision, records replayed, torn tail, truncated bytes).  ``--fsync``
syncs every WAL append before the write is acknowledged.

The auth flags are wired as the JAX entry point wires them.
``--token-file`` rows are ``token,user[,group1|group2]`` (the reference's
static token file); alone it authenticates those tokens and nothing else.
``--authorization-mode RBAC`` authorizes against the stored
(Cluster)Roles and (Cluster)RoleBindings, with no bootstrap grant: seed
them first (``--data-dir``); ``AlwaysAllow`` (as with no mode and no
client CA) authorizes nothing away.  ``--audit-log`` appends one JSON line a
request stage.  ``--tls-cert-file`` and ``--tls-private-key-file`` (always
together) serve HTTPS; ``--client-ca-file`` (needs TLS) verifies client
certificates, whose subject becomes the identity, keeps static and
bootstrap tokens working, lets anonymous requests through authentication
and, unless a mode is given, authorizes with ``AuthenticatedOrDiscovery``:
any authenticated identity may do anything, an anonymous one may only
read ``kube-public`` configmaps, ``/healthz`` and ``/version``.

The default ``--host`` stays loopback (the JAX default is ``0.0.0.0``): a
start with no auth flags authenticates no one, so it listens where only
this machine reaches it.  The server does no device work and imports no
``torch``."""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..auth import UserInfo
from ..daemon import install_signal_stop, wait_forever
from ..store.store import Store
from .server import APIServer, TLSConfig


def parse_token_file(path: str) -> dict:
    """A static token file: ``token,user[,group1|group2]`` a line."""
    tokens: dict[str, UserInfo] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            user = parts[1] if len(parts) > 1 else parts[0]
            groups = parts[2].split("|") if len(parts) > 2 and parts[2] else []
            tokens[parts[0]] = UserInfo(name=user, groups=groups)
    return tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.apiserver")
    # loopback by default: a start with no auth flags authenticates no one
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6443)
    ap.add_argument("--event-log-window", type=int, default=300_000,
                    help="watch events kept for resumes; an older resume gets 410")
    ap.add_argument("--disable-admission", action="store_true",
                    help="serve with no admission chain")
    ap.add_argument("--data-dir", default=None,
                    help="durable state directory (WAL + snapshots; a restart recovers "
                         "the cluster)")
    ap.add_argument("--fsync", action="store_true",
                    help="fsync every WAL append (durability over latency)")
    ap.add_argument("--token-file", default=None,
                    help="static bearer tokens: token,user[,group1|group2] a line")
    ap.add_argument("--authorization-mode", default=None, choices=["AlwaysAllow", "RBAC"])
    ap.add_argument("--audit-log", default=None, help="JSON-lines audit log")
    ap.add_argument("--tls-cert-file", default=None)
    ap.add_argument("--tls-private-key-file", default=None)
    ap.add_argument("--client-ca-file", default=None,
                    help="verify client certificates against this CA; a verified "
                         "subject is the request's identity (CN user, O groups)")
    args = ap.parse_args(argv)
    if bool(args.tls_cert_file) != bool(args.tls_private_key_file):
        ap.error("--tls-cert-file and --tls-private-key-file go together")
    if args.client_ca_file and not args.tls_cert_file:
        ap.error("--client-ca-file requires --tls-cert-file "
                 "(client certificates ride the TLS handshake)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    store_kw = dict(event_log_window=args.event_log_window, data_dir=args.data_dir,
                    fsync=args.fsync)
    if args.disable_admission:
        store = Store(**store_kw)
    else:
        from ..admission import AdmittedStore, default_chain

        store = AdmittedStore(default_chain(), **store_kw)
    if args.data_dir:
        rec = store._wal.last_recovery
        logging.info("durable store at %s (recovered to revision %d)", args.data_dir,
                     store.revision)
        print("apiserver recovered " + json.dumps(
            {"data_dir": args.data_dir, "fsync": args.fsync, **rec}), flush=True)

    tokens = parse_token_file(args.token_file) if args.token_file else None
    authorizer = None
    if args.authorization_mode == "RBAC":
        from ..auth import RBACAuthorizer

        authorizer = RBACAuthorizer(store)
    auditor = None
    if args.audit_log:
        from ..auth.audit import Auditor, LogBackend

        auditor = Auditor(backends=[LogBackend(args.audit_log)])
    tls = authenticator = None
    if args.tls_cert_file:
        tls = TLSConfig(args.tls_cert_file, args.tls_private_key_file,
                        client_ca=args.client_ca_file)
        if args.client_ca_file:
            # a certificate-authenticated control plane: peer certificates
            # carry identity, static and bootstrap tokens still work, and
            # anonymous passes authentication so a joining node can read
            # the discovery document; it is authorized for that alone
            # unless a mode was given
            from ..auth import (
                AuthenticatedOrDiscovery,
                BootstrapTokenAuthenticator,
                TokenFileAuthenticator,
                UnionAuthenticator,
            )

            chain = [TokenFileAuthenticator(tokens)] if tokens is not None else []
            chain.append(BootstrapTokenAuthenticator(store))
            authenticator = UnionAuthenticator(*chain, allow_anonymous=True)
            if args.authorization_mode is None:
                authorizer = AuthenticatedOrDiscovery()
    server = APIServer(store, host=args.host, port=args.port, tokens=tokens,
                       authenticator=authenticator, authorizer=authorizer, auditor=auditor,
                       tls=tls)
    server.start()
    print(f"apiserver serving on {server.url}", flush=True)
    stop = install_signal_stop()
    wait_forever(stop)
    server.stop()
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
