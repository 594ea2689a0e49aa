"""kube-apiserver daemon (reference ``cmd/kube-apiserver/app/server.go:112``).

    python -m kubernetes_tpu_torch.apiserver [--host 127.0.0.1] [--port 6443] \
        [--event-log-window 300000] [--disable-admission] \
        [--data-dir DIR [--fsync]]

It starts as the JAX package's apiserver starts: the store is an
``AdmittedStore`` over ``admission.default_chain()`` unless
``--disable-admission``, and ``--data-dir`` makes it durable (a
write-ahead log and snapshots; a restart over the same directory recovers
the cluster and its revision, and the start-up log gives the recovery:
revision, records replayed, torn tail, truncated bytes).  ``--fsync``
syncs every WAL append before the write is acknowledged.

Authentication, authorization, audit and TLS are not ported: their flags
(``--token-file``, ``--authorization-mode``, ``--audit-log``,
``--tls-cert-file``, ``--tls-private-key-file``, ``--client-ca-file``)
make the process exit non-zero, so it never serves as if it had
authenticated anyone.  The server does no device work and imports no
``torch``."""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..daemon import install_signal_stop, wait_forever
from ..store.store import Store
from .server import APIServer

AUTH_NOT_PORTED = (
    "authentication, authorization, audit and TLS are not ported to "
    "kubernetes_tpu_torch yet (ROADMAP.md Queue 1, item 8); the apiserver never serves "
    "as if it had authenticated anyone")

# the JAX entry point's auth, audit and TLS flags, each refused here
_REFUSED = ("--token-file", "--authorization-mode", "--audit-log", "--tls-cert-file",
            "--tls-private-key-file", "--client-ca-file")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.apiserver")
    # loopback by default: this server authenticates no one
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
    for flag in _REFUSED:
        ap.add_argument(flag, default=None, help="not ported: refused")
    args = ap.parse_args(argv)
    given = [f for f in _REFUSED if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        print(f"kubernetes_tpu_torch.apiserver: {', '.join(given)}: {AUTH_NOT_PORTED}",
              file=sys.stderr)
        return 2
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
    server = APIServer(store, host=args.host, port=args.port)
    server.start()
    print(f"apiserver serving on {server.url}", flush=True)
    stop = install_signal_stop()
    wait_forever(stop)
    server.stop()
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
