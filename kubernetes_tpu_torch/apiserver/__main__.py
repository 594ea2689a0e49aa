"""kube-apiserver daemon (reference ``cmd/kube-apiserver/app/server.go:112``).

    python -m kubernetes_tpu_torch.apiserver --disable-admission \
        [--host 127.0.0.1] [--port 6443] [--event-log-window 300000]

The admission chain is not ported yet, so the server starts only with
``--disable-admission``: without it the process exits non-zero and never
serves as if writes had been admitted.  Authentication, authorization,
audit, TLS and ``--data-dir`` are not ported either, and their flags are
refused.  The server does no device work and imports no ``torch``."""

from __future__ import annotations

import argparse
import logging
import sys

from ..daemon import install_signal_stop, wait_forever
from ..store.store import Store
from .server import APIServer

ADMISSION_NOT_PORTED = (
    "the admission chain is not ported to kubernetes_tpu_torch yet (ROADMAP.md Queue 1, "
    "item 1, left out of the daemon slice: apiserver request handling, the admission "
    "chain); pass --disable-admission to serve without admission")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.apiserver")
    # loopback by default: this server authenticates no one
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6443)
    ap.add_argument("--event-log-window", type=int, default=300_000,
                    help="watch events kept for resumes; an older resume gets 410")
    ap.add_argument("--disable-admission", action="store_true",
                    help="required: serve with no admission chain (none is ported)")
    args = ap.parse_args(argv)
    if not args.disable_admission:
        print(f"kubernetes_tpu_torch.apiserver: {ADMISSION_NOT_PORTED}", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    server = APIServer(Store(event_log_window=args.event_log_window),
                       host=args.host, port=args.port)
    server.start()
    print(f"apiserver serving on {server.url}", flush=True)
    stop = install_signal_stop()
    wait_forever(stop)
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
