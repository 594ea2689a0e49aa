"""The kube-dns daemon: ``python -m kubernetes_tpu_torch.dns --apiserver URL``.

Watches Services/Endpoints over the wire and serves the cluster zone on a
UDP port (reference: the kube-dns addon pod, ``cluster/addons/dns/``).
The flags are the JAX daemon's; SIGTERM stops it with exit 0."""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-dns")
    parser.add_argument("--apiserver", default=None)
    parser.add_argument("--token", default=None)
    parser.add_argument("--kubeconfig", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=10053)
    parser.add_argument("--zone", default="cluster.local")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..daemon import install_signal_stop, remote_clientset, wait_forever
    from .records import DNSRecordStore
    from .server import DNSServer

    if not args.apiserver and not args.kubeconfig:
        parser.error("one of --apiserver or --kubeconfig is required")
    cs = remote_clientset(args.apiserver, args.token,
                          kubeconfig=args.kubeconfig)
    records = DNSRecordStore(cs, zone=args.zone)
    records.start(manual=False)  # threaded informer watch loops
    server = DNSServer(records, host=args.host, port=args.port)
    server.start()
    logging.info("kube-dns serving zone %s on %s:%d", args.zone,
                 *server.address)
    stop = install_signal_stop()
    try:
        wait_forever(stop)
    finally:
        server.stop()
        records.informers.stop_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
