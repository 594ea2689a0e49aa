"""The federation control plane daemon: apiserver + controller manager.

Capability of ``federation/cmd/federation-apiserver`` +
``federation-controller-manager`` (reference federation/): one process
serving the federation-scoped API over HTTP (Cluster + the federated
kinds, through the same generic apiserver machinery — the reference's
federation-apiserver is likewise a genericapiserver instantiation) and
running the federation control loops against it: cluster health, fan-out
sync with placement, status rollup, cross-cluster service DNS.

    python -m kubernetes_tpu_torch.federation --port 18500 \
        [--federation-name myfed --dns-zone example.com]

Members join over the wire (``kubefed join NAME --cluster-server URL``);
the member factory dials each cluster's own apiserver.  SIGTERM or SIGINT
stops the controllers, the health server and the apiserver, and the
process exits 0.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="federation-apiserver")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--federation-name", default="myfed")
    parser.add_argument("--dns-zone", default="example.com")
    parser.add_argument("--sync-interval", type=float, default=1.0)
    parser.add_argument("--healthz-port", type=int, default=-1,
                        help="serve /healthz + /metrics + /debug/* for the "
                             "federation control plane; -1 = off")
    parser.add_argument("--timeseries", action="store_true",
                        help="scrape the apiserver registry into "
                             "time-series rings (/debug/timeseries)")
    parser.add_argument("--timeseries-interval", type=float, default=1.0)
    parser.add_argument("--telemetry-sink", default=None,
                        help="ship flight dumps + time-series deltas "
                             "off-box (collector URL or JSON-lines path)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..apiserver import APIServer
    from ..store import Store
    from ..client import Clientset
    from ..daemon import install_signal_stop, serve_health
    from .manager import FederationControllerManager

    stop = install_signal_stop()
    server = APIServer(Store(), port=args.port)
    server.start()
    logging.info("federation-apiserver serving at %s", server.url)

    # the shared daemon health surface over the embedded apiserver's
    # registry (the apiserver port serves the same routes; this one
    # stays answerable even while the API is saturated)
    health = serve_health(args.healthz_port, server.registry)
    if health is not None:
        logging.info("healthz/metrics on :%d", health.local_port)
    rings = args.timeseries or args.telemetry_sink
    if rings:
        from ..daemon import enable_continuous_telemetry

        enable_continuous_telemetry(
            server.registry, interval_s=args.timeseries_interval,
            sink_spec=args.telemetry_sink)

    cs = Clientset(server.store)
    mgr = FederationControllerManager(
        cs, federation_name=args.federation_name, dns_zone=args.dns_zone)
    mgr.start()
    try:
        while not stop.is_set():
            mgr.reconcile_all()
            for c in mgr.controllers.values():
                monitor = getattr(c, "monitor", None)
                if monitor is not None:
                    monitor()
            stop.wait(args.sync_interval)
    finally:
        mgr.stop()
        if rings:
            from ..utils import telemetry, timeseries

            timeseries.disable()
            telemetry.disable()  # the shipper's last drain
        if health is not None:
            health.stop()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
