"""cloud-controller-manager daemon (reference
``cmd/cloud-controller-manager/controller-manager.go``).

    python -m kubernetes_tpu_torch cloud-controller-manager --apiserver http://host:6443 \
        [--cloud-provider fake] [--leader-elect] [--controllers ...]

(or ``python -m kubernetes_tpu_torch.cloud``).  The flags and defaults are
the JAX entry point's, with ``--kubeconfig`` as the port's other daemons
take it.  As the port's controller-manager entry does, a bad
``--feature-gates`` leaves through ``ap.error`` (exit 2), ``--healthz-port``
serves ``/metrics`` (the wire client's registry and the fake cloud's
counts: ``cloud.manager.CloudMetrics``), and on SIGTERM the leader stops,
releases the lease and prints one JSON line
``{"cloud_controller_manager_stats": ...}``: each controller's syncs, sync
seconds, failed syncs and queue depth, the monitor's ticks, and the fake
cloud's balancers (ingress IP, ports, nodes), routes (node: CIDR) and the
count of its calls.  It runs no kernel and takes no ``--device``."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading

from ..daemon import install_signal_stop, remote_clientset, run_with_leader_election, serve_health
from .manager import CLOUD_CONTROLLERS, CloudControllerManager, CloudMetrics
from .provider import FakeCloud


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.cloud")
    ap.add_argument("--apiserver", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--kubeconfig", default=None,
                    help="connection document (server, CA pin, client certificate and "
                         "key); --apiserver/--token override its fields")
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--cloud-provider", default="fake", choices=["fake"])
    ap.add_argument("--controllers", default="*",
                    help="comma list or * (default: %s)" % ",".join(CLOUD_CONTROLLERS))
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--monitor-period", type=float, default=5.0)
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help="serve /healthz + /metrics; -1 = off, 0 = ephemeral")
    args = ap.parse_args(argv)
    if args.feature_gates:
        from ..utils.features import DEFAULT_FEATURE_GATES

        try:
            DEFAULT_FEATURE_GATES.set_from_string(args.feature_gates)
        except (KeyError, ValueError) as e:
            ap.error(f"--feature-gates: {e}")
    if not args.apiserver and not args.kubeconfig:
        ap.error("one of --apiserver or --kubeconfig is required")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    cs = remote_clientset(args.apiserver, args.token, kubeconfig=args.kubeconfig)
    cloud = FakeCloud()
    names = None if args.controllers == "*" else args.controllers.split(",")

    def run(payload_stop: threading.Event) -> None:
        mgr = CloudControllerManager(cs, cloud, enabled=names)
        mgr.start(manual=False, workers_per_controller=args.workers)
        logging.info("cloud controller manager running: %s", ", ".join(mgr.controllers))
        while not payload_stop.is_set():
            mgr.tick()
            payload_stop.wait(args.monitor_period)
        stats = {**mgr.stats(), "cloud": cloud.summary()}
        mgr.stop()
        print(json.dumps({"cloud_controller_manager_stats": stats}), flush=True)

    stop = install_signal_stop()
    registry = cs.store.metrics.registry
    registry.register(CloudMetrics(cloud))
    health = serve_health(args.healthz_port, registry)
    if health is not None:
        logging.info("healthz/metrics on :%d", health.local_port)
    try:
        run_with_leader_election(
            cs, "cloud-controller-manager", f"ccm-{os.getpid()}", run, stop,
            leader_elect=args.leader_elect,
        )
    finally:
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
