"""kube-controller-manager daemon (reference
``cmd/kube-controller-manager/app/controllermanager.go:107 Run``).

    python -m kubernetes_tpu_torch controller-manager --apiserver http://host:6443 \
        [--leader-elect] [--controllers deployment,replicaset,...] \
        [--node-monitor-period 5]

(or ``python -m kubernetes_tpu_torch.controllers``).  Runs every
registered control loop threaded (informer watch threads +
per-controller workers) plus the tick-driven loops (node lifecycle
monitor, taint manager, cronjob clock).  The flags and defaults are the
JAX entry point's; a bad ``--feature-gates`` string leaves through
``ap.error`` (exit 2), as the port's scheduler and kubelet do.  The
controller manager runs no kernel and takes no ``--device``.  On SIGTERM
the leader stops, releases the lease and prints one JSON line
``{"controller_manager_stats": ...}``: each controller's syncs, sync
seconds, failed syncs and queue depth, the tick-driven loops' seconds
and the zone states."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading

from ..daemon import install_signal_stop, remote_clientset, run_with_leader_election
from .manager import DEFAULT_CONTROLLERS, ControllerManager


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.controllers")
    ap.add_argument("--apiserver", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--kubeconfig", default=None,
                    help="connection document from the kubeadm kubeconfig "
                    "phase (server + CA pin + client cert); --apiserver/"
                    "--token override its fields")
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--controllers", default="*",
                    help="comma list or * (default set: %s)" % ",".join(DEFAULT_CONTROLLERS))
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--node-monitor-period", type=float, default=5.0)
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help="serve /healthz + /metrics + /debug/* (reference "
                         ":10252); -1 = off")
    ap.add_argument("--timeseries", action="store_true",
                    help="scrape the client-metrics registry into "
                         "time-series rings (served at /debug/timeseries)")
    ap.add_argument("--timeseries-interval", type=float, default=1.0)
    ap.add_argument("--telemetry-sink", default=None,
                    help="ship flight dumps + time-series deltas off-box "
                         "(collector URL or JSON-lines file path)")
    args = ap.parse_args(argv)
    from ..utils.features import DEFAULT_FEATURE_GATES

    if args.feature_gates:
        try:
            DEFAULT_FEATURE_GATES.set_from_string(args.feature_gates)
        except (KeyError, ValueError) as e:
            ap.error(f"--feature-gates: {e}")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if not args.apiserver and not args.kubeconfig:
        ap.error("one of --apiserver or --kubeconfig is required")
    cs = remote_clientset(args.apiserver, args.token,
                          kubeconfig=args.kubeconfig)
    names = None if args.controllers == "*" else args.controllers.split(",")

    def run(payload_stop: threading.Event) -> None:
        kw = {}
        if DEFAULT_FEATURE_GATES.enabled("TaintBasedEvictions"):
            kw["use_taint_based_evictions"] = True
        mgr = ControllerManager(cs, enabled=names, **kw)
        mgr.start(manual=False, workers_per_controller=args.workers)
        logging.info("controller manager running: %s", ", ".join(mgr.controllers))
        while not payload_stop.is_set():
            mgr.tick()  # clock-driven loops (node monitor, taints, cron)
            payload_stop.wait(args.node_monitor_period)
        stats = mgr.stats()
        mgr.stop()
        print(json.dumps({"controller_manager_stats": stats}), flush=True)

    stop = install_signal_stop()
    # health before leader election: standbys must answer liveness probes.
    # The controller manager's observable surface is its client transport
    # (retries, relists, watch gaps): the wire client's registry, as the
    # port's kubelet entry serves it
    from ..daemon import serve_health

    registry = cs.store.metrics.registry
    health = serve_health(args.healthz_port, registry)
    if health is not None:
        logging.info("healthz/metrics on :%d", health.local_port)
    if args.timeseries or args.telemetry_sink:
        from ..daemon import enable_continuous_telemetry

        enable_continuous_telemetry(
            registry,
            interval_s=args.timeseries_interval,
            sink_spec=args.telemetry_sink)
    try:
        run_with_leader_election(
            cs, "kube-controller-manager", f"kcm-{os.getpid()}", run, stop,
            leader_elect=args.leader_elect,
        )
    finally:
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
