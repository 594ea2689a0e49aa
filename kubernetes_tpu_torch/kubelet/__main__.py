"""Hollow-node daemon (reference ``cmd/kubemark/hollow-node.go``): a
hollow kubelet against a remote apiserver.

    python -m kubernetes_tpu_torch.kubelet --apiserver http://host:6443 \
        --name node-001 [--count 50] [--proxy] [--tick 1.0]

``--count N`` runs a fleet of N nodes named ``{name}-{i:05d}`` in one
process (kubemark's N-hollow-nodes-per-host packing).  The flags and
defaults are the JAX entry point's.  ``--proxy`` runs a hollow kube-proxy
beside each node (``proxy.HollowProxyFleet``: one Service and one
Endpoints informer for the process), synced after the kubelets in each
tick; with ``--healthz-port`` the fleet's proxy counters are on
``/metrics`` (``proxy.hollow.FleetMetrics``), and so are the ticks' count,
seconds (the proxies' share apart) and the longest tick.  The kubelet
runs no kernel and takes no ``--device``."""

from __future__ import annotations

import argparse
import logging
import sys
import time

from ..daemon import install_signal_stop, remote_clientset, wait_forever
from .hollow import HollowFleet, HollowKubelet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.kubelet")
    ap.add_argument("--apiserver", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--kubeconfig", default=None,
                    help="connection document from the kubeadm kubeconfig "
                    "phase (server + CA pin + client cert); --apiserver/"
                    "--token override its fields")
    ap.add_argument("--name", default="hollow")
    ap.add_argument("--count", type=int, default=1)
    ap.add_argument("--proxy", action="store_true")
    ap.add_argument("--tick", type=float, default=1.0)
    ap.add_argument("--cpu", default="8")
    ap.add_argument("--memory", default="16Gi")
    ap.add_argument("--serve-logs", action="store_true",
                    help="expose the kubelet read API (logs/pods/healthz)")
    ap.add_argument("--real-containers", action="store_true",
                    help="run containers as real child processes with "
                    "on-disk volumes (single-node depth; not for fleets)")
    ap.add_argument("--container-root", default=None,
                    help="persistent container/checkpoint root: a "
                    "restarted kubelet adopts still-live containers "
                    "(dockershim checkpoint recovery)")
    ap.add_argument("--static-pod-dir", default=None,
                    help="directory of pod manifests to run WITHOUT a "
                    "scheduler, mirrored into the API (kubeadm-style "
                    "static pods)")
    ap.add_argument("--feature-gates", default="",
                    help="A=true,B=false (e.g. DynamicKubeletConfig=true)")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help="serve /healthz + /metrics + /debug/* (reference "
                         ":10248); -1 = off, 0 = ephemeral")
    ap.add_argument("--timeseries", action="store_true",
                    help="scrape the client-metrics registry into "
                         "time-series rings (served at /debug/timeseries)")
    ap.add_argument("--timeseries-interval", type=float, default=1.0)
    ap.add_argument("--telemetry-sink", default=None,
                    help="ship flight dumps + time-series deltas off-box "
                         "(collector URL or JSON-lines file path)")
    args = ap.parse_args(argv)
    if args.feature_gates:
        from ..utils.features import DEFAULT_FEATURE_GATES

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
    if args.count > 1 and (args.static_pod_dir or args.real_containers
                           or args.container_root):
        logging.warning("--static-pod-dir/--real-containers/--container-root "
                        "are single-node options; a --count fleet ignores them")
    if args.count > 1:
        fleet = HollowFleet(cs, args.count, cpu=args.cpu, memory=args.memory,
                            serve=args.serve_logs)
        # kubemark names nodes per host; keep the given prefix
        for i, k in enumerate(fleet.kubelets):
            k.node_name = f"{args.name}-{i:05d}"
            if k.server is not None:
                # the apiserver's exec proxy presents the token of the
                # node's name: the renamed node's
                from ..auth.authn import kubelet_exec_token

                k.server.exec_token = kubelet_exec_token(k.node_name)
        fleet.register_all()
        kubelets = fleet.kubelets
        tick = fleet.tick_all
    else:
        k = HollowKubelet(cs, args.name, cpu=args.cpu, memory=args.memory,
                          serve=args.serve_logs,
                          real_containers=args.real_containers,
                          container_root=args.container_root,
                          static_pod_dir=args.static_pod_dir)
        kubelets = [k]
        if args.static_pod_dir:
            # kubeadm bootstrap: the control-plane kubelet comes up BEFORE
            # its own static-pod apiserver — run manifests standalone and
            # keep retrying registration until the API answers
            state = {"registered": False}
            base_tick = k.tick

            def tick() -> None:
                if not state["registered"]:
                    k.standalone_static_tick()
                    try:
                        k.register()
                        state["registered"] = True
                        logging.info("apiserver reachable: node registered; "
                                     "static pods will be mirrored")
                    except Exception as e:  # noqa: BLE001 — stay standalone
                        # log on CHANGE so "API still coming up" is quiet
                        # but a persistent credential failure (401, bad
                        # CA) is diagnosable
                        msg = f"{type(e).__name__}: {e}"
                        if msg != state.get("last_err"):
                            state["last_err"] = msg
                            logging.warning(
                                "registration failed (still standalone, "
                                "will retry): %s", msg)
                        return
                base_tick()
        else:
            k.register()
            tick = k.tick

    proxies = []
    if args.proxy:
        from ..proxy import HollowProxyFleet

        pf = HollowProxyFleet(cs, [k.node_name for k in kubelets])
        pf.start()
        proxies.append(pf)

    # the shared daemon health surface (the reference kubelet's :10248):
    # hollow nodes observe through their wire client's registry
    from ..daemon import serve_health

    registry = cs.store.metrics.registry
    if proxies:
        from ..proxy.hollow import FleetMetrics

        registry.register(FleetMetrics(proxies[0]))
    health = serve_health(args.healthz_port, registry)
    if health is not None:
        logging.info("healthz/metrics on :%d", health.local_port)
    if args.timeseries or args.telemetry_sink:
        from ..daemon import enable_continuous_telemetry

        enable_continuous_telemetry(
            registry,
            interval_s=args.timeseries_interval,
            sink_spec=args.telemetry_sink)

    logging.info("hollow node(s) running: %d kubelet(s), proxy=%s",
                 len(kubelets), bool(proxies))

    # a tick's seconds, the proxies' share of them, and the longest tick
    from ..utils.metrics import Counter, Gauge

    ticks = registry.register(Counter("hollow_ticks_total", "fleet ticks"))
    tick_s = registry.register(Counter("hollow_tick_seconds_total",
                                       "seconds in fleet ticks, the proxies' syncs included"))
    proxy_s = registry.register(Counter("hollow_proxy_tick_seconds_total",
                                        "seconds of the ticks in the proxies' syncs"))
    tick_max = registry.register(Gauge("hollow_tick_seconds_max", "the longest tick"))

    def one_tick() -> None:
        # node loops never die: a transient apiserver error must not take
        # down the whole N-node fleet process
        t0 = time.perf_counter()
        try:
            tick()
            t1 = time.perf_counter()
            for pf in proxies:
                pf.tick_all()
            proxy_s.inc(time.perf_counter() - t1)
        except Exception:
            logging.exception("hollow tick failed (will retry)")
        dt = time.perf_counter() - t0
        ticks.inc()
        tick_s.inc(dt)
        tick_max.set(max(tick_max.value, dt))

    stop = install_signal_stop()
    try:
        wait_forever(stop, tick=one_tick, interval=args.tick)
    finally:
        for pf in proxies:
            pf.stop()
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
