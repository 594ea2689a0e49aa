"""kube-scheduler daemon (reference ``plugin/cmd/kube-scheduler/app/
server.go:67 Run``, leader election ``:133``).

    python -m kubernetes_tpu_torch.scheduler \
        (--apiserver http://127.0.0.1:6443 [--token T] | --kubeconfig scheduler.kubeconfig) \
        [--leader-elect] [--backend batch|tpu|oracle] [--device cuda|cpu] \
        [--batch-interval 0.05] [--policy-config-file policy.json] \
        [--healthz-port N] [--config config.json] \
        [--trace [--trace-dump-dir DIR]] [--timeseries [--timeseries-interval S]] \
        [--telemetry-sink URL-or-file]

It watches the apiserver over HTTP with threaded informers and serves with
``Scheduler.run_batch_loop`` on ``BatchBackend`` (the fused CUDA scan;
``--device cpu`` runs the plain scan) or, with ``--backend oracle``, pod
by pod with asynchronous binds.  ``tpu``, the JAX daemon's name for its
batch backend, is taken as ``batch``, so the JAX daemon's configuration
loads unchanged.  Preemption is on, as in the JAX daemon.  A
``--policy-config-file`` (JSON) selects predicates, priorities and
extenders (``scheduler/policy.py``).  A policy the fused scan does not
express runs, as in the JAX daemon, on the host oracle inside the batch
backend: the daemon logs that once at start-up, and
``scheduler_backend_oracle_pods_total`` on ``/metrics`` counts those pods.
With the batch backend ``/metrics`` also carries
``scheduler_kernel_launches_total{kernel="fused_scan"|"frontier_refresh"}``,
the kernels' launch counts read when it is scraped.  With
``PallasSuperSteps=true`` the fused scan runs the library built for
``KTPU_SUPERSTEP_K`` pods a loop iteration (default 8), built at start-up,
and its launches are also counted under ``kernel="fused_scan_k<K>"``.
``--device cuda`` is the default and the process exits non-zero, before
it takes the lease, where there is no card.

``--kubeconfig`` reads a connection document (``pki.write_kubeconfig``:
server, CA pin, client certificate and key, optional token), so the
daemon can reach an ``https://`` apiserver as the identity of its client
certificate; ``--apiserver``/``--token`` override its fields.
``--feature-gates`` and the config file's ``feature_gates`` take the JAX
package's gate names (``TPUBatchScheduling`` is ``BatchScheduling``).  With
``--device cuda``, ``PallasKernels=false`` is refused: it asks for the JAX
package's XLA-scan rung, and the port has no kernel-to-plain-version
ladder.

``--trace`` turns on wave tracing and the flight recorder
(``/debug/traces``, ``/debug/flightrecorder`` on the health port;
``--trace-dump-dir`` also writes each dump as a file); ``--timeseries``
scrapes the metrics into rings (``/debug/timeseries``) with the burn-rate
SLO monitor, and ``--telemetry-sink`` ships flight dumps and time-series
deltas to a collector URL (the apiserver's ``/telemetry``) or a JSON-lines
file.  Each of these flags may also come from the ``--config`` file (flag
> file > default).  On SIGTERM it stops, releases the lease and prints
one JSON line ``{"scheduler_stats": ...}`` with the backend's stats, the
fused kernel's launch count, the final round-robin counter, the pods
bound and the preemption counters."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading

from ..daemon import install_signal_stop, remote_clientset, run_with_leader_election, serve_health
from ..utils.features import DEFAULT_FEATURE_GATES, SchedulerConfiguration, load_component_config

BACKENDS = ("batch", "oracle")
# the JAX daemon's backend names, as this daemon takes them
BACKEND_ALIASES = {"tpu": "batch"}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.scheduler")
    ap.add_argument("--apiserver", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--kubeconfig", default=None,
                    help="connection document (server, CA pin, client certificate and "
                         "key); --apiserver/--token override its fields")
    ap.add_argument("--leader-elect", action="store_true")
    # SUPPRESS tells a flag given from a default when a --config file is
    # layered underneath (flag > file > default)
    ap.add_argument("--backend", choices=BACKENDS + tuple(BACKEND_ALIASES),
                    default=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the batch backend scans; cuda needs a card")
    ap.add_argument("--batch-interval", type=float, default=argparse.SUPPRESS,
                    help="seconds to coalesce pending pods before a batch")
    ap.add_argument("--policy-config-file", default=argparse.SUPPRESS,
                    help="scheduler Policy (predicates, priorities, extenders) as JSON")
    ap.add_argument("--scheduler-name", default=argparse.SUPPRESS)
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--config", default=None, help="SchedulerConfiguration as JSON")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help="serve /healthz, /metrics and /debug/* (reference :10251); "
                         "-1 off, 0 any port")
    ap.add_argument("--trace", action="store_true", default=argparse.SUPPRESS,
                    help="wave tracing and the flight recorder (/debug/traces, "
                         "/debug/flightrecorder)")
    ap.add_argument("--trace-dump-dir", default=argparse.SUPPRESS,
                    help="with --trace: also write each flight-recorder dump as a JSON file")
    ap.add_argument("--timeseries", action="store_true", default=argparse.SUPPRESS,
                    help="time-series rings of the metrics (/debug/timeseries) and the "
                         "burn-rate SLO monitor")
    ap.add_argument("--timeseries-interval", type=float, default=argparse.SUPPRESS,
                    help="scrape period in seconds")
    ap.add_argument("--telemetry-sink", default=argparse.SUPPRESS,
                    help="ship flight dumps and time-series deltas to an http:// collector "
                         "(the apiserver's /telemetry) or a JSON-lines file; implies "
                         "--timeseries")
    args = ap.parse_args(argv)
    cfg = (load_component_config(SchedulerConfiguration, args.config)
           if args.config else SchedulerConfiguration())
    for attr in ("scheduler_name", "backend", "batch_interval", "policy_config_file",
                 "trace", "trace_dump_dir", "timeseries", "timeseries_interval",
                 "telemetry_sink"):
        if not hasattr(args, attr):
            setattr(args, attr, getattr(cfg, attr))
    args.backend = BACKEND_ALIASES.get(args.backend, args.backend)
    if args.backend not in BACKENDS:
        ap.error(f"backend {args.backend!r}: one of {list(BACKENDS)}")
    args.leader_elect = args.leader_elect or cfg.leader_elect
    if not args.apiserver and not args.kubeconfig:
        ap.error("one of --apiserver or --kubeconfig is required")
    try:
        DEFAULT_FEATURE_GATES.set_from_map(cfg.feature_gates)
        DEFAULT_FEATURE_GATES.set_from_string(args.feature_gates)
    except (KeyError, ValueError) as e:
        ap.error(f"feature gates: {e.args[0] if e.args else e}")
    if args.backend == "batch" and not DEFAULT_FEATURE_GATES.enabled("BatchScheduling"):
        ap.error("--backend batch with the BatchScheduling feature gate off")
    if args.device == "cuda" and not DEFAULT_FEATURE_GATES.enabled("PallasKernels"):
        ap.error("PallasKernels=false asks for the JAX package's XLA-scan rung; the port has "
                 "no kernel-to-plain-version ladder (no fallback on the device path): the "
                 "card runs the fused CUDA scan, or pass --device cpu for the plain scan")
    return args


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("kubernetes_tpu_torch.scheduler: no CUDA device; pass --device cpu to "
                  "schedule on the CPU", file=sys.stderr)
            return 1
    policy_algo = None
    if args.policy_config_file:
        from .policy import load_policy_file

        policy_algo = load_policy_file(args.policy_config_file)
        if args.backend == "batch":
            from ..ops.backend import BatchBackend

            if BatchBackend(algorithm=policy_algo, device="cpu")._config_supported() is None:
                # as the JAX daemon does: the waves run, on the host oracle
                logging.warning(
                    "the policy %s selects predicates, priorities or extenders the fused "
                    "scan does not compute: its waves run on the host oracle "
                    "(scheduler_backend_oracle_pods_total)", args.policy_config_file)
    if args.trace:
        from ..utils import tracing

        tracing.enable(dump_dir=args.trace_dump_dir or None)
        logging.info("wave tracing on (flight recorder armed)")
    cs = remote_clientset(args.apiserver, args.token, kubeconfig=args.kubeconfig)

    # health before leader election: a standby must answer its liveness
    # probe.  The metrics registry appears once the payload builds the
    # scheduler; the wire client's (retries, watch reconnects and gaps)
    # follows it.
    holder: dict = {}

    class _LazyRegistry:
        def expose(self):
            reg = holder.get("registry")
            if reg is None:
                return "# standby\n"
            text = reg.expose() + cs.store.metrics.registry.expose()
            launches = holder.get("launches")
            if launches is not None:
                text += ("# TYPE scheduler_kernel_launches_total counter\n" + "".join(
                    f'scheduler_kernel_launches_total{{kernel="{k}"}} {n}\n'
                    for k, n in launches().items()))
            return text

    health = serve_health(args.healthz_port, _LazyRegistry())
    if health is not None:
        logging.info("healthz and metrics on :%d", health.local_port)

    def run(payload_stop: threading.Event) -> None:
        from .. import native
        from ..api import lazy
        from .generic_scheduler import GenericScheduler
        from .scheduler import Scheduler

        # one algorithm for both: the backend writes the round-robin counter
        algo = policy_algo if policy_algo is not None else GenericScheduler()
        backend = None
        if args.backend == "batch":
            from ..ops.backend import BatchBackend

            backend = BatchBackend(algorithm=algo, device=args.device)
            if backend.device.type == "cuda":
                import torch

                from ..ops import fused_scan

                # build or load the kernel and create the CUDA context now,
                # not inside the first wave
                fused_scan.load()
                torch.empty(1, device=backend.device)
        if backend is not None:
            from ..ops import frontier_refresh, fused_scan

            # the kernels' launch counters, read when /metrics is scraped
            holder["launches"] = lambda: {
                "fused_scan": fused_scan.launches, "frontier_refresh": frontier_refresh.launches,
                **{f"fused_scan_k{k}": n for k, n in fused_scan.launches_k.items() if k > 1}}
        sched = Scheduler(cs, algorithm=algo, backend=backend,
                          scheduler_name=args.scheduler_name)
        telemetry_on = args.timeseries or bool(args.telemetry_sink)
        if telemetry_on:
            from ..daemon import enable_continuous_telemetry

            enable_continuous_telemetry(sched.metrics.registry,
                                        interval_s=args.timeseries_interval,
                                        sink_spec=args.telemetry_sink or None)
            logging.info("continuous telemetry on (scrape %.2fs, sink %s)",
                         args.timeseries_interval, args.telemetry_sink or "-")
        sched.start(manual=False)  # threaded informers and the event sink
        # /metrics answers with the scheduler's registry from here: serving
        holder["registry"] = sched.metrics.registry
        logging.info("scheduler running (backend=%s, device=%s)", args.backend, args.device)
        bound = 0
        try:
            while not payload_stop.is_set():
                if backend is not None:
                    # drain as pods arrive: one full segment ends the
                    # accumulation early, else batch_interval does
                    n = sched.run_batch_loop(
                        min_batch=backend.max_segment_pods, max_wait=args.batch_interval,
                        stop=payload_stop, poll_interval=min(0.05, args.batch_interval))
                    bound += n
                    if n:
                        logging.info("batch loop: %d bound", n)
                else:
                    sched.schedule_one(timeout=0.2, async_bind=True)
        finally:
            sched.informers.stop_all()
            sched.broadcaster.stop()
            if telemetry_on:
                from ..utils import telemetry, timeseries

                timeseries.disable()
                telemetry.disable()  # the shipper's last drain
        m = sched.metrics
        infs = sched.informers.informers()
        stats = {"backend": args.backend, "device": args.device,
                 "bound": bound if backend is not None else m.binding_latency.count,
                 "drained": int(m.batch_size.sum), "waves": m.batch_size.count,
                 # wall seconds inside the batch path (tensorize, scan,
                 # commits), the scheduler's share of a daemon run
                 "batch_s": m.batch_device_latency.sum / 1e6,
                 # the informers' watch ingest, on their own threads: decode
                 # (lazy wrap, or typed decode with lazy decode off), and
                 # decode + cache + handlers; frames, the events they
                 # carried, lazy promotions, the frame confirm's fallbacks
                 "ingest_lazy": lazy.ENABLED,
                 "ingest_decode_s": sum(i.stats["decode_s"] for i in infs),
                 # the watch readers' line parse (JSON, frame columns),
                 # before the informers decode
                 "ingest_parse_s": cs.store.metrics.watch_parse_seconds.value,
                 "ingest_apply_s": sum(i.stats["apply_s"] for i in infs),
                 "ingest_bytes": int(cs.store.metrics.ingest_bytes.value),
                 "ingest_frames": sum(i.stats["frames"] for i in infs),
                 "ingest_frame_events": sum(i.stats["frame_events"] for i in infs),
                 # the watch events each informer applied (framed or not),
                 # by kind: the node fleet's heartbeats are Node updates
                 "informer_events": {i.kind: i.stats["events"] + i.stats["frame_events"]
                                     for i in infs},
                 "ingest_promotions": lazy.STATS["promotions"] + lazy.STATS["sections"],
                 "confirm_fallbacks": int(m.confirm_fallbacks.value),
                 "preemption_attempts": int(m.preemption_attempts.value),
                 "preemption_victims": int(m.preemption_victims.value),
                 "helpers": native.helpers(),
                 "round_robin": algo._round_robin, "launches": 0}
        if backend is not None:
            from ..ops import frontier_refresh, fused_scan

            stats.update(backend.stats, launches=fused_scan.launches,
                         refresh_launches=frontier_refresh.launches,
                         node_cache=dict(backend.device_node_cache.stats))
        print(json.dumps({"scheduler_stats": stats}), flush=True)

    stop = install_signal_stop()
    try:
        ok = run_with_leader_election(cs, "kube-scheduler", f"scheduler-{os.getpid()}",
                                      run, stop, leader_elect=args.leader_elect)
    finally:
        if health is not None:
            health.stop()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
