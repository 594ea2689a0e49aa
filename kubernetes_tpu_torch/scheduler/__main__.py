"""kube-scheduler daemon (reference ``plugin/cmd/kube-scheduler/app/
server.go:67 Run``, leader election ``:133``).

    python -m kubernetes_tpu_torch.scheduler --apiserver http://127.0.0.1:6443 \
        [--leader-elect] [--backend batch|oracle] [--device cuda|cpu] \
        [--batch-interval 0.05] [--healthz-port N] [--config config.json]

It watches the apiserver over HTTP with threaded informers and serves with
``Scheduler.run_batch_loop`` on ``BatchBackend`` (the fused CUDA scan;
``--device cpu`` runs the plain scan) or, with ``--backend oracle``, pod
by pod.  ``--device cuda`` is the default and the process exits non-zero,
before it takes the lease, where there is no card.  On SIGTERM it stops,
releases the lease and prints one JSON line ``{"scheduler_stats": ...}``
with the backend's stats, the fused kernel's launch count, the final
round-robin counter and the pods bound."""

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


def _parse(argv):
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.scheduler")
    ap.add_argument("--apiserver", required=True)
    ap.add_argument("--token", default=None)
    ap.add_argument("--leader-elect", action="store_true")
    # SUPPRESS tells a flag given from a default when a --config file is
    # layered underneath (flag > file > default)
    ap.add_argument("--backend", choices=BACKENDS, default=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the batch backend scans; cuda needs a card")
    ap.add_argument("--batch-interval", type=float, default=argparse.SUPPRESS,
                    help="seconds to coalesce pending pods before a batch")
    ap.add_argument("--scheduler-name", default=argparse.SUPPRESS)
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--config", default=None, help="SchedulerConfiguration as JSON")
    ap.add_argument("--healthz-port", type=int, default=-1,
                    help="serve /healthz and /metrics (reference :10251); -1 off, 0 any port")
    args = ap.parse_args(argv)
    cfg = (load_component_config(SchedulerConfiguration, args.config)
           if args.config else SchedulerConfiguration())
    for attr in ("scheduler_name", "backend", "batch_interval"):
        if not hasattr(args, attr):
            setattr(args, attr, getattr(cfg, attr))
    if args.backend not in BACKENDS:
        ap.error(f"backend {args.backend!r}: one of {list(BACKENDS)}")
    args.leader_elect = args.leader_elect or cfg.leader_elect
    DEFAULT_FEATURE_GATES.set_from_map(cfg.feature_gates)
    DEFAULT_FEATURE_GATES.set_from_string(args.feature_gates)
    if args.backend == "batch" and not DEFAULT_FEATURE_GATES.enabled("BatchScheduling"):
        ap.error("--backend batch with the BatchScheduling feature gate off")
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
    cs = remote_clientset(args.apiserver, args.token)

    # health before leader election: a standby must answer its liveness
    # probe.  The metrics registry appears once the payload builds the
    # scheduler.
    holder: dict = {}

    class _LazyRegistry:
        def expose(self):
            reg = holder.get("registry")
            return reg.expose() if reg is not None else "# standby\n"

    health = serve_health(args.healthz_port, _LazyRegistry())
    if health is not None:
        logging.info("healthz and metrics on :%d", health.local_port)

    def run(payload_stop: threading.Event) -> None:
        from .generic_scheduler import GenericScheduler
        from .scheduler import Scheduler

        # one algorithm for both: the backend writes the round-robin counter
        algo = GenericScheduler()
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
        sched = Scheduler(cs, algorithm=algo, backend=backend,
                          scheduler_name=args.scheduler_name)
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
                    sched.schedule_one(timeout=0.2)
        finally:
            sched.informers.stop_all()
            sched.broadcaster.stop()
        m = sched.metrics
        infs = sched.informers.informers()
        stats = {"backend": args.backend, "device": args.device,
                 "bound": bound if backend is not None else m.binding_latency.count,
                 "drained": int(m.batch_size.sum), "waves": m.batch_size.count,
                 # wall seconds inside the batch path (tensorize, scan,
                 # commits), the scheduler's share of a daemon run
                 "batch_s": m.batch_device_latency.sum / 1e6,
                 # the informers' watch ingest: typed decode, and decode +
                 # cache + handlers, on their own threads
                 "ingest_decode_s": sum(i.stats["decode_s"] for i in infs),
                 "ingest_apply_s": sum(i.stats["apply_s"] for i in infs),
                 "ingest_bytes": int(cs.store.metrics.ingest_bytes.value),
                 "round_robin": algo._round_robin, "launches": 0}
        if backend is not None:
            from ..ops import fused_scan

            stats.update(backend.stats, launches=fused_scan.launches)
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
