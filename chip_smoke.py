#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

1. the card: name and power limit as nvidia-smi reports them;
2. build the fused-scan CUDA kernel from ``kubernetes_tpu_torch/ops/csrc``;
3. the kernel against its plain PyTorch version (``ops/scan_ref.py``) on
   the card, on 1000-node x 2000-pod ``mixed`` and ``plain`` segments, and
   the port's sequential oracle against ``BatchBackend`` on a 300-pod
   prefix;
4. the main path at full width: one ``BatchBackend(device="cuda")
   .schedule_batch`` of 20 000 ``mixed`` pods on 5000 nodes, with the
   fused-kernel launch count read around it; then the kernel against the
   plain version on that very segment, on a 5000-node x 2000-pod one and
   on a 10 000-node x 1000-pod one, and the kernel's times;
5. the serving path: (a) ``workload.run_churn`` at full width, 20 000
   ``mixed`` pods arriving in 10 waves on 5000 nodes and served by the
   port's ``Scheduler.run_batch_loop`` on ``BatchBackend(device="cuda")``
   with events on, the launch count read around it; (b) a 1000-node x
   400-pod churn run on the card replayed wave by wave through the port's
   per-pod oracle (``workload.oracle_replay_waves``);
6. the daemon stack: (a) ``python -m kubernetes_tpu_torch.apiserver`` and
   ``python -m kubernetes_tpu_torch.scheduler --leader-elect`` (its
   default ``--backend batch --device cuda``) as processes, driven over
   HTTP by ``workload.run_wire_churn`` at full width, 20 000 ``mixed`` pods
   in 10 waves on 5000 nodes; the fused kernel's launches are counted in
   the daemon, which starts at 0 and reports them when SIGTERM stops it;
   (b) a fresh pair of daemons on 1000 nodes whose 400 pods exist before
   the scheduler starts, its bindings and round-robin counter read back
   and held against the port's sequential oracle.

Every comparison is exact (chosen node index per pod and the final
round-robin counter; ``max_abs_err`` is the largest index difference).
Any mismatch or error exits non-zero.  The last lines are the kernel
table as JSON, the card line, and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# 32-bit rate that the scan's integer ALU work runs at
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
REPLACES = "kubernetes_tpu/ops/pallas_kernel.py:178"
ROOT = os.path.dirname(os.path.abspath(__file__))
E2E_METRIC = "scheduler_e2e_scheduling_latency_microseconds"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cluster(n_nodes: int, n_pods: int, workload: str, seed: int):
    from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext
    from kubernetes_tpu_torch.workload import make_nodes, make_pods, make_services

    rng = random.Random(seed)
    nodes = make_nodes(n_nodes, rng, workload)
    pods = make_pods(n_pods, rng, workload)
    m = {n.meta.name: NodeInfo(n) for n in nodes}
    return m, pods, PriorityContext(m, services=make_services())


def segment(m, pods, pctx, device):
    """One segment tensorized exactly as BatchBackend tensorizes its first
    segment of the same batch, carried to ``device``."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import HostBatchState, Tensorizer
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    w = BatchBackend(device=device)._config_supported()
    tz = Tensorizer()
    host = HostBatchState(m)
    static = tz.build_static(
        pods, m, pctx, least_requested_weight=w["least"],
        most_requested_weight=w["most"], balanced_weight=w["balanced"],
        spread_weight=w["spread"], node_affinity_weight=w["node_affinity"],
        taint_weight=w["taint"], prefer_avoid_weight=w["prefer_avoid"],
        image_weight=w["image"], interpod_weight=w["interpod"],
        mounted_disks=host.mounted_disks)
    init = tz.initial_state(static, m, pctx, pods, round_robin=0, host_state=host)
    s, st = from_reference(vars(static), vars(init), device)
    return static, s, st


def compare(s, st) -> dict:
    """Kernel and plain version on the same inputs; raises on mismatch."""
    import torch

    from kubernetes_tpu_torch.ops import fused_scan, scan_ref

    got, rr_got = fused_scan.schedule(s, st)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want, rr_want = scan_ref.scan(s, st)
    end.record()
    end.synchronize()
    want = want.cpu().numpy()
    err = int(abs(got.astype("int64") - want.astype("int64")).max()) if len(want) else 0
    if err != 0 or rr_got != rr_want:
        raise AssertionError(
            f"fused scan != scan_ref: max index diff {err}, rr {rr_got} vs {rr_want}")
    return {"max_abs_err": err, "bound": int((want >= 0).sum()), "pods": len(want),
            "rr": rr_got, "chosen": want, "plain_ms": start.elapsed_time(end)}


def time_kernel(s, st, reps: int = 3) -> float:
    """ms per launch by CUDA events; each launch gets freshly packed state
    (the kernel updates its state planes in place), packed outside the
    timed window."""
    import torch

    from kubernetes_tpu_torch.ops import fused_scan

    fused_scan.launch(s, st, fused_scan.pack(s, st))  # warm-up
    total = 0.0
    for _ in range(reps):
        bufs = fused_scan.pack(s, st)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fused_scan.launch(s, st, bufs)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(s, st) -> tuple[float, str, dict]:
    """Least time the card could take for this scan: the larger of (a) the
    packed inputs read once and the outputs written once over HBM
    bandwidth and (b) the integer operations these inputs need over the
    non-tensor 32-bit rate.  Operations are counted per pod over the N
    node columns: resource fit (3 per resource), pod count and existence
    (4), host ports (2 per vocabulary entry when the segment has ports), 8
    per affinity term active for the pod's signature, 8 per valid volume
    slot plus 4 per limited kind, and 60 for the scores, reductions and
    selection.  Data-dependent terms count this run's pods."""
    from kubernetes_tpu_torch.ops import fused_scan

    bufs = fused_scan.pack(s, st)
    out_bytes = bufs["chosen"].numel() * 4 + 4
    in_bytes = sum(t.numel() * t.element_size() for k, t in bufs.items()
                   if k not in ("chosen", "rr_out"))
    n, r = s.node_alloc.shape
    gids = s.group_of_pod.long()
    terms = bufs["term_count"].long()[gids].sum().item() if s.use_terms else 0
    slots = s.pod_vol_valid.sum().item() if s.use_vols else 0
    per_pod = 3 * r + 4 + 60 + (2 * s.g_ports.shape[1] if s.use_ports else 0) \
        + (4 * s.vol_limits.shape[0] if s.use_vols else 0)
    ops = n * (per_pod * s.p_real + 8 * terms + 8 * slots)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    detail = {"bytes": in_bytes + out_bytes, "ops": ops}
    return (t_bytes, "bytes", detail) if t_bytes >= t_ops else (t_ops, "operations", detail)


def churn_phase() -> int:
    """Phase 5: the serving path at full width, then per-wave oracle parity
    of a smaller churn run.  Returns the fused-kernel launches of 5a."""
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.workload import oracle_replay_waves, run_churn

    n_nodes, n_pods, waves = 5000, 20000, 10
    fused_scan.launches = 0
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=0, device="cuda")
    launches = fused_scan.launches
    st = r["backend"]
    e2e = r["e2e_scheduling_ms"]
    print(f"phase 5a churn {n_nodes}x{n_pods} mixed in {waves} waves: bound {r['bound']} "
          f"unbound {r['unbound']} drained {r['drained']} wall_s {r['wall_s']:.3f} "
          f"pods_per_s {r['pods_per_sec']:.1f} e2e_p50_ms {e2e['p50']} e2e_p99_ms {e2e['p99']} "
          f"launches {launches} segments {st['segments']} kernel_pods {st['kernel_pods']} "
          f"oracle_pods {st['oracle_pods']} kernel_ms {st['kernel_ms']:.3f} "
          f"scheduled_events {r['scheduled_events']}", flush=True)
    for w, ph in enumerate(r["phase_timers"]):
        print(f"phase 5a wave {w}: bound {ph['bound']} " + " ".join(
            f"{k} {ph[k]:.4f}" for k in ("pump_s", "apply_s", "decode_s", "tensorize_s",
                                        "dispatch_s", "device_wait_s", "commit_s", "prep_s",
                                        "kernel_ms")),
              flush=True)
    idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
    print(f"phase 5a device idle share over the wall (1 - kernel_ms / wall): {idle:.4f}",
          flush=True)
    if launches < waves:
        raise AssertionError(f"churn launched the fused kernel {launches} times in {waves} waves")
    if st["oracle_pods"] != 0 or st["kernel_pods"] != r["drained"]:
        raise AssertionError("the churn path did not run every drained pod through the scan")
    if r["bound"] + r["unbound"] != n_pods or r["scheduled_events"] != r["bound"]:
        raise AssertionError(f"churn accounting: bound {r['bound']} unbound {r['unbound']} "
                             f"events {r['scheduled_events']} of {n_pods} pods")

    n_nodes, n_pods, waves, seed = 1000, 400, 4, 5
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=seed, device="cuda")
    o = oracle_replay_waves(r["drain_batches"], r["assignments"], n_nodes, n_pods,
                            "mixed", seed)
    print(f"phase 5b churn {n_nodes}x{n_pods} in {waves} waves vs per-wave oracle replay: "
          f"{o['mode']}, checked {o['checked']}, mismatches {o['mismatches']}, rr "
          f"{r['round_robin']} vs {o['round_robin']}", flush=True)
    if (o["mode"] != "exact per-wave replay" or o["checked"] != n_pods
            or o["mismatches"] != 0 or o["round_robin"] != r["round_robin"]):
        raise AssertionError(f"churn bindings != per-wave oracle replay: {o}")
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def wait_until(ready, proc: subprocess.Popen, what: str, deadline_s: float) -> None:
    """Poll ``ready()`` until it holds; fail if ``proc`` exits first or the
    deadline passes."""
    deadline = time.monotonic() + deadline_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"{what}: the process exited with {proc.returncode}")
        try:
            if ready():
                return
        except OSError:
            pass  # not listening yet
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not ready after {deadline_s} s")
        time.sleep(0.1)


class Daemons:
    """An apiserver and a leader-elected scheduler daemon as processes,
    their output in ``workdir``.  ``stop_scheduler`` sends SIGTERM and
    returns the daemon's stats line; ``close`` ends whatever still runs."""

    def __init__(self, workdir: str, tag: str):
        self.workdir, self.tag = workdir, tag
        self.api_port, self.health_port = free_port(), free_port()
        self.url = f"http://127.0.0.1:{self.api_port}"
        self.env = {**os.environ, "PYTHONPATH": ROOT}
        self.scheduler = None
        self.apiserver = self._spawn("apiserver", [
            "kubernetes_tpu_torch.apiserver", "--port", str(self.api_port),
            "--disable-admission"])
        try:
            wait_until(lambda: b"ok" in http_get(self.url + "/healthz"), self.apiserver,
                       "apiserver /healthz", 60)
        except BaseException:
            self.close()
            raise

    def _spawn(self, name: str, args: list) -> subprocess.Popen:
        base = os.path.join(self.workdir, f"{self.tag}-{name}")
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=self.env,
                                stdout=open(base + ".out", "w"),
                                stderr=open(base + ".err", "w"))

    def start_scheduler(self) -> None:
        self.scheduler = self._spawn("scheduler", [
            "kubernetes_tpu_torch.scheduler", "--apiserver", self.url, "--leader-elect",
            "--healthz-port", str(self.health_port)])
        health = f"http://127.0.0.1:{self.health_port}"
        wait_until(lambda: b"ok" in http_get(health + "/healthz"), self.scheduler,
                   "scheduler /healthz", 120)
        # /metrics shows the scheduler's registry once it leads and serves
        wait_until(lambda: E2E_METRIC.encode() in http_get(health + "/metrics"),
                   self.scheduler, "scheduler serving", 300)

    def e2e_quantiles_ms(self) -> tuple[float, float]:
        """p50 and p99 of the daemon's e2e SLI histogram from its /metrics
        (the upper bound of the bucket each quantile falls in)."""
        text = http_get(f"http://127.0.0.1:{self.health_port}/metrics").decode()
        buckets = []
        for line in text.splitlines():
            if line.startswith(E2E_METRIC + "_bucket"):
                le = line.split('le="', 1)[1].split('"', 1)[0]
                buckets.append((float(le), float(line.rsplit(" ", 1)[1])))
        total = buckets[-1][1]
        if total <= 0:
            raise AssertionError("the daemon recorded no e2e latency")
        return tuple(next(le for le, acc in buckets if acc >= q * total) / 1e3
                     for q in (0.5, 0.99))

    def stop_scheduler(self) -> dict:
        self.scheduler.send_signal(signal.SIGTERM)
        rc = self.scheduler.wait(timeout=120)
        if rc != 0:
            raise RuntimeError(f"the scheduler daemon exited {rc} on SIGTERM")
        out = open(os.path.join(self.workdir, f"{self.tag}-scheduler.out")).read()
        lines = [ln for ln in out.splitlines() if ln.startswith('{"scheduler_stats"')]
        if len(lines) != 1:
            raise AssertionError(f"expected one stats line from the daemon, got {len(lines)}")
        return json.loads(lines[0])["scheduler_stats"]

    def close(self) -> None:
        for proc in (self.scheduler, self.apiserver):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)

    def stderr_tail(self) -> str:
        path = os.path.join(self.workdir, f"{self.tag}-scheduler.err")
        return open(path).read()[-4000:] if os.path.exists(path) else ""


def daemon_phase() -> int:
    """Phase 6: the daemon stack at full width, then parity of a smaller
    daemon run with the sequential oracle.  Returns the fused-kernel
    launches of 6a, as the daemon counted them."""
    from kubernetes_tpu_torch.client import Clientset, RemoteStore
    from kubernetes_tpu_torch.workload import create_cluster, oracle_replay_waves, run_wire_churn

    t_6a = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        n_nodes, n_pods, waves = 5000, 20000, 10
        d = Daemons(workdir, "6a")
        try:
            d.start_scheduler()
            r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=0)
            p50, p99 = d.e2e_quantiles_ms()
            st = d.stop_scheduler()
            events, _ = RemoteStore(d.url, timeout=120.0).list("Event")
            scheduled = sum(e.get("count", 1) for e in events if e.get("reason") == "Scheduled")
        except BaseException:
            print(f"phase 6a scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
        c2b = r["create_to_bind_ms"]
        print(f"phase 6a daemons {n_nodes}x{n_pods} mixed in {waves} waves over HTTP: bound "
              f"{r['bound']} unbound {r['unbound']} wall_s {r['wall_s']:.3f} pods_per_s "
              f"{r['pods_per_sec']:.1f} create_to_bind_p50_ms {c2b['p50']:.1f} "
              f"create_to_bind_p99_ms {c2b['p99']:.1f} daemon_e2e_p50_ms {p50:.1f} "
              f"daemon_e2e_p99_ms {p99:.1f} launches {st['launches']} segments "
              f"{st['segments']} kernel_pods {st['kernel_pods']} oracle_pods "
              f"{st['oracle_pods']} drained {st['drained']} drains {st['waves']} kernel_ms "
              f"{st['kernel_ms']:.3f} scheduled_events {scheduled}", flush=True)
        print("phase 6a wave seconds: " + " ".join(f"{s:.3f}" for s in r["wave_s"]), flush=True)
        idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
        print(f"phase 6a device idle share over the wall (1 - kernel_ms / wall): {idle:.4f}; "
              f"batch path {st['batch_s']:.3f} s of the wall (tensorize {st['tensorize_s']:.3f}, "
              f"dispatch {st['dispatch_s']:.3f}, device wait {st['device_wait_s']:.3f}), the "
              f"rest wire, ingest and waiting: {1.0 - st['batch_s'] / r['wall_s']:.4f}; the "
              f"daemon's informers decoded {st['ingest_bytes']} wire bytes, typed decode "
              f"{st['ingest_decode_s']:.3f} s, apply {st['ingest_apply_s']:.3f} s",
              flush=True)
        if r["bound"] + r["unbound"] != n_pods or st["launches"] < waves:
            raise AssertionError(f"daemon run: bound {r['bound']} unbound {r['unbound']} "
                                 f"launches {st['launches']}")
        if st["oracle_pods"] != 0 or st["kernel_pods"] != st["drained"]:
            raise AssertionError("the daemon did not run every drained pod through the kernel")
        if scheduled != r["bound"]:
            raise AssertionError(f"{scheduled} Scheduled events for {r['bound']} bound pods")
        launches = st["launches"]

        t_6b = time.perf_counter()
        n_nodes, n_pods, seed = 1000, 400, 5
        d = Daemons(workdir, "6b")
        try:
            cs = Clientset(RemoteStore(d.url, timeout=120.0))
            pods = create_cluster(cs, n_nodes, n_pods, "mixed", seed)
            if any(x is None for x in cs.pods.create_many(pods)):
                raise AssertionError("a pod create failed")
            d.start_scheduler()
            deadline = time.monotonic() + 120
            while True:
                items, _ = cs.store.list("Pod")
                got = {f"default/{i['metadata']['name']}": i["spec"].get("nodeName") or None
                       for i in items}
                if all(got.values()) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            st = d.stop_scheduler()
        except BaseException:
            print(f"phase 6b scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
        # the daemon's informers listed every pod before its first drain, so
        # it drained them in LIST order (by name): replay that order
        o = oracle_replay_waves([sorted(got)], got, n_nodes, n_pods, "mixed", seed)
        print(f"phase 6b daemons {n_nodes}x{n_pods} pre-created vs the sequential oracle: "
              f"{o['mode']}, checked {o['checked']}, mismatches {o['mismatches']}, bound "
              f"{sum(1 for n in got.values() if n)}, drains {st['waves']}, rr "
              f"{st['round_robin']} vs {o['round_robin']}", flush=True)
        if (st["waves"] != 1 or st["drained"] != n_pods or o["checked"] != n_pods
                or o["mismatches"] != 0 or o["round_robin"] != st["round_robin"]):
            raise AssertionError(f"daemon bindings != sequential oracle: {o}, stats {st}")
    t_end = time.perf_counter()
    print(f"phase 6 took {t_end - t_6a:.1f} s: 6a {t_6b - t_6a:.1f} s (daemon start-up and "
          f"cluster creation included), 6b {t_end - t_6b:.1f} s", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import _build, fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.scheduler.generic_scheduler import FitError, GenericScheduler
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext

    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 1 card: {card}", flush=True)

    t0 = time.perf_counter()
    _build.build("fused_scan", verbose=True)  # prints ptxas registers and spills
    _build.load("fused_scan")
    print(f"phase 2 build: fused_scan {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 3: kernel vs plain on the card; oracle vs backend ----------
    for workload in ("mixed", "plain"):
        m, pods, pctx = cluster(1000, 2000, workload, seed=1)
        _, s, st = segment(m, pods, pctx, "cuda")
        r = compare(s, st)
        print(f"phase 3 {workload} 1000x2000: kernel == scan_ref, bound {r['bound']}/"
              f"{r['pods']}, rr {r['rr']}, max_abs_err {r['max_abs_err']}", flush=True)
    m, pods, pctx = cluster(1000, 300, "mixed", seed=2)
    oracle = GenericScheduler()
    work = {n: i.clone() for n, i in m.items()}
    wctx = PriorityContext(work, services=pctx.services)
    want = []
    for pod in pods:
        try:
            name = oracle.schedule(pod, work, wctx).node_name
            work[name].add_pod(pod)
        except FitError:
            name = None
        want.append(name)
    backend = BatchBackend(device="cuda")
    got = backend.schedule_batch(pods, m, pctx)
    if got != want or backend.algorithm._round_robin != oracle._round_robin:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"oracle != BatchBackend on 300-pod prefix: {bad} differ, rr "
                             f"{oracle._round_robin} vs {backend.algorithm._round_robin}")
    print(f"phase 3 oracle 1000x300: BatchBackend == GenericScheduler, rr "
          f"{oracle._round_robin}, kernel_pods {backend.stats['kernel_pods']}", flush=True)

    # -- phase 4: the main path at full width ------------------------------
    m, pods, pctx = cluster(5000, 20000, "mixed", seed=0)
    main_static, s_main, st_main = segment(m, pods, pctx, "cuda")
    backend = BatchBackend(device="cuda")
    torch.cuda.synchronize()
    fused_scan.launches = 0
    t0 = time.perf_counter()
    assignments = backend.schedule_batch(pods, m, pctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_scan.launches
    st = backend.stats
    n_bound = sum(a is not None for a in assignments)
    print(f"phase 4 main 5000x20000 mixed: bound {n_bound} unbound {len(pods) - n_bound} "
          f"segments {st['segments']} kernel_pods {st['kernel_pods']} oracle_pods "
          f"{st['oracle_pods']} launches {launches} tensorize_s {st['tensorize_s']:.3f} "
          f"dispatch_s {st['dispatch_s']:.3f} device_wait_s {st['device_wait_s']:.3f} "
          f"kernel_ms_per_segment {st['kernel_ms'] / max(st['segments'], 1):.3f} "
          f"wall_s {wall:.3f} pods_per_s {len(pods) / wall:.1f}", flush=True)
    if launches < 1 or st["oracle_pods"] != 0 or st["kernel_pods"] != len(pods):
        raise AssertionError("the main path did not run every pod through the fused kernel")
    if st["segments"] != 1:
        raise AssertionError(f"expected one segment, got {st['segments']}")

    # the main path's segment: its bindings against the plain version
    r_main = compare(s_main, st_main)
    names = [main_static.node_names[j] if j >= 0 else None for j in r_main["chosen"]]
    if names != assignments or backend.algorithm._round_robin != r_main["rr"]:
        raise AssertionError("BatchBackend bindings != scan_ref on the main-path segment")
    print(f"phase 4 main segment: kernel == scan_ref == BatchBackend, rr {r_main['rr']}",
          flush=True)
    # 5000 nodes take a cluster of 5 blocks; 10 000 take 8 blocks of two
    # column rounds each
    errs = [r_main["max_abs_err"]]
    for n_nodes, n_pods, seed in ((5000, 2000, 3), (10000, 1000, 4)):
        m2, pods2, pctx2 = cluster(n_nodes, n_pods, "mixed", seed=seed)
        _, s2, st2 = segment(m2, pods2, pctx2, "cuda")
        r2 = compare(s2, st2)
        errs.append(r2["max_abs_err"])
        print(f"phase 4 mixed {n_nodes}x{n_pods}: kernel == scan_ref, bound {r2['bound']}/"
              f"{r2['pods']}, rr {r2['rr']}", flush=True)

    ms = time_kernel(s_main, st_main)
    plain_ms = r_main["plain_ms"]
    bound_ms, bound_by, detail = bound(s_main, st_main)
    print(f"phase 4 times on the main segment ({s_main.n_pad} nodes x {s_main.p_real} pods): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({detail['bytes']} bytes, {detail['ops']} ops)", flush=True)

    churn_launches = churn_phase()
    daemon_launches = daemon_phase()

    entry = {
        "name": "fused_scan", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": REPLACES, "launches": launches + churn_launches + daemon_launches,
        "launches_by_path": {"batch": launches, "churn": churn_launches,
                             "daemon": daemon_launches},
        "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
