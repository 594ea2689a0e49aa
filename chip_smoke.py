#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

1. the card: name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from ``kubernetes_tpu_torch/ops/csrc`` (the fused
   scan and the frontier loop's refresh, one ``nvcc`` each, started
   together), and name which host helpers (``native.py``: the label
   matcher and the store's deep copy) serve, ``native`` or ``python``;
3. the kernel against its plain PyTorch version (``ops/scan_ref.py``) on
   the card, on 1000-node x 2000-pod ``mixed`` and ``plain`` segments; on
   the same ``mixed`` cluster with its zone label over 16 zones (the
   kernel's shared-memory zone path, timed beside the 3-zone segment),
   over 300 zones (shared memory at the plan's 4-block cluster) and over
   1000 zones (the global-memory zone path with its second fold), each
   with its plan line, time and bound; with 600 distinct host ports
   (``BatchBackend`` cuts the batch under a signature row's port slot;
   every segment is held against the plain scan, and the refresh kernel
   at its widest segment, timed); with one pod of 257
   host ports (a segment of its own whose port flags past the row's
   shared slot come from global memory, timed with its bound); a wave of
   50 pods and one with 257 host ports through
   ``Scheduler.schedule_pending_batch`` (all 51 bind, nothing is
   refused); and the port's sequential oracle against ``BatchBackend`` on
   a 300-pod prefix;
4. the main path at full width: ``BatchBackend(device="cuda")
   .schedule_batch`` of 20 000 ``mixed`` pods on 5000 nodes, four times in
   turns with the frontier off, on (the default: the device-resident loop
   of 512-pod chunks and refreshes), on, off, each with both kernels'
   launch counts read around it, its wall, kernel_ms and host syncs; all
   four bind alike; then the kernel against the plain version on that
   very segment, on a 5000-node x 2000-pod one, on a 10 000-node x
   1000-pod one and on a 20 000-node x 500-pod one (whose plan leaves
   planes in global memory), the kernel's plan (cluster and block size,
   the planes in shared memory), its times, one 512-pod chunk launch's
   time, the refresh kernel against its plain version at the main
   segment's width and at the 20 000-node segment's, with its device time,
   launch floor, host enqueue time and bound, and the frontier loop against
   one launch of the segment in turns;
5. the serving path: (a) ``workload.run_churn`` at full width, 20 000
   ``mixed`` pods arriving in 10 waves on 5000 nodes and served by the
   port's ``Scheduler.run_batch_loop`` on ``BatchBackend(device="cuda")``
   with events on, on the default ingest path (lazy decode, watch frames,
   columnar LIST, the frame confirm), the launch count read around it;
   (b) a 1000-node x 400-pod churn run on the card replayed wave by wave
   through the port's per-pod oracle (``workload.oracle_replay_waves``);
   (c) 5a and 5b again on the eager ingest path (typed decode of every
   event, per-event delivery): the same-call A/B of ingest, 5c's parity
   held like 5b's.  Every wave prints its frames, frame events, lazy
   promotions, confirm fallbacks and decode seconds; 5a and 5c print the
   ``DeviceNodeCache``'s reuses and the share of node columns uploaded;
6. the daemon stack: (a) ``python -m kubernetes_tpu_torch.apiserver`` and
   ``python -m kubernetes_tpu_torch.scheduler --leader-elect`` (its
   default ``--backend batch --device cuda``) as processes, driven over
   HTTP by ``workload.run_wire_churn`` at full width, 20 000 ``mixed`` pods
   in 10 waves on 5000 nodes; the fused kernel's launches are counted in
   the daemon, which starts at 0 and reports them when SIGTERM stops it,
   and each wave's ingest counters are read from the daemon's /metrics
   (over the wire also the watch readers' parse seconds; the waves plus
   what came after the last drain add up to the daemon's totals);
   (b) a fresh pair of daemons on 1000 nodes whose 400 pods exist before
   the scheduler starts, its bindings and round-robin counter read back
   and held against the port's sequential oracle;
7. preemption: (a) ``workload.run_preemption`` at full width, 5000 nodes
   filled by 20 000 priority-0 pods, then 2500 priority-100 preemptors
   (fill batch, failing batch, the cohort pass, follow-up batch; each
   batch a kernel launch): evictions per second, the cohort split (state
   build, ranking, evictions), victims == preemptors == bound after, the
   failing and follow-up batches' kernel segments against the plain scan;
   (b) 1000 nodes, 4000 fillers and 150 preemptors, a seeded tenth of
   them with a host port or a required affinity: every cohort decision
   held against the exhaustive ``find_preemption_target``, the later
   batches' kernel segments against the plain scan; (c) the two daemons
   at their defaults (batch backend, preemption on, leader election) over
   HTTP at 1000 nodes, 4000 fillers and 500 preemptors: every preemptor
   bound, the daemon's victims printed;
8. the upstream ``ClusterAutoscalerProvider`` as a policy file
   (``load_policy_file``) at 1000 x 2000 ``mixed``: the scan's ``most``
   weight plane, kernel == plain scan == the sequential oracle on it;
   (8b) the daemons with a ``ServiceSpreadingPriority`` policy, which the
   scan does not express, on ``--device cuda``: 6b's parity set binds on
   the host oracle, equal to the sequential oracle on the policy, with
   ``scheduler_backend_oracle_pods_total`` > 0 on /metrics;
9. tracing, faults and overload: (a) 6a's cell again with the daemon's
   ``--trace --timeseries --telemetry-sink``: its pods/s beside 6a's, the
   chrome trace from /debug/traces (one root span a wave, the
   ``tensorize`` spans' seconds equal to the daemon's ``tensorize_s``,
   the ``dispatch`` spans' launches and ``kernel_ms`` equal to its
   launches and ``kernel_ms``), the sink's time series covering every
   wave, and the
   per-wave idle share from the spans; (b) in process on the card, 1000
   nodes and 2000 ``mixed`` pods in five waves, one fault a wave from a
   seeded ``FaultPlan`` (``backend.pallas.segment``: the wave raises and
   its pods are requeued; ``scheduler.bind``: forget, requeue, rebind;
   ``scheduler.pipeline.prep``: contained; ``backend.compact`` at the
   frontier's prefilter: the wave raises and its pods are requeued, as
   for the kernel), each with a flight-recorder dump naming the point and
   its wave, the bindings against the per-wave oracle replay; (c) ``workload.run_overload`` at 5000 nodes
   (surge at 3x the calibrated drain for at most 20 s, recovery, tail):
   each tier's goodput and e2e p50/p99, the rung timeline, transitions,
   score-plane sheds and 429s; every segment scanned with the interpod
   score plane shed is held against the plain scan afterwards, the
   ladder must engage and recover, and the tail at rung 0 must equal the
   oracle replay;
10. a pool that fills: 1024 nodes, half of them taking 4 pods and half 110,
   and 10 000 identical pods at the default frontier settings (what a
   batch job draining into a nearly full node pool sends): a
   ``backend.compact`` fault at the first compaction raises; then the
   frontier route binds the batch, compacting at least once, equal to the
   full-width kernel and to the plain scan, with at most compactions + 2
   host syncs; the refresh kernel is held against its plain version at
   every loop exit and timed at the pool's width; the widths trajectory
   and times are printed, and
   ``gather_node_axis`` is timed alone on the first compaction's inputs
   (phase 4 also times ``DeviceNodeCache``'s upload of the main segment's
   node statics);
11. the apiserver as the JAX package starts it (no ``--disable-admission``:
   the default admission chain on; earlier phases keep the flag): (a) 1000
   nodes, a tenth tainted ``node.alpha.kubernetes.io/unreachable:NoExecute``,
   a namespace, a LimitRange (100m / 128Mi default requests), two
   PriorityClasses and a pod quota; 2000 pods with no requests POSTed one
   at a time (half naming ``high``) and three that must answer 403 (past
   the quota, a missing namespace, a missing class); every stored pod
   carries the admitted requests, tolerations and priority, some bind to
   the tainted nodes, the daemon's bindings and rr equal the sequential
   oracle over the objects as read back, and the in-process batch path
   over them has kernel == scan_ref on every segment; (b) 6a's cell in 5
   waves through a ``--data-dir`` apiserver, SIGKILLed while wave 3 is
   being bound and restarted on the same port and directory under the
   same scheduler daemon: every bind of the LIST before the kill reads
   back, every pod ends bound, no node over capacity, the daemon's watch
   reconnects on /metrics, the recovery line printed, waves 1-2's pods/s
   beside 6a's; (c) what ``--fsync`` costs: a 2000-pod wave at 5000 nodes
   under no flag, ``--data-dir`` and ``--data-dir --fsync``, three of
   each interleaved, create and bind seconds and create->bind p99 per arm.

Every comparison is exact (chosen node index per pod and the final
round-robin counter; ``max_abs_err`` is the largest index difference).
Kernel times are device times (``device_ms``): the launches, their inputs
made beforehand, are enqueued between two CUDA events behind a device-side
sleep that outlasts the host's enqueueing, so the window holds no host
work.
No phase refuses a pod: the backend has no refusal left.
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
import threading
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


def cluster(n_nodes: int, n_pods: int, workload: str, seed: int, zones: int = 0,
            host_ports: int = 0):
    """A seeded cluster; ``zones`` relabels the nodes' zone over that many
    zones, ``host_ports`` gives every third pod its own host port."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext
    from kubernetes_tpu_torch.workload import ZONE, make_nodes, make_pods, make_services

    rng = random.Random(seed)
    nodes = make_nodes(n_nodes, rng, workload)
    pods = make_pods(n_pods, rng, workload)
    for i, n in enumerate(nodes if zones else ()):
        n.meta.labels[ZONE] = f"zone-{i % zones}"
    for k in range(host_ports):
        pod = api.Pod.from_dict(pods[3 * k].to_dict())
        pod.spec.containers[0].ports = [api.ContainerPort(container_port=20000 + k,
                                                          host_port=20000 + k)]
        pods[3 * k] = pod
    m = {n.meta.name: NodeInfo(n) for n in nodes}
    return m, pods, PriorityContext(m, services=make_services())


def segment(m, pods, pctx, device, frontier: bool = False):
    """One segment tensorized exactly as BatchBackend tensorizes its first
    segment of the same batch, carried to ``device``; ``frontier`` seeds
    its ``still_ok`` plane (``frontier_seed``) for a frontier loop."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import HostBatchState, Tensorizer, frontier_seed
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
    if frontier:
        frontier_seed(static, init)
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


# the longest the host may take to enqueue one timed window, in device clock
# cycles at the H100's 1.98 GHz top SM clock (a slower clock sleeps longer)
SLEEP_S = 0.05


def device_ms(launches: list) -> tuple[float, float]:
    """(ms a launch on the device, the host's median ms to enqueue one).
    ``launches`` are zero-argument callables whose inputs were all made
    beforehand.  They are enqueued back to back between two CUDA events
    behind a device-side sleep that outlasts the host's enqueueing, so the
    window holds the launches and nothing of the host; raises if the
    device reached the window before the host had enqueued them all."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = []
    torch.cuda._sleep(int(SLEEP_S * 1.98e9))
    start.record()
    for fn in launches:
        t = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t)
    end.record()
    behind = start.query()  # the device already past the window's start
    end.synchronize()
    if behind:
        raise AssertionError(f"the host took longer than the {SLEEP_S} s sleep to enqueue "
                             f"{len(launches)} launches: the window is not the device's alone")
    return start.elapsed_time(end) / len(launches), sorted(host)[len(host) // 2] * 1e3


def time_kernel(s, st, reps: int = 3) -> float:
    """ms per launch of the whole-segment scan on the device (``device_ms``);
    each launch gets its own freshly packed state (the kernel updates its
    state planes in place), packed before the window."""
    from kubernetes_tpu_torch.ops import fused_scan

    fused_scan.launch(s, st, fused_scan.pack(s, st))  # warm-up
    ring = [fused_scan.pack(s, st) for _ in range(reps)]
    return device_ms([lambda b=b: fused_scan.launch(s, st, b) for b in ring])[0]


def batch_run(m, pods, pctx, frontier: bool) -> dict:
    """One ``BatchBackend(device="cuda", frontier=...)`` batch with both
    kernels' launch counts set to 0 just before it and read just after."""
    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    backend = BatchBackend(device="cuda", frontier=frontier)
    torch.cuda.synchronize()
    fused_scan.launches = frontier_refresh.launches = 0
    t0 = time.perf_counter()
    assignments = backend.schedule_batch(pods, m, pctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, refresh = fused_scan.launches, frontier_refresh.launches
    st = backend.stats
    n_bound = sum(a is not None for a in assignments)
    lf = backend.last_frontier
    print(f"phase 4 main {len(m)}x{len(pods)} mixed, frontier {'on' if frontier else 'off'}: "
          f"bound {n_bound} unbound {len(pods) - n_bound} segments {st['segments']} kernel_pods "
          f"{st['kernel_pods']} oracle_pods {st['oracle_pods']} launches {launches} "
          f"refresh_launches {refresh} host_syncs {st['host_syncs']} tensorize_s "
          f"{st['tensorize_s']:.3f} dispatch_s {st['dispatch_s']:.3f} device_wait_s "
          f"{st['device_wait_s']:.3f} kernel_ms {st['kernel_ms']:.3f} wall_s {wall:.3f} "
          f"pods_per_s {len(pods) / wall:.1f} frontier {lf}", flush=True)
    if launches < 1 or st["oracle_pods"] != 0 or st["kernel_pods"] != len(pods):
        raise AssertionError("the main path did not run every pod through the fused kernel")
    if st["segments"] != 1:
        raise AssertionError(f"expected one segment, got {st['segments']}")
    if frontier and (refresh < 1 or not lf or lf[0]["mode"] != "loop"
                     or st["host_syncs"] > lf[0]["compactions"] + 2):
        raise AssertionError(f"the frontier route did not run its loop: {lf}, {st}")
    if not frontier and (refresh or lf or st["host_syncs"] != 1):
        raise AssertionError(f"the frontier was off but ran: {lf}, {st}")
    return {"frontier": frontier, "assignments": assignments, "wall": wall,
            "rr": backend.algorithm._round_robin, "launches": launches,
            "refresh_launches": refresh, "stats": dict(st)}


def time_chunk(s, st, chunk: int = 512, reps: int = 5) -> float:
    """ms of one chunk launch of the frontier loop (the segment's first
    ``chunk`` pods, the counter from device memory, the state written
    back) on the device (``device_ms``), each on its own freshly packed
    state and control words."""
    import torch

    from kubernetes_tpu_torch.ops import fused_scan

    pl = fused_scan.plan(s)
    ring = [(fused_scan.pack(s, st, pl),
             torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=s.device))
            for _ in range(reps + 1)]

    def chunk_launch(bufs, ctl):
        return lambda: fused_scan.launch(s, st, bufs, pl, start=0, count=min(chunk, s.p_real),
                                         ctl=ctl)

    chunk_launch(*ring.pop())()  # warm-up
    return device_ms([chunk_launch(*x) for x in ring])[0]


def refresh_bound(s, pl, bufs) -> tuple[float, str]:
    """Least time for one refresh at this width: what the kernel reads and
    writes, each once, over HBM bandwidth (still_ok read and written, the
    byte copy of static_ok, the column state rows, the dm, downer and
    host-port rows some signature names, the signature table at its width
    ``tw``, alive written) against its integer operations (per column and
    signature: 4, 2 a resource it requests, 1 a row it names) over the
    non-tensor 32-bit rate."""
    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh

    rp = frontier_refresh.plan(s, pl)
    table, _ = frontier_refresh.tables(s, bufs, rp)
    g, r, ns = table.shape[0], s.node_alloc.shape[1], pl.ns
    n_named = table[:, r]
    ids = table[:, r + 1:]
    named = ids[torch.arange(ids.shape[1], device=ids.device) < n_named[:, None]]
    rows = 2 * r + 3 + int(named.unique().numel())
    nbytes = g * ns * (1 + 1 + 1) + rows * ns * 4 + ns + g * rp.tw * 4
    ops = ns * (4 * g + 2 * int((table[:, :r] > 0).sum()) + int(n_named.sum()))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def refresh_cell(what: str, s, st, launches: int = 200, launch=None) -> dict:
    """The refresh kernel at a segment's width: the state after the
    segment's first chunk (up to 512 pods, one chunk launch), from an
    all-True plane (the plane is then the monotone plane itself), held
    against ``scan_ref.refresh`` on the unpacked state.  Its device ms a
    launch over ``launches`` launches (``device_ms``: a ring of fresh
    planes and control words, one a launch), the launch floor (the same
    ring with the stop flag raised: no launch writes anything), the host's
    enqueue ms (of the ring, and of relaunches on the same tensors, as the
    loop launches), the plain version's ms and the bound.  ``launch``
    (``frontier_refresh.launch``'s signature; that function by default)
    is the refresh measured.  Returns the measurements."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, scan_ref

    launch = launch or frontier_refresh.launch

    pl = fused_scan.plan(s)
    rp = frontier_refresh.plan(s, pl)
    bufs = fused_scan.pack(s, st, pl)
    ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=s.device)
    ctl[fused_scan.CTL_RR] = st.round_robin
    fused_scan.launch(s, st, bufs, pl, start=0, count=min(512, s.p_real), ctl=ctl)
    state = fused_scan.unpack_state(s, bufs, int(ctl[fused_scan.CTL_RR]))
    g, n = s.static_ok.shape[0], s.n_pad
    ones = torch.zeros((g, pl.ns), dtype=torch.bool, device=s.device)
    ones[:, :n] = True
    thresh = n // 2
    still, alive = ones.clone(), torch.zeros(pl.ns, dtype=torch.bool, device=s.device)
    ctl[fused_scan.CTL_STOP] = 0
    launch(s, bufs, pl, still, alive, ctl, thresh)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want, want_alive, want_n, want_stop = scan_ref.refresh(
        s, dataclasses.replace(state, still_ok=ones[:, :n].clone()), thresh)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(int((still[:, :n] != want.still_ok).sum()), int((alive[:n] != want_alive).sum()),
              abs(int(ctl[fused_scan.CTL_ALIVE]) - want_n),
              int(bool(ctl[fused_scan.CTL_STOP]) != want_stop), int(still[:, n:].sum()),
              int(alive[n:].sum()))

    def ring(stop: int) -> list:
        planes = [ones.clone() for _ in range(launches)]
        ctls = torch.zeros((launches, fused_scan.CTL_WORDS), dtype=torch.int32, device=s.device)
        ctls[:, fused_scan.CTL_STOP] = stop
        return [lambda i=i: launch(s, bufs, pl, planes[i], alive, ctls[i], thresh)
                for i in range(launches)]

    ms, host_ms = device_ms(ring(0))
    floor_ms, _ = device_ms(ring(1))
    # the loop's case: the same plane and control words every launch (the
    # stop flag raised: no-ops), by the host clock alone
    ctl[fused_scan.CTL_STOP] = 1
    host = []
    for _ in range(50):
        t = time.perf_counter()
        launch(s, bufs, pl, still, alive, ctl, thresh)
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    host_same_ms = sorted(host)[len(host) // 2] * 1e3
    bound_ms, bound_by = refresh_bound(s, pl, bufs)
    pv = s.g_ports.shape[1] if s.use_ports else 0
    print(f"phase {what}: frontier_refresh at {g} signatures x {pl.ns} columns (terms "
          f"{s.term_matches_sig.shape[0] if s.use_terms else 0}, host-port slots {pv}), after "
          f"{min(512, s.p_real)} pods: kernel == scan_ref.refresh (alive {want_n}, stop "
          f"{want_stop}), mismatches {err}; plan {rp.tiles}x{rp.groups} blocks of {rp.threads} "
          f"threads ({rp.cols} columns x {rp.gs} signatures), {rp.smem_bytes} B shared, {rp.kcap} "
          f"named rows a stage; device {ms:.5f} ms a launch over {launches}, launch floor "
          f"{floor_ms:.5f} ms, host enqueue {host_ms:.5f} ms (median; {host_same_ms:.5f} ms "
          f"relaunching the same tensors, as the loop does), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms by {bound_by}", flush=True)
    if err:
        raise AssertionError(f"frontier_refresh != scan_ref.refresh at {what}: {err} mismatches")
    return {"signatures": g, "columns": pl.ns, "port_slots": pv, "max_abs_err": err, "ms": ms,
            "floor_ms": floor_ms, "host_ms": host_ms, "host_same_ms": host_same_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def loop_cell(s, st, card: str, refresh=None) -> dict:
    """The frontier loop against one launch of the whole segment, in turns
    (one, loop, loop, one) on the main segment seeded for the frontier,
    after a loop run that loads every kernel the loop launches: the loop's
    device time (read from ``FrontierRun.kernel_ms``; its chunk and
    refresh launches enqueued behind a device-side sleep that starts once
    the run has packed, through its ``on_loop`` seam; raises if the device
    woke before the host had enqueued them) against the single launch's
    (``time_kernel``), their bindings alike.  ``refresh``
    (``frontier_refresh.launch``'s signature) stands in for the refresh
    kernel in the loop's arms.  Returns the times."""
    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.ops.frontier import FrontierRun

    one_chosen, one_rr = fused_scan.schedule(s, st)
    times = {"one": [], "loop": []}
    asleep = torch.cuda.Event()

    def window(*_):  # the run has packed; its launches come next
        torch.cuda.synchronize()
        torch.cuda._sleep(int(SLEEP_S * 1.98e9))
        asleep.record()

    kernel = frontier_refresh.launch
    frontier_refresh.launch = refresh or kernel
    try:
        FrontierRun(s, st).finalize()
        for arm in ("one", "loop", "loop", "one"):
            if arm == "one":
                times[arm].append(time_kernel(s, st, reps=1))
                continue
            run = FrontierRun(s, st, on_loop=window)
            if asleep.query():
                raise AssertionError(f"the host took longer than the {SLEEP_S} s sleep to "
                                     "enqueue the loop: its window is not the device's alone")
            chosen, rr = run.finalize()
            if (run.stats["loop_runs"] != 1 or rr != one_rr
                    or not (chosen == one_chosen.astype(chosen.dtype)).all()):
                raise AssertionError(f"the main segment's loop: {run.stats}, rr {rr} vs {one_rr}")
            times[arm].append(run.kernel_ms)
    finally:
        frontier_refresh.launch = kernel
    one, loop = sum(times["one"]) / 2, sum(times["loop"]) / 2
    chunks = -(-s.p_real // 512)
    print(f"phase 4 the loop ({chunks} chunks and refreshes) against one launch, in turns: "
          f"one {times['one'][0]:.3f} / {times['one'][1]:.3f} ms, loop {times['loop'][0]:.3f} / "
          f"{times['loop'][1]:.3f} ms; the loop's gap {loop - one:.3f} ms, "
          f"{(loop - one) / chunks * 1e3:.1f} us a chunk boundary; card {card}", flush=True)
    return {"chunks": chunks, "ms": times, "gap_ms": loop - one}


def plan_line(what: str, s, st) -> str:
    """The fused kernel's plan for a segment, as the card accepts it."""
    from kubernetes_tpu_torch.ops import fused_scan

    pl = fused_scan.plan(s)
    q = fused_scan.query(s, st, fused_scan.pack(s, st, pl), pl)
    if q["static_smem"] > fused_scan.STATIC_RESERVE:
        raise AssertionError(f"the kernel's static shared memory ({q['static_smem']} B) exceeds "
                             f"the planner's reserve ({fused_scan.STATIC_RESERVE} B)")
    return (f"phase 4 plan, {what} ({s.n_pad} nodes): cluster {pl.cs} blocks x {pl.threads} "
            f"threads, {pl.cols} columns a block, {pl.cpt} a thread; dynamic shared memory "
            f"{pl.smem_bytes} B + static {q['static_smem']} B a block; max active clusters "
            f"{q['max_active_clusters']}; in shared memory: {' '.join(pl.shared) or '-'}; in "
            f"global memory: {' '.join(pl.global_) or '-'}")


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
                   if k not in ("chosen", "rr_out", "res", "zbuf"))  # the kernel's scratch
    n, r = s.node_alloc.shape
    gids = s.group_of_pod.long()
    term_count = bufs["sig"][:, r + 3].long()  # active terms of each signature
    terms = term_count[gids].sum().item() if s.use_terms else 0
    slots = s.pod_vol_valid.sum().item() if s.use_vols else 0
    per_pod = 3 * r + 4 + 60 + (2 * s.g_ports.shape[1] if s.use_ports else 0) \
        + (4 * s.vol_limits.shape[0] if s.use_vols else 0)
    ops = n * (per_pod * s.p_real + 8 * terms + 8 * slots)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    detail = {"bytes": in_bytes + out_bytes, "ops": ops}
    return (t_bytes, "bytes", detail) if t_bytes >= t_ops else (t_ops, "operations", detail)


def checking_backend(seen: list, skip: int = 0):
    """A ``BatchBackend`` class whose kernel segments, after the first
    ``skip``, are each held against the plain scan on that segment's
    inputs before the backend launches it; ``seen`` collects (plan,
    compare result, ScanStatic, ScanState) per checked segment, and the
    class's ``check_s`` the checks' wall seconds.  Each check launches
    the kernel once more (``fused_scan.launches``)."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    class Checked(BatchBackend):
        dispatches = 0
        check_s = 0.0

        def _dispatch(self, static, init):
            self.dispatches += 1
            if self.dispatches > skip:
                t = time.perf_counter()
                s, st = from_reference(vars(static), vars(init), self.device)
                seen.append((fused_scan.plan(s), compare(s, st), s, st))
                Checked.check_s += time.perf_counter() - t
            return super()._dispatch(static, init)

    return Checked


def checked_batch(m, pods, pctx, algorithm=None) -> tuple:
    """``BatchBackend(device="cuda")`` over the batch, each segment's kernel
    held against the plain scan on that segment's inputs before the
    backend launches it.  Returns (bindings, [(plan, compare result,
    ScanStatic, ScanState) per segment], backend)."""
    seen = []
    backend = checking_backend(seen)(algorithm=algorithm, device="cuda")
    got = backend.schedule_batch(pods, m, pctx)
    return got, seen, backend


def oracle_bindings(m, pods, pctx, algorithm) -> list:
    """The sequential oracle over ``pods`` on a copy of ``m``: each pod's
    node (None if it fits nowhere), placements fed back."""
    from kubernetes_tpu_torch.scheduler.generic_scheduler import FitError
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext

    work = {n: i.clone() for n, i in m.items()}
    wctx = PriorityContext(work, services=pctx.services)
    want = []
    for pod in pods:
        try:
            name = algorithm.schedule(pod, work, wctx).node_name
            work[name].add_pod(pod)
        except FitError:
            name = None
        want.append(name)
    return want


def wide_wave() -> None:
    """Phase 3's wave that the card used to refuse: 50 ordinary pods and
    one with 257 host ports through ``Scheduler.schedule_pending_batch``
    on the card.  All 51 bind; nothing fails or is refused."""
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    cs = Clientset(Store())
    for i in range(4):
        cs.nodes.create(make_node(f"n{i}", cpu="8", memory="16Gi"))
    for i in range(50):
        cs.pods.create(make_pod(f"p{i:03d}", cpu="100m"))
        if i == 25:
            cs.pods.create(make_pod("wide", cpu="100m", host_ports=list(
                range(20000, 20000 + fused_scan.MAX_PORTS + 1))))
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cuda")
    sched = Scheduler(cs, algorithm=algo, backend=backend)
    sched.start()
    before = fused_scan.launches
    bound, failed = sched.schedule_pending_batch()
    placed = {p.meta.name: p.spec.node_name for p in cs.pods.list()[0]}
    failed_events = [e for e in cs.events.list()[0] if e.reason == "FailedScheduling"]
    print(f"phase 3 a wave of 50 pods and 1 with {fused_scan.MAX_PORTS + 1} host ports through "
          f"schedule_pending_batch on the card: bound {bound}, failed {failed}, segments "
          f"{backend.stats['segments']}, kernel_pods {backend.stats['kernel_pods']}, oracle_pods "
          f"{backend.stats['oracle_pods']}, launches {fused_scan.launches - before}, the wide "
          f"pod on {placed['wide']}, FailedScheduling events {len(failed_events)}", flush=True)
    if ((bound, failed) != (51, 0) or not all(placed.values()) or failed_events
            or backend.stats["kernel_pods"] != 51 or "refused_pods" in backend.stats):
        raise AssertionError("the wide pod's wave did not bind whole on the card")


def shape_cell(what: str, pl, r: dict, s, st) -> dict:
    """Time a repaired shape's segment, print its plan line, and return
    its kernel-table cell (kernel, plain and bound ms)."""
    ms = time_kernel(s, st)
    b_ms, b_by, detail = bound(s, st)
    print(f"phase 3 {what}: plan cluster {pl.cs} blocks x {pl.threads} threads, zone "
          f"statistics in {pl.zones_at} memory (msg_a {pl.msg_a} words, zone arrays at "
          f"{pl.zone_off}), signature row {pl.sw} ints ({pl.sws} in shared memory); kernel == "
          f"scan_ref, bound {r['bound']}/{r['pods']}, rr {r['rr']}; kernel {ms:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({detail['bytes']} bytes, "
          f"{detail['ops']} ops)", flush=True)
    return {"ms": ms, "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "nodes": int(s.node_alloc.shape[0]), "pods": int(s.p_real), "cluster": pl.cs,
            "zones": int(s.num_zones), "zones_at": pl.zones_at, "sw": pl.sw, "sws": pl.sws}


def repaired_shapes() -> tuple[list, dict]:
    """Phase 3's shapes the kernel used to refuse: 16, 300 and 1000 zones,
    600 distinct host ports (and the refresh at that batch's widest port
    row), and one pod with 257.  Returns their max_abs_err and the timed
    cells."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import fused_scan

    errs, cells = [], {}
    m, pods, pctx = cluster(1000, 2000, "mixed", seed=1, zones=16)
    got, seen, backend = checked_batch(m, pods, pctx)
    (pl, r, s, st), = seen
    if s.num_zones != 16 or backend.stats["kernel_pods"] != len(pods):
        raise AssertionError(f"16-zone batch: {s.num_zones} zones, {len(seen)} segments")
    zone_ms = time_kernel(s, st)
    _, s3, st3 = segment(*cluster(1000, 2000, "mixed", seed=1), "cuda")
    reg_ms = time_kernel(s3, st3)
    errs.append(r["max_abs_err"])
    print(f"phase 3 mixed 1000x2000 over 16 zones: kernel == scan_ref, bound {r['bound']}/"
          f"{r['pods']}, rr {r['rr']}, max_abs_err {r['max_abs_err']}; shared-memory zone path "
          f"(msg_a {pl.msg_a} words, zone arrays at {pl.zone_off}) {zone_ms:.3f} ms against "
          f"{reg_ms:.3f} ms for the same cluster's 3-zone segment (register path)", flush=True)

    for zones, where in ((300, "shared"), (1000, "global")):
        m, pods, pctx = cluster(1000, 2000, "mixed", seed=1, zones=zones)
        got, seen, backend = checked_batch(m, pods, pctx)
        (pl, r, s, st), = seen
        if (s.num_zones != zones or pl.zones_at != where
                or backend.stats["kernel_pods"] != len(pods)):
            raise AssertionError(f"{zones}-zone batch: {s.num_zones} zones in {pl.zones_at} "
                                 f"memory, kernel_pods {backend.stats['kernel_pods']}")
        errs.append(r["max_abs_err"])
        cells[f"zones_{zones}"] = shape_cell(f"mixed 1000x2000 over {zones} zones", pl, r, s, st)

    m, pods, pctx = cluster(1000, 2000, "mixed", seed=1, host_ports=600)
    got, seen, backend = checked_batch(m, pods, pctx)
    widths = [s.g_ports.shape[1] for _, _, s, _ in seen]
    errs += [r["max_abs_err"] for _, r, _, _ in seen]
    if (max(widths) > fused_scan.MAX_PORTS or backend.stats["kernel_pods"] != len(pods)
            or len(seen) < 3):
        raise AssertionError(f"600-port batch: port widths {widths}, {len(seen)} segments, "
                             f"kernel_pods {backend.stats['kernel_pods']}")
    print(f"phase 3 mixed 1000x2000 with 600 distinct host ports: {len(seen)} segments cut "
          f"under the kernel's {fused_scan.MAX_PORTS}-port vocabulary (port widths "
          f"{widths}), every segment kernel == scan_ref, bound "
          f"{sum(g is not None for g in got)}/{len(pods)}, max_abs_err {max(errs[3:])}",
          flush=True)
    _, _, s, st = max(seen, key=lambda x: x[2].g_ports.shape[1])
    cells["refresh_ports_600"] = refresh_cell(
        "3 mixed 1000x2000 with 600 distinct host ports, its widest segment", s, st)

    m, pods, pctx = cluster(1000, 2000, "mixed", seed=1)
    wide = api.Pod.from_dict(pods[25].to_dict())
    wide.spec.containers[0].ports = [api.ContainerPort(container_port=20000 + k,
                                                       host_port=20000 + k)
                                     for k in range(fused_scan.MAX_PORTS + 1)]
    pods[25] = wide
    got, seen, backend = checked_batch(m, pods, pctx)
    errs += [r["max_abs_err"] for _, r, _, _ in seen]
    wide_segs = [x for x in seen if x[0].sws < x[0].sw]
    if (len(wide_segs) != 1 or wide_segs[0][2].p_real != 1
            or backend.stats["kernel_pods"] != len(pods) or backend.stats["oracle_pods"] != 0):
        raise AssertionError(f"257-port pod: {len(seen)} segments, {len(wide_segs)} wide, "
                             f"kernel_pods {backend.stats['kernel_pods']}")
    print(f"phase 3 mixed 1000x2000 with one pod of {fused_scan.MAX_PORTS + 1} host ports: "
          f"{len(seen)} segments (the pod alone in the middle one), every segment kernel == "
          f"scan_ref, bound {sum(g is not None for g in got)}/{len(pods)}, the wide pod on "
          f"{got[25]}; port widths {[x[2].g_ports.shape[1] for x in seen]}", flush=True)
    cells["wide_port_257"] = shape_cell("the 257-port pod's segment", *wide_segs[0])
    return errs, cells


def other_segments() -> tuple[list, dict]:
    """Phase 4's other segments, kernel against the plain version; returns
    their max_abs_err and the refresh's cell at the 20 000-node segment's
    width.  5000 and 10 000 nodes keep every plane in 16 blocks' shared
    memory; 20 000 nodes leave spread and the node rows in global memory.
    Their clusters are freed on return, so the later phases' garbage
    collections do not walk them."""
    from kubernetes_tpu_torch.ops import fused_scan

    errs, cell = [], None
    for n_nodes, n_pods, seed in ((5000, 2000, 3), (10000, 1000, 4), (20000, 500, 6)):
        m, pods, pctx = cluster(n_nodes, n_pods, "mixed", seed=seed)
        _, s, st = segment(m, pods, pctx, "cuda")
        r = compare(s, st)
        errs.append(r["max_abs_err"])
        print(f"phase 4 mixed {n_nodes}x{n_pods}: kernel == scan_ref, bound {r['bound']}/"
              f"{r['pods']}, rr {r['rr']}", flush=True)
        if n_nodes == 20000:
            print(plan_line(f"mixed {n_nodes}x{n_pods}", s, st), flush=True)
            if not fused_scan.plan(s).global_:
                raise AssertionError("the 20 000-node segment was meant to leave planes "
                                     "in global memory")
            cell = refresh_cell(f"4 mixed {n_nodes}x{n_pods}", s, st)
    return errs, cell


INGEST_KEYS = ("frames", "frame_events", "promotions", "confirm_fallbacks", "decode_s")
# over the wire the watch readers also parse each line before the decode
WIRE_KEYS = INGEST_KEYS + ("parse_s",)
SECONDS_KEYS = ("decode_s", "parse_s")


def ingest_line(ph: dict, keys: tuple = INGEST_KEYS) -> str:
    return " ".join(f"{k} {ph[k]:.4f}" if k in SECONDS_KEYS else f"{k} {int(ph[k])}"
                    for k in keys)


def churn_phase(lazy_ingest: bool = True) -> tuple:
    """Phase 5: the serving path at full width, then per-wave oracle parity
    of a smaller churn run; ``lazy_ingest=False`` runs both on the eager
    ingest path (phase 5c).  Returns ((the fused-scan and the refresh
    kernels' launches of the full-width run), its pods/s)."""
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.workload import oracle_replay_waves, run_churn

    a, b = ("5a", "5b") if lazy_ingest else ("5c", "5c parity")
    path = "lazy, framed ingest" if lazy_ingest else "eager ingest"
    n_nodes, n_pods, waves = 5000, 20000, 10
    fused_scan.launches = frontier_refresh.launches = 0
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=0, device="cuda",
                  lazy_ingest=lazy_ingest)
    launches, refresh = fused_scan.launches, frontier_refresh.launches
    st = r["backend"]
    nc = r["node_cache"]
    e2e = r["e2e_scheduling_ms"]
    print(f"phase {a} churn {n_nodes}x{n_pods} mixed in {waves} waves, {path}: bound {r['bound']} "
          f"unbound {r['unbound']} drained {r['drained']} wall_s {r['wall_s']:.3f} "
          f"pods_per_s {r['pods_per_sec']:.1f} e2e_p50_ms {e2e['p50']} e2e_p99_ms {e2e['p99']} "
          f"launches {launches} segments {st['segments']} kernel_pods {st['kernel_pods']} "
          f"oracle_pods {st['oracle_pods']} kernel_ms {st['kernel_ms']:.3f} "
          f"scheduled_events {r['scheduled_events']}; frontier segments "
          f"{st['frontier_segments']} compactions {st['frontier_compactions']} refresh_launches "
          f"{refresh} host_syncs {st['host_syncs']}; DeviceNodeCache reuses {nc['reuses']} "
          f"col_updates {nc['col_updates']} uploads {nc['uploads']} upload fraction "
          f"{nc['dirty_cols'] / max(nc['cols_total'], 1):.4f} ({nc['dirty_cols']} of "
          f"{nc['cols_total']} columns)", flush=True)
    for w, ph in enumerate(r["phase_timers"]):
        print(f"phase {a} wave {w}: bound {ph['bound']} " + " ".join(
            f"{k} {ph[k]:.4f}" for k in ("pump_s", "apply_s", "tensorize_s", "dispatch_s",
                                        "device_wait_s", "commit_s", "prep_s", "kernel_ms"))
              + " " + ingest_line(ph), flush=True)
    idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
    print(f"phase {a} device idle share over the wall (1 - kernel_ms / wall): {idle:.4f}",
          flush=True)
    totals = {k: sum(ph[k] for ph in r["phase_timers"]) for k in INGEST_KEYS}
    if lazy_ingest and (totals["frames"] <= 0 or totals["promotions"] <= 0):
        raise AssertionError(f"the default ingest path ran no frames or promotions: {totals}")
    if not lazy_ingest and (totals["frames"] or totals["promotions"]):
        raise AssertionError(f"the eager ingest path ran frames or lazy views: {totals}")
    if launches < waves:
        raise AssertionError(f"churn launched the fused kernel {launches} times in {waves} waves")
    if st["oracle_pods"] != 0 or st["kernel_pods"] != r["drained"]:
        raise AssertionError("the churn path did not run every drained pod through the scan")
    if r["bound"] + r["unbound"] != r["pods"] or r["scheduled_events"] != r["bound"]:
        raise AssertionError(f"churn accounting: bound {r['bound']} unbound {r['unbound']} "
                             f"events {r['scheduled_events']} of {n_pods} pods")

    pods_per_s = r["pods_per_sec"]

    n_nodes, n_pods, waves, seed = 1000, 400, 4, 5
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=seed, device="cuda",
                  lazy_ingest=lazy_ingest)
    for w, ph in enumerate(r["phase_timers"]):
        print(f"phase {b} wave {w}: bound {ph['bound']} " + ingest_line(ph), flush=True)
    o = oracle_replay_waves(r["drain_batches"], r["assignments"], n_nodes, n_pods,
                            "mixed", seed)
    print(f"phase {b} churn {n_nodes}x{n_pods} in {waves} waves, {path}, vs per-wave oracle "
          f"replay: {o['mode']}, checked {o['checked']}, mismatches {o['mismatches']}, rr "
          f"{r['round_robin']} vs {o['round_robin']}", flush=True)
    if (o["mode"] != "exact per-wave replay" or o["checked"] != r["pods"]
            or o["mismatches"] != 0 or o["round_robin"] != r["round_robin"]):
        raise AssertionError(f"churn bindings != per-wave oracle replay: {o}")
    return (launches, refresh), pods_per_s


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
    their output in ``workdir``.  The apiserver runs with
    ``--disable-admission`` unless ``admitted`` (then at its defaults: the
    admission chain on), durable with ``data_dir`` (and ``fsync``).
    ``crash_apiserver`` SIGKILLs it and starts it again on the same port
    and directory; ``stop_scheduler`` sends SIGTERM and returns the
    daemon's stats line; ``close`` ends whatever still runs."""

    def __init__(self, workdir: str, tag: str, admitted: bool = False,
                 data_dir: str = None, fsync: bool = False):
        self.workdir, self.tag = workdir, tag
        self.api_port, self.health_port = free_port(), free_port()
        self.url = f"http://127.0.0.1:{self.api_port}"
        self.env = {**os.environ, "PYTHONPATH": ROOT}
        self.scheduler = None
        self.api_args = ["kubernetes_tpu_torch.apiserver", "--port", str(self.api_port)]
        if not admitted:
            self.api_args.append("--disable-admission")
        if data_dir:
            self.api_args += ["--data-dir", data_dir] + (["--fsync"] if fsync else [])
        self.starts = 0
        self.apiserver = None
        try:
            self._start_apiserver()
        except BaseException:
            self.close()
            raise

    def _start_apiserver(self) -> None:
        self.starts += 1
        name = "apiserver" if self.starts == 1 else f"apiserver{self.starts}"
        self.apiserver = self._spawn(name, self.api_args)
        wait_until(lambda: b"ok" in http_get(self.url + "/healthz"), self.apiserver,
                   "apiserver /healthz", 120)

    def crash_apiserver(self) -> dict:
        """SIGKILL the apiserver, start it again on the same port and
        directory; returns the restarted one's recovery line (revision,
        records replayed, torn tail, truncated bytes) and the seconds from
        the kill to its /healthz."""
        t = time.perf_counter()
        self.apiserver.send_signal(signal.SIGKILL)
        self.apiserver.wait(timeout=60)
        self._start_apiserver()
        restart_s = time.perf_counter() - t
        out = open(os.path.join(self.workdir, f"{self.tag}-apiserver{self.starts}.out")).read()
        lines = [ln for ln in out.splitlines() if ln.startswith("apiserver recovered ")]
        if len(lines) != 1:
            raise AssertionError(f"the restarted apiserver logged {len(lines)} recovery lines")
        return {"restart_s": restart_s, **json.loads(lines[0][len("apiserver recovered "):])}

    def _spawn(self, name: str, args: list) -> subprocess.Popen:
        base = os.path.join(self.workdir, f"{self.tag}-{name}")
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=self.env,
                                stdout=open(base + ".out", "w"),
                                stderr=open(base + ".err", "w"))

    def start_scheduler(self, *extra: str) -> None:
        self.scheduler = self._spawn("scheduler", [
            "kubernetes_tpu_torch.scheduler", "--apiserver", self.url, "--leader-elect",
            "--healthz-port", str(self.health_port), *extra])
        health = f"http://127.0.0.1:{self.health_port}"
        wait_until(lambda: b"ok" in http_get(health + "/healthz"), self.scheduler,
                   "scheduler /healthz", 120)
        # /metrics shows the scheduler's registry once it leads and serves
        wait_until(lambda: E2E_METRIC.encode() in http_get(health + "/metrics"),
                   self.scheduler, "scheduler serving", 300)

    def metrics_text(self) -> str:
        return http_get(f"http://127.0.0.1:{self.health_port}/metrics").decode()

    def e2e_quantiles_ms(self) -> tuple[float, float]:
        """p50 and p99 of the daemon's e2e SLI histogram from its /metrics
        (the upper bound of the bucket each quantile falls in)."""
        text = self.metrics_text()
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

    # the daemon's ingest counters on its /metrics, by WIRE_KEYS; the two
    # seconds are the sums of its per-drain observations
    INGEST_METRICS = ("scheduler_watch_frames_total", "scheduler_watch_frame_events_total",
                      "scheduler_ingest_promotions_total", "scheduler_confirm_fallbacks_total",
                      "scheduler_ingest_decode_seconds_sum", "scheduler_ingest_parse_seconds_sum")

    def ingest_counters(self) -> dict:
        text = self.metrics_text()
        values = {}
        for line in text.splitlines():
            name, _, value = line.partition(" ")
            if name in self.INGEST_METRICS:
                values[name] = float(value)
        return {k: values.get(m, 0.0) for k, m in zip(WIRE_KEYS, self.INGEST_METRICS)}

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


def daemon_phase() -> tuple[int, float, float, int]:
    """Phase 6: the daemon stack at full width, then parity of a smaller
    daemon run with the sequential oracle.  Returns the fused-kernel
    launches of 6a, as the daemon counted them, 6a's pods/s, its device
    idle share and the refresh kernel's launches of 6a."""
    from kubernetes_tpu_torch.client import Clientset, RemoteStore
    from kubernetes_tpu_torch.workload import create_cluster, oracle_replay_waves, run_wire_churn

    t_6a = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        n_nodes, n_pods, waves = 5000, 20000, 10
        d = Daemons(workdir, "6a")
        try:
            d.start_scheduler()
            counters = [d.ingest_counters()]
            r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=0,
                               on_wave=lambda w: counters.append(d.ingest_counters()))
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
              f"{st['kernel_ms']:.3f} scheduled_events {scheduled} refresh_launches "
              f"{st['refresh_launches']} host_syncs {st['host_syncs']} frontier_compactions "
              f"{st['frontier_compactions']} node_cache {st['node_cache']}", flush=True)
        print("phase 6a wave seconds: " + " ".join(f"{s:.3f}" for s in r["wave_s"]), flush=True)
        for w in range(waves):
            delta = {k: counters[w + 1][k] - counters[w][k] for k in WIRE_KEYS}
            print(f"phase 6a wave {w} (the daemon's /metrics): " + ingest_line(delta, WIRE_KEYS),
                  flush=True)
        # the daemon observes its ingest seconds at the end of each drain:
        # what its informers and watch readers did after the last drain
        # (the last wave's bind confirms) is in its totals only
        total = {"decode_s": st["ingest_decode_s"], "parse_s": st["ingest_parse_s"]}
        tail = {k: total[k] - counters[-1][k] for k in SECONDS_KEYS}
        waves_sum = {k: counters[-1][k] - counters[0][k] for k in SECONDS_KEYS}
        print("phase 6a ingest seconds, before the first wave + the waves + after the last "
              "wave = the daemon's total: " + " ".join(
                  f"{k} {counters[0][k]:.4f} + {waves_sum[k]:.4f} + {tail[k]:.4f} = "
                  f"{total[k]:.4f}" for k in SECONDS_KEYS), flush=True)
        if any(tail[k] < -1e-9 for k in SECONDS_KEYS):
            raise AssertionError(f"the daemon observed more ingest seconds than its informers "
                                 f"and watch readers counted: waves {waves_sum} total {total}")
        print(f"phase 6a the daemon's host helpers: {st['helpers']}; lazy ingest "
              f"{st['ingest_lazy']}, frames {st['ingest_frames']}, frame events "
              f"{st['ingest_frame_events']}, promotions {st['ingest_promotions']}, confirm "
              f"fallbacks {st['confirm_fallbacks']}", flush=True)
        if not st["ingest_lazy"] or st["ingest_frames"] <= 0 or st["ingest_promotions"] <= 0:
            raise AssertionError("the daemon did not run the lazy, framed ingest path")
        idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
        print(f"phase 6a device idle share over the wall (1 - kernel_ms / wall): {idle:.4f}; "
              f"batch path {st['batch_s']:.3f} s of the wall (tensorize {st['tensorize_s']:.3f}, "
              f"dispatch {st['dispatch_s']:.3f}, device wait {st['device_wait_s']:.3f}), the "
              f"rest wire, ingest and waiting: {1.0 - st['batch_s'] / r['wall_s']:.4f}; the "
              f"daemon's watch readers parsed {st['ingest_bytes']} wire bytes in "
              f"{st['ingest_parse_s']:.3f} s, its informers decoded them "
              f"({'lazy wrap' if st['ingest_lazy'] else 'typed'}) in "
              f"{st['ingest_decode_s']:.3f} s and applied them in {st['ingest_apply_s']:.3f} s",
              flush=True)
        if r["bound"] + r["unbound"] != n_pods or st["launches"] < waves:
            raise AssertionError(f"daemon run: bound {r['bound']} unbound {r['unbound']} "
                                 f"launches {st['launches']}")
        if st["oracle_pods"] != 0 or st["kernel_pods"] != st["drained"]:
            raise AssertionError("the daemon did not run every drained pod through the kernel")
        if scheduled != r["bound"]:
            raise AssertionError(f"{scheduled} Scheduled events for {r['bound']} bound pods")
        launches, refresh = st["launches"], st["refresh_launches"]

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
              f"{st['round_robin']} vs {o['round_robin']}; ingest: frames "
              f"{st['ingest_frames']} frame_events {st['ingest_frame_events']} promotions "
              f"{st['ingest_promotions']} confirm_fallbacks {st['confirm_fallbacks']} decode_s "
              f"{st['ingest_decode_s']:.4f} parse_s {st['ingest_parse_s']:.4f}", flush=True)
        if (st["waves"] != 1 or st["drained"] != n_pods or o["checked"] != n_pods
                or o["mismatches"] != 0 or o["round_robin"] != st["round_robin"]):
            raise AssertionError(f"daemon bindings != sequential oracle: {o}, stats {st}")
    t_end = time.perf_counter()
    print(f"phase 6 took {t_end - t_6a:.1f} s: 6a {t_6b - t_6a:.1f} s (daemon start-up and "
          f"cluster creation included), 6b {t_end - t_6b:.1f} s", flush=True)
    return launches, r["pods_per_sec"], idle, refresh


def preemption_line(tag: str, r: dict) -> None:
    c = r["cohort"]
    lat = r["preemption_latency_ms"]
    print(f"phase {tag} preemption {r['nodes']} nodes, {r['fillers']} fillers, "
          f"{r['preemptors']} preemptors: fill bound {r['fill_bound']} in {r['fill_s']:.3f} s; "
          f"preemptor wave failed {r['wave_failed']} in {r['wave_s']:.3f} s (cohort included); "
          f"attempts {r['attempts']} victims {r['victims']} bound after "
          f"{r['preemptor_bound_after']} (follow-up batch {r['follow_s']:.3f} s); fillers bound "
          f"{r['fillers_bound']} evicted {r['fillers_evicted']}; evictions_per_s "
          f"{r['evictions_per_sec']:.1f}; preemption latency p50 {lat['p50']} ms p99 "
          f"{lat['p99']} ms; preempt and bind {r['preempt_and_bind_s']:.3f} s", flush=True)
    print(f"phase {tag} cohort split: state build {c['state_s']:.4f} s, per-preemptor ranking "
          f"{c['rank_s']:.4f} s, evictions with pump and snapshot {c['evict_s']:.4f} s, "
          f"cohort total {c['total_s']:.4f} s ({c['preempted']} of {c['preemptors']} preempted)",
          flush=True)
    ok = (r["victims"] == r["preemptors"] == r["preemptor_bound_after"] == r["preemptors_bound"]
          and r["fillers_bound"] + r["fillers_evicted"] == r["fillers"]
          and r["backend"]["oracle_pods"] == 0)
    if not ok:
        raise AssertionError(f"phase {tag}: victims {r['victims']}, preemptors "
                             f"{r['preemptors']}, bound after {r['preemptor_bound_after']}, "
                             f"fillers bound {r['fillers_bound']} evicted {r['fillers_evicted']}")


def preemption_phase() -> tuple[int, dict]:
    """Phase 7: preemption.  (a) ``workload.run_preemption`` at full width
    on the card: 5000 nodes, 20 000 fillers, 2500 preemptors, the
    preemptor and follow-up batches' kernel segments held against the
    plain scan; (b) 1000
    nodes, 4000 fillers and 150 preemptors, a seeded tenth of them with a
    host port or a required affinity (branch and bound): every cohort
    decision held against the exhaustive ``find_preemption_target`` on the
    state it was made on, and the preemptor and follow-up batches' kernel
    segments against the plain scan; (c) the daemons at their defaults
    over HTTP, 1000 nodes, 4000 fillers and 500 preemptors.  Returns the
    fused-kernel launches of the three runs and each run's seconds."""
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.ops.preemption_kernel import PreemptionState
    from kubernetes_tpu_torch.scheduler import preemption
    from kubernetes_tpu_torch.workload import run_preemption, run_wire_preemption

    secs = {}
    t = time.perf_counter()
    # the vectorized state's own seconds inside the ranking: its numpy
    # greedy over every node, one call a preemptor
    ranked = {"calls": 0, "s": 0.0}
    rank_arrays = PreemptionState.rank_arrays

    def timed_rank_arrays(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return rank_arrays(self, *a, **kw)
        finally:
            ranked["calls"] += 1
            ranked["s"] += time.perf_counter() - t0

    # the preemptor wave's and the follow-up's segments, at the shapes this
    # path gives the kernel, held against the plain scan (the fill is
    # phase 4's shape)
    seen = []
    checked = checking_backend(seen, skip=1)
    fused_scan.launches = 0
    PreemptionState.rank_arrays = timed_rank_arrays
    try:
        r = run_preemption(5000, 20000, 2500, device="cuda", seed=0, backend_cls=checked)
    finally:
        PreemptionState.rank_arrays = rank_arrays
    launches_a = fused_scan.launches - len(seen)  # each check launched once more
    preemption_line("7a", r)
    print(f"phase 7a {len(seen)} preemptor and follow-up segments kernel == scan_ref "
          f"(pods {[c['pods'] for _, c, _, _ in seen]}, plain "
          f"{[round(c['plain_ms'], 3) for _, c, _, _ in seen]} ms); the checks' "
          f"{checked.check_s:.3f} s are inside the wave and follow-up seconds: preempt and "
          f"bind less the checks {r['preempt_and_bind_s'] - checked.check_s:.3f} s", flush=True)
    if len(seen) < 2:
        raise AssertionError(f"phase 7a checked {len(seen)} segments against scan_ref")
    c = r["cohort"]
    print(f"phase 7a PreemptionState (host numpy): build {c['state_s']:.4f} s + rank_arrays "
          f"{ranked['s']:.4f} s in {ranked['calls']} calls ({ranked['s'] / max(ranked['calls'], 1) * 1e3:.3f} "
          f"ms a call) = {(c['state_s'] + ranked['s']) / c['total_s']:.4f} of the cohort",
          flush=True)
    st = r["backend"]
    print(f"phase 7a fused-scan launches {launches_a} (fill, preemptor wave, follow-up), "
          f"segments {st['segments']} kernel_pods {st['kernel_pods']} kernel_ms "
          f"{st['kernel_ms']:.3f}", flush=True)
    if launches_a < 3:
        raise AssertionError(f"phase 7a launched the fused kernel {launches_a} times")
    secs["7a"] = time.perf_counter() - t

    t = time.perf_counter()
    decisions = {"checked": 0, "branch_and_bound": 0, "mismatches": []}
    fast = preemption.find_preemption_target_fast

    def held(pod, node_info_map, candidates, predicates=None, pvcs=None, pvs=None, **kw):
        got = fast(pod, node_info_map, candidates, predicates, pvcs=pvcs, pvs=pvs, **kw)
        want = preemption.find_preemption_target(pod, node_info_map, predicates, pvcs, pvs)
        key = [None if x is None else (x.node_name, sorted(v.meta.key for v in x.victims))
               for x in (got, want)]
        decisions["checked"] += 1
        decisions["branch_and_bound"] += not preemption._fast_eligible(pod, predicates)
        if key[0] != key[1]:
            decisions["mismatches"].append((pod.meta.key, *key))
        return got

    seen = []
    fused_scan.launches = 0
    preemption.find_preemption_target_fast = held
    try:
        # 150 preemptors (500 once, 250 until the frontier's phases came):
        # the exhaustive oracle is the phase's wall (0.15-0.25 s a
        # decision), and the script stays under 750 s
        r = run_preemption(1000, 4000, 150, device="cuda", seed=7, odd_share=0.1,
                           backend_cls=checking_backend(seen, skip=1))
    finally:
        preemption.find_preemption_target_fast = fast
    launches_b = fused_scan.launches - len(seen)  # each check launched once more
    preemption_line("7b", r)
    print(f"phase 7b parity: {decisions['checked']} cohort decisions == exhaustive oracle "
          f"({decisions['branch_and_bound']} by branch and bound; the check runs inside the "
          f"ranking seconds above), mismatches "
          f"{len(decisions['mismatches'])}; {len(seen)} preemptor and follow-up segments "
          f"kernel == scan_ref, rr {r['round_robin']}; launches {launches_b}", flush=True)
    if (decisions["mismatches"] or decisions["checked"] != r["preemptors"]
            or decisions["branch_and_bound"] == 0 or len(seen) < 2):
        raise AssertionError(f"phase 7b: {decisions}, {len(seen)} segments checked")
    secs["7b"] = time.perf_counter() - t

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        d = Daemons(workdir, "7c")
        try:
            d.start_scheduler()
            w = run_wire_preemption(d.url, 1000, 4000, 500, deadline_s=120.0)
            st = d.stop_scheduler()
        except BaseException:
            print(f"phase 7c scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
    print(f"phase 7c daemons at defaults over HTTP, {w['nodes']} nodes, {w['fillers']} fillers, "
          f"{w['preemptors']} preemptors: fillers bound in {w['fill_s']:.3f} s, every preemptor "
          f"bound in {w['preempt_and_bind_s']:.3f} s ({w['preemptors_bound']} bound, fillers "
          f"left {w['fillers_bound']}, evicted {w['fillers_evicted']}); the daemon: attempts "
          f"{st['preemption_attempts']} victims {st['preemption_victims']} (victims beyond one "
          f"a preemptor: {st['preemption_victims'] - w['preemptors']}), drains {st['waves']}, "
          f"launches {st['launches']}, kernel_pods {st['kernel_pods']} oracle_pods "
          f"{st['oracle_pods']}", flush=True)
    if (w["preemptors_bound"] != w["preemptors"] or st["oracle_pods"] != 0
            or st["preemption_victims"] < w["preemptors"] or st["launches"] < 3):
        raise AssertionError(f"phase 7c: {w}, stats {st}")
    secs["7c"] = time.perf_counter() - t
    print("phase 7 seconds: " + " ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return launches_a + launches_b + st["launches"], secs


def policy_phase() -> int:
    """Phase 8: the upstream ``ClusterAutoscalerProvider`` as a policy
    document (the default predicates, MostRequested in place of
    LeastRequested), loaded by ``load_policy_file`` and run at 1000 x 2000
    ``mixed``: each kernel segment against the plain scan, the bindings and
    rr against the sequential oracle on the same policy, and the segment's
    ``most`` weight plane on.  Returns the fused-kernel launches."""
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.scheduler.policy import algorithm_from_provider, load_policy_file

    provider = algorithm_from_provider("ClusterAutoscalerProvider")
    doc = {"predicates": [{"name": n} for n in provider.predicates],
           "priorities": [{"name": type(p).name, "weight": w} for p, w in provider.priorities]}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "policy.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        algo, oracle = load_policy_file(path), load_policy_file(path)
    m, pods, pctx = cluster(1000, 2000, "mixed", seed=1)
    before = fused_scan.launches
    got, seen, backend = checked_batch(m, pods, pctx, algorithm=algo)
    launches = fused_scan.launches - before - len(seen)
    want = oracle_bindings(m, pods, pctx, oracle)
    planes = [s.weights for _, _, s, _ in seen]
    # the policy's segment against the same cluster's default-weight one
    policy_ms = time_kernel(*seen[0][2:])
    default_ms = time_kernel(*segment(m, pods, pctx, "cuda")[1:])
    print(f"phase 8 policy ClusterAutoscalerProvider from a file, mixed {len(m)}x{len(pods)}: "
          f"{len(seen)} "
          f"segments kernel == scan_ref, BatchBackend == GenericScheduler on the policy "
          f"{got == want}, rr {algo._round_robin} vs {oracle._round_robin}, bound "
          f"{sum(g is not None for g in got)}/{len(pods)}, weights {planes}, kernel_pods "
          f"{backend.stats['kernel_pods']} oracle_pods {backend.stats['oracle_pods']}, launches "
          f"{launches}; kernel {policy_ms:.3f} ms against {default_ms:.3f} ms for the default "
          f"weights", flush=True)
    if (got != want or algo._round_robin != oracle._round_robin or launches < 1
            or backend.stats["oracle_pods"] != 0
            or any(w["most"] != 1 or w["least"] != 0 for w in planes)):
        raise AssertionError("phase 8: the policy's batch != the plain scan or the oracle")
    return launches


def metric_value(text: str, name: str) -> float:
    """A metric's value in a Prometheus text exposition (0 if absent)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def policy_daemon_phase() -> None:
    """Phase 8b: the daemons with a policy the scan does not express
    (``ServiceSpreadingPriority``) on ``--device cuda``: 6b's parity set
    binds on the host oracle inside the batch backend, as the JAX daemon
    binds it, equal to the sequential oracle on the same policy; the
    route shows on /metrics and in the start-up log."""
    from kubernetes_tpu_torch.client import Clientset, RemoteStore
    from kubernetes_tpu_torch.scheduler.policy import load_policy_file
    from kubernetes_tpu_torch.workload import create_cluster, oracle_replay_waves

    n_nodes, n_pods, seed = 1000, 400, 5
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        policy = os.path.join(workdir, "policy.json")
        with open(policy, "w") as f:
            json.dump({"priorities": [{"name": "ServiceSpreadingPriority", "weight": 1},
                                      {"name": "LeastRequestedPriority", "weight": 1}]}, f)
        d = Daemons(workdir, "8b")
        try:
            cs = Clientset(RemoteStore(d.url, timeout=120.0))
            pods = create_cluster(cs, n_nodes, n_pods, "mixed", seed)
            if any(x is None for x in cs.pods.create_many(pods)):
                raise AssertionError("a pod create failed")
            d.start_scheduler("--policy-config-file", policy)
            deadline = time.monotonic() + 180
            while True:
                items, _ = cs.store.list("Pod")
                got = {f"default/{i['metadata']['name']}": i["spec"].get("nodeName") or None
                       for i in items}
                if all(got.values()) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            metrics = http_get(f"http://127.0.0.1:{d.health_port}/metrics").decode()
            st = d.stop_scheduler()
        except BaseException:
            print(f"phase 8b scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
        logged = "host oracle" in d.stderr_tail()
        o = oracle_replay_waves([sorted(got)], got, n_nodes, n_pods, "mixed", seed,
                                algorithm=load_policy_file(policy))
    oracle_pods = metric_value(metrics, "scheduler_backend_oracle_pods_total")
    print(f"phase 8b daemons with a ServiceSpreadingPriority policy on --device cuda, "
          f"{n_nodes}x{n_pods} pre-created: {o['mode']}, checked {o['checked']}, mismatches "
          f"{o['mismatches']}, bound {sum(1 for n in got.values() if n)}, rr "
          f"{st['round_robin']} vs {o['round_robin']}; /metrics "
          f"scheduler_backend_oracle_pods_total {oracle_pods:.0f}, stats oracle_pods "
          f"{st['oracle_pods']} kernel_pods {st['kernel_pods']} launches {st['launches']}; "
          f"the start-up log names the host oracle: {logged} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if (o["mismatches"] != 0 or o["checked"] != n_pods or o["round_robin"] != st["round_robin"]
            or oracle_pods <= 0 or st["oracle_pods"] != n_pods or st["kernel_pods"] != 0
            or not logged):
        raise AssertionError(f"phase 8b: {o}, stats {st}")


def traced_daemon_phase(pps_6a: float, idle_6a: float) -> int:
    """Phase 9a: 6a's cell with the daemon's tracing and continuous
    telemetry on.  Returns the fused-kernel launches, as the daemon
    counted them."""
    from kubernetes_tpu_torch.workload import run_wire_churn

    n_nodes, n_pods, waves = 5000, 20000, 10
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        sink = os.path.join(workdir, "telemetry.ndjson")
        d = Daemons(workdir, "9a")
        try:
            d.start_scheduler("--trace", "--timeseries", "--telemetry-sink", sink)
            r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=0)
            time.sleep(2.5)  # two scrapes past the last wave
            health = f"http://127.0.0.1:{d.health_port}"
            doc = json.loads(http_get(health + "/debug/traces"))
            flight = json.loads(http_get(health + "/debug/flightrecorder"))
            series = json.loads(http_get(health + "/debug/timeseries"))
            st = d.stop_scheduler()
        except BaseException:
            print(f"phase 9a scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
        records = [json.loads(line) for line in open(sink) if line.strip()]
    events = doc["traceEvents"]
    roots = sorted((e for e in events if e.get("cat") == "wave" and e["ph"] == "X"),
                   key=lambda e: e["ts"])
    tensorize_s = sum(e["dur"] for e in events if e["name"] == "tensorize") / 1e6
    dispatch = [e for e in events if e["name"] == "dispatch" and e["ph"] == "X"]
    span_kernel_ms = sum(e["args"].get("kernel_ms", 0.0) for e in dispatch)
    timed = sum(1 for e in dispatch if "kernel_ms" in e["args"])
    # a frontier segment launches the fused scan once a chunk
    span_launches = sum(e["args"].get("launches", 0) for e in dispatch)
    # each wave's idle share from its own spans: 1 - its kernel ms / its wall
    idle_waves = []
    for root in roots:
        t_end = root["ts"] + root["dur"]
        k_ms = sum(e["args"].get("kernel_ms", 0.0) for e in dispatch
                   if root["ts"] <= e["ts"] <= t_end)
        idle_waves.append(1.0 - k_ms / (root["dur"] / 1e3))
    waves_seen = max((v for rec in records if rec.get("kind") == "timeseries"
                      for name, _t, v in rec["samples"] if name == "scheduler_batch_size:count"),
                     default=0.0)
    wall_idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
    print(f"phase 9a traced daemons (--trace --timeseries --telemetry-sink) {n_nodes}x{n_pods} "
          f"mixed in {waves} waves: bound {r['bound']} wall_s {r['wall_s']:.3f} pods_per_s "
          f"{r['pods_per_sec']:.1f} against 6a's {pps_6a:.1f} in this call "
          f"(ratio {r['pods_per_sec'] / pps_6a:.4f}); create_to_bind p99 "
          f"{r['create_to_bind_ms']['p99']:.1f} ms; drains {st['waves']}, wave roots in the "
          f"trace {len(roots)}, trace events {len(events)}, flight dumps "
          f"{len(flight['dumps'])}, time-series tracks {len(series.get('tracks', {}))}, sink "
          f"records {len(records)} (timeseries "
          f"{sum(1 for x in records if x.get('kind') == 'timeseries')}), batch_size count in "
          f"the sink's series {waves_seen:.0f}", flush=True)
    print(f"phase 9a spans against the daemon's stats: tensorize {tensorize_s:.6f} s vs "
          f"tensorize_s {st['tensorize_s']:.6f} s; dispatch spans {len(dispatch)}, with "
          f"kernel_ms {timed}, their launches {span_launches} vs the daemon's "
          f"{st['launches']}; their kernel_ms {span_kernel_ms:.6f} vs "
          f"{st['kernel_ms']:.6f}", flush=True)
    print("phase 9a per-wave device idle share from the spans (1 - kernel_ms / wave wall): "
          + " ".join(f"{x:.4f}" for x in idle_waves)
          + f"; over the run's wall {wall_idle:.4f} (6a's, from CUDA-event totals: "
          f"{idle_6a:.4f}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    if (r["bound"] + r["unbound"] != n_pods or len(roots) != st["waves"]
            or any(e["name"] != f"wave-{i + 1}" for i, e in enumerate(roots))
            or abs(tensorize_s - st["tensorize_s"]) > 1e-6 * max(1.0, st["tensorize_s"])
            or timed != len(dispatch) or span_launches != st["launches"]
            or abs(span_kernel_ms - st["kernel_ms"]) > 1e-6 * max(1.0, st["kernel_ms"])
            or int(waves_seen) != st["waves"] or st["oracle_pods"] != 0):
        raise AssertionError(f"phase 9a: the trace or the sink disagrees with the daemon: {st}")
    return st["launches"]


def faults_phase() -> int:
    """Phase 9b: faults on the card, in process: 1000 nodes and 2000
    ``mixed`` pods arriving in five waves, tracing on, one seeded fault a
    wave: ``backend.pallas.segment`` once at the launch (the wave raises,
    its drained pods are requeued and bind in the next drain),
    ``scheduler.pipeline.prep`` (contained), none, ``backend.compact`` at
    the frontier's prefilter (the wave raises and is requeued as for the
    kernel), then one ``bind_many`` item dropped (``scheduler.bind``: the
    pod is forgotten, requeued after its backoff, and bound again).  Each fault's flight-recorder dump must
    name its point and hold the live wave it fired in; every binding but
    the re-decided pod's must equal the per-wave oracle replay.  Returns
    the fused-kernel launches."""
    from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.scheduler import GenericScheduler, Scheduler
    from kubernetes_tpu_torch.utils import tracing
    from kubernetes_tpu_torch.workload import _churn_cluster, oracle_replay_waves

    n_nodes, n_pods, seed = 1000, 2000, 8
    t0 = time.perf_counter()
    cs, pods = _churn_cluster(n_nodes, n_pods, "mixed", seed)
    algo = GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cuda")
    sched = Scheduler(cs, algorithm=algo, backend=backend, emit_events=False)
    sched.start()
    drains: list[list[str]] = []
    orig_drain = sched.queue.drain

    def recording_drain(max_n=None):
        out = orig_drain(max_n)
        if out:
            drains.append([p.meta.key for p in out])
        return out

    sched.queue.drain = recording_drain
    plans = [("backend.pallas.segment", dict(mode="error", match={"phase": "launch"},
                                             first_n=1)),
             ("scheduler.pipeline.prep", dict(mode="error", first_n=1)),
             (None, None),
             ("backend.compact", dict(mode="error", match={"phase": "seed"}, first_n=1)),
             # last: the replay places a re-decided pod at its first decision,
             # so no wave after a bind requeue can be replayed exactly
             ("scheduler.bind", dict(mode="drop", match={"via": "bind_many"}, first_n=1))]
    armed = {point: FaultPlan(seed=k).on(point, **spec)
             for k, (point, spec) in enumerate(plans) if point}
    per = n_pods // len(plans)
    results, failed_drains = [], set()
    tr = tracing.enable()
    fused_scan.launches = 0
    try:
        for w, (point, _) in enumerate(plans):
            cs.pods.create_many(pods[w * per:(w + 1) * per])
            sched.pump()
            try:
                if point is None:
                    results.append(sched.schedule_pending_batch())
                else:
                    with armed[point].armed():
                        results.append(sched.schedule_pending_batch())
            except FaultInjected:
                failed_drains.add(len(drains) - 1)
                results.append(("raised", len(sched.queue)))
            # what a fault put back binds before the next wave arrives
            deadline = time.monotonic() + 30
            while (len(sched.queue) or sched.queue.pending_delayed()) and \
                    time.monotonic() < deadline:
                sched.pump()
                if len(sched.queue):
                    results.append(sched.schedule_pending_batch())
                else:
                    time.sleep(0.05)
        sched.pump()
        launches = fused_scan.launches
    finally:
        tracing.disable()
    dumps = {p: [d for d in tr.dumps if d["reason"] == f"fault:{p}"] for p in armed}
    live = {p: [s["attrs"].get("wave") for d in ds for s in d["live"] if s.get("cat") == "wave"]
            for p, ds in dumps.items()}
    final = {p.meta.key: p.spec.node_name or None for p in cs.pods.list()[0]}
    # the replay: every drain but the failed one, a pod at its first decision
    replay, done, twice = [], set(), set()
    for i, batch in enumerate(drains):
        if i in failed_drains:
            continue
        twice.update(k for k in batch if k in done)
        replay.append([k for k in batch if k not in done])
        done.update(batch)
    o = oracle_replay_waves(replay, final, n_nodes, n_pods, "mixed", seed,
                            skip=frozenset(twice))
    bound = sum(1 for n in final.values() if n)
    print(f"phase 9b faults on the card in process, {n_nodes}x{n_pods} mixed, {len(plans)} "
          f"waves ({', '.join(p or 'none' for p, _ in plans)}): drains {results} (the failed "
          f"one: {sorted(failed_drains)}), fired "
          f"{ {p: armed[p].fired.get(p, 0) for p in armed} }, bind requeues "
          f"{sched.metrics.bind_requeues.value:.0f} (re-decided {sorted(twice)}), prep "
          f"failures {sched.metrics.pipeline_prep_failures.value:.0f}, launches {launches}; "
          f"dumps " + ", ".join(f"{p}: {len(ds)} (live wave {live[p]})" for p, ds in dumps.items())
          + f"; bound {bound}/{n_pods}; oracle replay {o['mode']}, checked {o['checked']}, "
          f"mismatches {o['mismatches']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if (any(armed[p].fired.get(p, 0) != 1 for p in armed) or len(failed_drains) != 2
            or any(not live[p] for p in armed) or len(twice) != 1
            or sched.metrics.bind_requeues.value != 1
            or sched.metrics.pipeline_prep_failures.value != 1
            or o["mismatches"] != 0 or o["checked"] != n_pods - 1
            or not final[next(iter(twice))] or len(sched.queue) or launches < len(plans)
            or backend.stats["oracle_pods"] != 0):
        raise AssertionError(f"phase 9b: {o}, drains {results}")
    return launches


def overload_phase() -> tuple[int, dict]:
    """Phase 9c: ``workload.run_overload`` at 5000 nodes on a backend that
    records every segment scanned with the interpod score plane shed
    (rung >= 2); each is held against the plain scan after the run, under
    the same shed weights.  Returns the fused-kernel launches of the run
    and its result."""
    import numpy as np

    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.ops import fused_scan, scan_ref
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.workload import run_overload

    shed: list = []

    class ShedRecorder(BatchBackend):
        def _dispatch(self, static, init):
            finish, busy = super()._dispatch(static, init)
            if not self.shed_score_planes:
                return finish, busy
            inputs = from_reference(vars(static), vars(init), self.device)

            def recorded():
                chosen, rr = finish()
                shed.append((inputs, np.array(chosen), rr))
                return chosen, rr
            return recorded, busy

    t0 = time.perf_counter()
    fused_scan.launches = 0
    r = run_overload(n_nodes=5000, surge_mult=3.0, max_surge_s=20.0, device="cuda",
                     backend_cls=ShedRecorder)
    launches = fused_scan.launches
    t1 = time.perf_counter()
    mismatched = 0
    for (s, st), chosen, rr in shed:
        want, rr_want = scan_ref.scan(s, st)
        if s.weights["interpod"] != 0 or rr != rr_want or not np.array_equal(
                chosen, want.cpu().numpy()):
            mismatched += 1
    tiers = " ".join(
        f"{t} arrivals {x['arrivals']} rejected {x['rejected']} bound {x['bound']} goodput "
        f"{x['goodput']:.4f} e2e p50 {x['e2e_ms']['p50']} ms p99 {x['e2e_ms']['p99']} ms;"
        for t, x in r["tiers"].items())
    ad = r["admission"]
    print(f"phase 9c overload {r['nodes']} nodes: drain {r['drain_pods_per_s']:.1f} pods/s, "
          f"arrivals paced at {r['arrival_pods_per_s']:.1f} pods/s for {r['surge_pods']} pods, "
          f"{sum(x['arrivals'] for x in r['tiers'].values())} created in the 20 s window, the "
          f"creators done after {r['surge_s']:.3f} s (pending threshold "
          f"{r['pending_threshold']:.1f}); {tiers} "
          f"rung timeline {[(round(t, 3), g) for t, g in r['rung_timeline']]}, max rung "
          f"{r['max_rung']}, transitions {r['transitions']}, recovered {r['recovered']} in "
          f"{r['recovery_s']} s; score_plane_sheds {r['score_plane_sheds']:.0f}, preemption "
          f"sheds {r['preemption_sheds']:.0f}; 429s {ad['server_429']:.0f} (throttled "
          f"{ad['throttled']}, by tier {ad['throttled_by_tier']}, Retry-After honoured "
          f"{ad['retry_after_honored']}); tail at rung {r['tail']['rung']}: bound "
          f"{r['tail']['bound']}/{r['tail']['pods']}, exact {r['tail']['exact_parity']}, "
          f"mismatches {r['tail']['mismatches']}; launches {launches}; shed segments held "
          f"against scan_ref {len(shed)}, mismatched {mismatched} ({t1 - t0:.1f} s run, "
          f"{time.perf_counter() - t1:.1f} s checks)", flush=True)
    if (r["max_rung"] < 1 or not r["recovered"] or r["tail"]["rung"] != 0
            or not r["tail"]["exact_parity"] or not r["tail"]["all_bound"]
            or mismatched or (r["max_rung"] >= 2 and not shed)
            or r["stats"]["oracle_pods"] != 0):
        raise AssertionError(f"phase 9c: the ladder or a shed segment failed: "
                             f"{ {k: v for k, v in r.items() if k != 'stats'} }")
    return launches, r


def median_ms(fn, reps: int = 11) -> float:
    """Median wall ms of ``fn()`` ended by a device sync (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def gather_cell(gathers: list) -> None:
    """``gather_node_axis`` timed alone on the inputs of phase 10's first
    compaction, against its bytes (every gathered plane read once and
    written once, the index read once) over the card's memory rate."""
    from kubernetes_tpu_torch.ops.frontier import gather_node_axis

    if not gathers:
        raise AssertionError("phase 10: the counted run did not compact")
    static, state, js, width = gathers[0]
    out_s, out_st = gather_node_axis(static, state, js, width)
    out_bytes = sum(v.numel() * v.element_size()
                    for obj in (out_s, out_st) for v in vars(obj).values()
                    if hasattr(v, "element_size") and v.dim() > 0)
    src_bytes = sum(v.numel() * v.element_size()
                    for obj in (static, state) for v in vars(obj).values()
                    if hasattr(v, "element_size") and v.dim() > 0)
    ms = median_ms(lambda: gather_node_axis(static, state, js, width))
    bound_ms = (2 * out_bytes + js.numel() * 8) / HBM_BYTES_PER_S * 1e3
    print(f"phase 10 gather_node_axis alone at the first compaction ({static.n_pad} -> {width} "
          f"columns, {js.numel()} kept): {ms:.4f} ms (median of 11, host clock with a device "
          f"sync); bound {bound_ms:.6f} ms (bytes: {2 * out_bytes + js.numel() * 8} gathered "
          f"in and out of {src_bytes} bytes of planes)", flush=True)


def node_cache_cell(static) -> None:
    """``DeviceNodeCache``'s full upload of the main segment's node-axis
    statics, against its bytes over the card's memory rate."""
    from kubernetes_tpu_torch.models.carry import NODE_FIELDS
    from kubernetes_tpu_torch.ops.node_cache import DeviceNodeCache, _host

    cache = DeviceNodeCache("cuda")
    host = tuple(_host(static, f) for f in NODE_FIELDS)
    nbytes = sum(h.nbytes for h in host)
    ms = median_ms(lambda: cache._upload(host))
    print(f"phase 4 DeviceNodeCache upload of the main segment's node statics "
          f"({len(NODE_FIELDS)} arrays, {nbytes} bytes): {ms:.4f} ms (median of 11, host clock "
          f"with a device sync); bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the copy crosses PCIe from pageable memory)",
          flush=True)


def pool_cluster(n_nodes: int = 1024, n_pods: int = 10000):
    """Phase 10's pool: half the nodes take 4 pods, half 110, four zones,
    and identical batch pods."""
    from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext
    from kubernetes_tpu_torch.testutil import make_node, make_pod
    from kubernetes_tpu_torch.workload import ZONE

    m = {}
    for i in range(n_nodes):
        name = f"pool-{i:04d}"
        node = make_node(name, cpu="32", memory="64Gi", pods=4 if i % 2 else 110,
                         labels={"kubernetes.io/hostname": name, ZONE: f"zone-{i % 4}"})
        m[name] = NodeInfo(node)
    pods = [make_pod(f"job-{i:05d}", cpu="100m", memory="128Mi", labels={"app": "batch"})
            for i in range(n_pods)]
    return m, pods, PriorityContext(m)


def pool_phase() -> tuple[int, int, list, list, dict]:
    """Phase 10: a pool that fills.  1024 nodes (half take 4 pods, half
    110; four zones) and 10 000 identical pods at the default frontier
    settings (512-pod chunks, compaction at half the width, width floor
    128): the small half fills within the first few chunks and the loop
    compacts.  A ``backend.compact`` fault at the first compaction
    raises first (no full-width retry); then the counted run, whose
    bindings must equal the full-width kernel's and the plain scan's, with
    at most compactions + 2 host syncs; at every loop exit the refresh
    kernel is held (after the run) against ``scan_ref.refresh`` on the
    exit's state from an all-True plane, and the loop's own plane must lie
    inside that one.  Returns the run's fused-scan and refresh launches
    and the mismatches of each kernel, and the refresh's cell at the
    pool's width."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan
    from kubernetes_tpu_torch.ops import backend as backend_mod
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, scan_ref

    t0 = time.perf_counter()
    m, pods, pctx = pool_cluster()
    n_nodes, n_pods = len(m), len(pods)
    static, s, st = segment(m, pods, pctx, "cuda")
    r_full = compare(s, st)  # the full-width kernel against the plain scan
    full_ms = time_kernel(s, st)
    pool_cell = refresh_cell(f"10 pool {n_nodes}x{n_pods}", s, st)
    names = [static.node_names[j] if j >= 0 else None for j in r_full["chosen"]]

    exits: list = []

    class Recorded(backend_mod.FrontierRun):
        """Keeps each loop exit's state on the card for the checks after
        the counted run."""

        def _sync_loop(self):
            out = super()._sync_loop()
            exits.append((self.static, self._plan, {k: v.clone() for k, v in self._bufs.items()},
                          self._still.clone(), self._alive.clone(), self._ctl.clone(),
                          self._loop_thresh()))
            return out

    from kubernetes_tpu_torch.ops import frontier as frontier_mod

    gathers: list = []
    plain_gather = frontier_mod.gather_node_axis

    def recorded_gather(*args):
        gathers.append(args)
        return plain_gather(*args)

    plain_route = backend_mod.FrontierRun
    backend_mod.FrontierRun = Recorded
    try:
        # a compaction fault: the batch raises, nothing reroutes it
        faulted = backend_mod.BatchBackend(device="cuda")
        plan = FaultPlan(seed=10).on("backend.compact", mode="error", match={"phase": "gather"},
                                     first_n=1)
        raised = False
        with plan.armed():
            try:
                faulted.schedule_batch(pods, m, pctx)
            except FaultInjected:
                raised = True
        if not raised or plan.fired.get("backend.compact") != 1 or faulted.stats["kernel_pods"]:
            raise AssertionError("phase 10: the compaction fault did not raise the batch")
        exits.clear()
        gathers.clear()
        frontier_mod.gather_node_axis = recorded_gather
        backend = backend_mod.BatchBackend(device="cuda")
        torch.cuda.synchronize()
        fused_scan.launches = frontier_refresh.launches = 0
        t1 = time.perf_counter()
        got = backend.schedule_batch(pods, m, pctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, refresh_launches = fused_scan.launches, frontier_refresh.launches
    finally:
        backend_mod.FrontierRun = plain_route
        frontier_mod.gather_node_axis = plain_gather
    gather_cell(gathers)
    st_b = backend.stats
    lf = backend.last_frontier[0]
    fused_errs = [sum(a != b for a, b in zip(got, names))
                  + int(backend.algorithm._round_robin != r_full["rr"]), r_full["max_abs_err"]]
    # the refresh kernel at every loop exit, from an all-True plane
    refresh_errs = []
    for ex_static, pl, bufs, still_loop, alive_loop, ctl, thresh in exits:
        n = ex_static.n_pad
        state = fused_scan.unpack_state(ex_static, bufs, int(ctl[fused_scan.CTL_RR]))
        g = ex_static.static_ok.shape[0]
        ones = torch.zeros((g, pl.ns), dtype=torch.bool, device="cuda")
        ones[:, :n] = True
        still, alive = ones.clone(), torch.zeros(pl.ns, dtype=torch.bool, device="cuda")
        ctl[fused_scan.CTL_STOP] = 0
        frontier_refresh.launch(ex_static, bufs, pl, still, alive, ctl, thresh)
        want, want_alive, want_n, want_stop = scan_ref.refresh(
            ex_static, dataclasses.replace(state, still_ok=ones[:, :n].clone()), thresh)
        torch.cuda.synchronize()
        err = (int((still[:, :n] != want.still_ok).sum()) + int((alive[:n] != want_alive).sum())
               + abs(int(ctl[fused_scan.CTL_ALIVE]) - want_n)
               + int(bool(ctl[fused_scan.CTL_STOP]) != want_stop))
        # the loop's plane is the seed's intersected with it, never wider
        err += int((still_loop[:, :n] & ~want.still_ok).sum())
        err += abs(int(alive_loop[:n].sum()) - scan_ref.alive_of(still_loop[:, :n],
                                                                 ex_static.node_exists)[1])
        refresh_errs.append(err)
    print(f"phase 10 pool that fills, {n_nodes} nodes (half of 4 pods, half of 110) x {n_pods} "
          f"identical pods, frontier defaults: bound {sum(x is not None for x in got)}, frontier "
          f"route == full-width kernel == scan_ref (mismatches {fused_errs[0]}), rr "
          f"{backend.algorithm._round_robin}; widths {lf['widths']}, alive_frac "
          f"{lf['alive_frac']}, compactions {lf['compactions']}, chunks {lf['chunks']}, "
          f"host_syncs {lf['host_syncs']}; launches {launches} fused + {refresh_launches} "
          f"refresh; refresh kernel == scan_ref.refresh at {len(exits)} loop exits (mismatches "
          f"{sum(refresh_errs)}); a gather fault raised the batch first", flush=True)
    print(f"phase 10 times: frontier route wall {wall:.3f} s, its kernel_ms {st_b['kernel_ms']:.3f} "
          f"(tensorize {st_b['tensorize_s']:.3f} s, dispatch {st_b['dispatch_s']:.3f} s, device "
          f"wait {st_b['device_wait_s']:.3f} s); the full-width kernel {full_ms:.3f} ms; plain scan "
          f"{r_full['plain_ms']:.1f} ms ({time.perf_counter() - t0:.1f} s)", flush=True)
    if (any(fused_errs) or any(refresh_errs) or lf["compactions"] < 1 or not exits
            or lf["host_syncs"] > lf["compactions"] + 2 or launches < 1 or refresh_launches < 1
            or st_b["oracle_pods"] != 0):
        raise AssertionError(f"phase 10: {fused_errs}, {refresh_errs}, {lf}, {st_b}")
    return launches, refresh_launches, fused_errs, refresh_errs, pool_cell


UNREACHABLE = "node.alpha.kubernetes.io/unreachable"
DEFAULT_TOLERATIONS = {"node.alpha.kubernetes.io/notReady", UNREACHABLE}


def mount_of(path: str) -> str:
    """The file system ``path`` lies on (its mount point and type), from
    /proc/self/mounts: whether an fsync there reaches a disk."""
    path = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/self/mounts") as f:
        for line in f:
            parts = line.split()
            mnt, fstype = parts[1], parts[2]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return f"{best[0]} ({best[1]})"


def _capture(fn):
    """Run ``fn()``; return the exception it raised, else None (for a
    thread whose failure the caller re-raises)."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - handed to the joining thread
        return e
    return None


def admitted_parity(workdir: str, n_nodes: int = 1000, n_pods: int = 2000) -> tuple[int, int]:
    """Phase 11a: 1000 nodes (a tenth tainted unreachable:NoExecute), the
    objects the chain reads, 2000 pods with no requests POSTed one at a
    time through the apiserver at its defaults, three POSTs it must
    refuse; then the scheduler daemon binds them, and its bindings and rr
    are held against the sequential oracle and the in-process batch path
    (each segment kernel == scan_ref) over the objects as read back.
    Returns the daemon's fused-scan and refresh launches."""
    from kubernetes_tpu_torch.api import (
        LimitRange,
        LimitRangeItem,
        Namespace,
        ObjectMeta,
        PriorityClass,
        Quantity,
        ResourceQuota,
        Taint,
    )
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client import Clientset, RemoteStore
    from kubernetes_tpu_torch.client.remote import ForbiddenError
    from kubernetes_tpu_torch.scheduler.generic_scheduler import GenericScheduler
    from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext
    from kubernetes_tpu_torch.store import NotFoundError
    from kubernetes_tpu_torch.testutil import make_pod
    from kubernetes_tpu_torch.workload import make_nodes, make_pods, make_services

    seed = 12
    rng = random.Random(seed)
    nodes = make_nodes(n_nodes, rng, "mixed")
    for i, node in enumerate(nodes):
        if i % 10 == 0:
            node.spec.taints.append(Taint(key=UNREACHABLE, effect="NoExecute"))
    tainted = {n.meta.name for i, n in enumerate(nodes) if i % 10 == 0}
    pods = make_pods(n_pods, rng, "mixed")
    for i, pod in enumerate(pods):
        pod.meta.namespace = "tenant-a"
        for c in pod.spec.containers:
            c.resources.requests = {}
        pod.spec.priority_class_name = "high" if i % 2 == 0 else ""
    d = Daemons(workdir, "11a", admitted=True)
    try:
        cs = Clientset(RemoteStore(d.url, timeout=120.0))
        cs.nodes.create_many(nodes)
        cs.services.create_many(make_services())
        M = ObjectMeta
        cs.namespaces.create(Namespace(meta=M(name="tenant-a")))
        cs.limitranges.create(LimitRange(meta=M(name="defaults", namespace="tenant-a"), limits=[
            LimitRangeItem(default_request={"cpu": Quantity("100m"),
                                            "memory": Quantity("128Mi")})]))
        cs.priorityclasses.create(PriorityClass(meta=M(name="high"), value=1000))
        cs.priorityclasses.create(PriorityClass(meta=M(name="batch"), value=0,
                                                global_default=True))
        cs.resourcequotas.create(ResourceQuota(meta=M(name="pods", namespace="tenant-a"),
                                               hard={"pods": Quantity(str(n_pods))}))
        t = time.perf_counter()
        for pod in pods:  # one POST each, through the chain
            cs.pods.create(pod)
        create_s = time.perf_counter() - t
        ghost = make_pod("ghost-class", namespace="tenant-a")
        ghost.spec.priority_class_name = "ghost"
        refusals = {}
        for want, pod in (("ResourceQuota", make_pod("over-quota", namespace="tenant-a")),
                          ("NamespaceLifecycle", make_pod("lost", namespace="nowhere")),
                          ("Priority", ghost)):
            try:
                cs.pods.create(pod)
                raise AssertionError(f"phase 11a: {pod.meta.key} was admitted")
            except ForbiddenError as e:
                if f"admission denied by {want}" not in str(e):
                    raise AssertionError(f"phase 11a: {pod.meta.key} refused by another "
                                         f"plugin: {e}")
                refusals[pod.meta.key] = want
            try:
                cs.store.get("Pod", pod.meta.namespace, pod.meta.name)
                raise AssertionError(f"phase 11a: the refused {pod.meta.key} is stored")
            except NotFoundError:
                pass
        # the objects as admitted, read back before anything binds: the
        # oracle and the in-process batch path run on them while the
        # scheduler daemon starts (a thread waits for it to serve)
        admitted, _ = cs.store.list("Pod")
        nodes_back, _ = cs.store.list("Node")
        services_back, _ = cs.store.list("Service")
        started: list = []
        starter = threading.Thread(target=lambda: started.append(
            _capture(d.start_scheduler)))
        starter.start()
        m = {n["metadata"]["name"]: NodeInfo(api.Node.from_dict(n)) for n in nodes_back}
        pods_back = [api.Pod.from_dict(i) for i in admitted]
        pctx = PriorityContext(m, services=[api.Service.from_dict(x) for x in services_back])
        algo = GenericScheduler()
        want = oracle_bindings(m, pods_back, pctx, algo)
        batch, seen, backend = checked_batch(m, pods_back, pctx)
        starter.join()
        if started[0] is not None:
            raise started[0]
        deadline = time.monotonic() + 180
        while True:
            items, _ = cs.store.list("Pod")
            if all((i["spec"].get("nodeName") for i in items)) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        st = d.stop_scheduler()
    except BaseException:
        print(f"phase 11a scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
        raise
    finally:
        d.close()
    got = {f"{i['metadata']['namespace']}/{i['metadata']['name']}": i["spec"].get("nodeName")
           for i in items}
    if [i["metadata"]["name"] for i in items] != [p.meta.name for p in pods_back]:
        raise AssertionError("phase 11a: the LIST order changed between the reads")
    # the admitted fields, exactly
    bad_fields = 0
    high_names = {p.meta.name for p in pods[::2]}
    for i in items:
        spec = i["spec"]
        high = i["metadata"]["name"] in high_names
        tols = {t["key"]: t for t in spec.get("tolerations") or []}
        ok = (all((c.get("resources") or {}).get("requests") == {"cpu": "100m",
                                                                  "memory": "128Mi"}
                  for c in spec["containers"])
              and DEFAULT_TOLERATIONS <= set(tols)
              and all(tols[k].get("tolerationSeconds") == 300 and tols[k]["effect"] == "NoExecute"
                      for k in DEFAULT_TOLERATIONS)
              and spec.get("priority") == (1000 if high else 0)
              and spec.get("priorityClassName") == ("high" if high else "batch"))
        bad_fields += not ok
    on_tainted = sum(1 for n in got.values() if n in tainted)
    # the daemon against the sequential oracle over the read-back objects,
    # in LIST order (the order the daemon drained them)
    mismatches = sum(got[p.meta.key] != w for p, w in zip(pods_back, want))
    batch_mismatch = sum(a != b for a, b in zip(batch, want))
    print(f"phase 11a apiserver at its defaults (admission on), {n_nodes} nodes ({len(tainted)} "
          f"tainted {UNREACHABLE}:NoExecute) x {n_pods} pods POSTed one at a time in "
          f"{create_s:.3f} s ({n_pods / create_s:.1f} creates/s through the chain); refused with "
          f"403: {refusals}; admitted fields wrong on {bad_fields} pods; bound "
          f"{sum(1 for n in got.values() if n)}, {on_tainted} on the tainted nodes; daemon vs "
          f"sequential oracle over the read-back objects: mismatches {mismatches}, rr "
          f"{st['round_robin']} vs {algo._round_robin}; in-process batch path: {len(seen)} "
          f"segments kernel == scan_ref, bindings vs oracle mismatches {batch_mismatch}, rr "
          f"{backend.algorithm._round_robin}; daemon drains {st['waves']} launches "
          f"{st['launches']} refresh_launches {st['refresh_launches']}", flush=True)
    if (bad_fields or len(refusals) != 3 or mismatches or batch_mismatch or not seen
            or st["round_robin"] != algo._round_robin
            or backend.algorithm._round_robin != algo._round_robin
            or not all(got.values()) or on_tainted == 0 or st["oracle_pods"] != 0
            or st["launches"] < 1):
        raise AssertionError(f"phase 11a failed: {bad_fields} {refusals} {mismatches} "
                             f"{batch_mismatch} {on_tainted} {st}")
    return st["launches"], st["refresh_launches"]


def crash_recovery(workdir: str, pps_6a: float, n_nodes: int = 5000, n_pods: int = 20000,
                   waves: int = 5) -> tuple[int, int]:
    """Phase 11b: 6a's cell in 5 waves through a durable apiserver at its
    defaults; once wave 3's creates are acknowledged, while the daemon
    drains and binds them, the client LISTs the pods and the apiserver is
    SIGKILLed and restarted on the same port and directory.  The scheduler daemon is not restarted.  Returns its
    fused-scan and refresh launches."""
    from kubernetes_tpu_torch.client import RemoteStore
    from kubernetes_tpu_torch.workload import overcommitted_nodes, run_wire_churn

    data = os.path.join(workdir, "11b-data")
    d = Daemons(workdir, "11b", admitted=True, data_dir=data)
    try:
        d.start_scheduler()
        rs = RemoteStore(d.url, timeout=120.0)

        def drill() -> dict:
            t = time.perf_counter()
            items, rev = rs.list("Pod")
            acked = {i["metadata"]["name"]: i["spec"]["nodeName"] for i in items
                     if i["spec"].get("nodeName")}
            list_s = time.perf_counter() - t
            return {"acked": acked, "list_rev": rev, "list_s": list_s, **d.crash_apiserver()}

        r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=0,
                           wave_deadline_s=120, crash=(2, drill))
        text = d.metrics_text()
        st = d.stop_scheduler()
        pods_now, _ = rs.list("Pod")
        nodes_now, _ = rs.list("Node")
    except BaseException:
        print(f"phase 11b scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
        raise
    finally:
        d.close()
    c = r["crash"]
    now = {i["metadata"]["name"]: i["spec"].get("nodeName") for i in pods_now}
    lost = sorted(k for k, v in c["acked"].items() if now.get(k) != v)
    over = overcommitted_nodes(pods_now, nodes_now)
    reconnects = metric_value(text, "client_watch_reconnects_total")
    gaps = metric_value(text, "client_watch_gaps_total")
    per_wave = n_pods // waves
    pps_12 = 2 * per_wave / (r["wave_s"][0] + r["wave_s"][1])
    c2b = r["create_to_bind_ms"]
    print(f"phase 11b durable apiserver at its defaults ({mount_of(data)}), {n_nodes}x{n_pods} "
          f"mixed in {waves} waves: SIGKILL once wave 3's creates were acknowledged, while the "
          f"daemon bound them ({c['pending_at_crash']} of its {per_wave} pods unbound as the "
          f"client saw it); the LIST before the kill held "
          f"{len(c['acked'])} bound pods at revision {c['list_rev']} ({c['list_s']:.3f} s); "
          f"restarted in {c['restart_s']:.3f} s, recovery: revision {c['revision']}, records "
          f"replayed {c['replayed']}, torn tail {c['torn_tail']}, truncated bytes "
          f"{c['truncated_bytes']}; acknowledged binds lost {len(lost)}; bound {r['bound']} "
          f"unbound {r['unbound']}; nodes over capacity {len(over)}; the daemon's watch "
          f"reconnects {reconnects:.0f}, gaps {gaps:.0f}", flush=True)
    print(f"phase 11b pods_per_s {r['pods_per_sec']:.1f} create_to_bind_p50_ms {c2b['p50']:.1f} "
          f"create_to_bind_p99_ms {c2b['p99']:.1f}; wave seconds "
          + " ".join(f"{x:.3f}" for x in r["wave_s"]) + "; create seconds "
          + " ".join(f"{x:.3f}" for x in r["create_s"])
          + f"; waves 1-2 {pps_12:.1f} pods/s (--data-dir) beside 6a's {pps_6a:.1f} (no "
          f"admission, in memory, this call); daemon launches {st['launches']} refresh_launches "
          f"{st['refresh_launches']} drains {st['waves']} bound {st['bound']} oracle_pods "
          f"{st['oracle_pods']}", flush=True)
    if (lost or over or r["bound"] != n_pods or r["unbound"] or not all(now.values())
            or reconnects + gaps <= 0 or not c["acked"] or c["replayed"] <= 0
            or st["oracle_pods"] != 0 or st["launches"] < waves):
        raise AssertionError(f"phase 11b failed: lost {lost[:5]}, over {over[:5]}, "
                             f"{r['bound']}/{n_pods}, reconnects {reconnects} gaps {gaps}, {st}")
    return st["launches"], st["refresh_launches"]


def fsync_cost(workdir: str, n_nodes: int = 5000, per_wave: int = 2000,
               reps: int = 3) -> tuple[int, int]:
    """Phase 11c: at 5000 nodes, one 2000-pod wave under each of: no flag,
    ``--data-dir``, ``--data-dir --fsync`` (each arm its own apiserver at
    its defaults and scheduler daemon, all started first), three waves an
    arm interleaved (arm by arm within a round).  Returns the daemons'
    fused-scan and refresh launches."""
    from kubernetes_tpu_torch.workload import run_wire_churn

    arms = [("memory", {}), ("data-dir", {"data_dir": os.path.join(workdir, "11c-dd")}),
            ("fsync", {"data_dir": os.path.join(workdir, "11c-fs"), "fsync": True})]
    order = [(w, a) for w in range(reps) for a in range(len(arms))]
    cv = threading.Condition()
    pos = [0]
    ready = threading.Barrier(len(arms))
    results: dict = {}
    errors: list = []
    ds = []
    try:
        # the arms' daemons start together: each pair's start-up is idle waiting
        made: list = [None] * len(arms)

        def start(a: int) -> None:
            made[a] = Daemons(workdir, f"11c-{arms[a][0]}", admitted=True, **arms[a][1])
            made[a].start_scheduler()

        errs = [None] * len(arms)
        starters = [threading.Thread(target=lambda a=a: errs.__setitem__(a, _capture(
            lambda: start(a)))) for a in range(len(arms))]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        ds = [d for d in made if d is not None]
        if any(errs):
            raise RuntimeError(f"phase 11c start-up: {errs}")

        def run(a: int) -> None:
            def before(w):
                if w == 0:
                    ready.wait(timeout=300)
                deadline = time.monotonic() + 300
                with cv:
                    while order[pos[0]] != (w, a):
                        if errors or time.monotonic() > deadline:
                            raise RuntimeError(f"arm {arms[a][0]}: its turn never came")
                        cv.wait(timeout=0.5)

            def after(w):
                with cv:
                    pos[0] = min(pos[0] + 1, len(order) - 1)
                    cv.notify_all()

            try:
                results[a] = run_wire_churn(ds[a].url, n_nodes, per_wave * reps, reps, "mixed",
                                            seed=11, before_wave=before, on_wave=after)
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors.append((arms[a][0], e))
                ready.abort()
                with cv:
                    cv.notify_all()

        threads = [threading.Thread(target=run, args=(a,)) for a in range(len(arms))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"phase 11c: {errors}")
        stats = [d.stop_scheduler() for d in ds]
    except BaseException:
        for d in ds:
            print(f"phase 11c {d.tag} scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
        raise
    finally:
        for d in ds:
            d.close()
    for a, (name, kw) in enumerate(arms):
        r = results[a]
        create = r["create_s"]
        bind = [w - c for w, c in zip(r["wave_s"], create)]
        p99 = r["wave_c2b_p99_ms"]

        def spread(xs):
            return f"mean {sum(xs) / len(xs):.4f} [{min(xs):.4f}, {max(xs):.4f}]"

        where = mount_of(kw["data_dir"]) if kw else "-"
        print(f"phase 11c arm {name} (data dir on {where}), {n_nodes} nodes, {reps} waves of "
              f"{per_wave} pods: create s {spread(create)}; bind s {spread(bind)}; create->bind "
              f"p99 ms {spread(p99)}; bound {r['bound']} unbound {r['unbound']}; launches "
              f"{stats[a]['launches']}", flush=True)
        if r["bound"] != per_wave * reps or stats[a]["oracle_pods"] != 0:
            raise AssertionError(f"phase 11c arm {name}: {r['bound']} bound, {stats[a]}")
    return (sum(s["launches"] for s in stats), sum(s["refresh_launches"] for s in stats))


def admitted_phase(pps_6a: float) -> tuple[int, int]:
    """Phase 11: the apiserver as the JAX package starts it.  Returns the
    daemons' fused-scan and refresh launches over 11a-11c."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        la, ra = admitted_parity(workdir)
        t1 = time.perf_counter()
        lb, rb = crash_recovery(workdir, pps_6a)
        t2 = time.perf_counter()
        lc, rc = fsync_cost(workdir)
    t3 = time.perf_counter()
    print(f"phase 11 took {t3 - t0:.1f} s: 11a {t1 - t0:.1f}, 11b {t2 - t1:.1f}, 11c "
          f"{t3 - t2:.1f}; launches {la} + {lb} + {lc} fused, {ra} + {rb} + {rc} refresh",
          flush=True)
    return la + lb + lc, ra + rb + rc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.ops import _build, frontier_refresh, fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.scheduler.generic_scheduler import GenericScheduler

    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 1 card: {card}", flush=True)

    t0 = time.perf_counter()
    built = {}

    def build(name: str) -> None:
        _build.build(name, verbose=True)  # prints ptxas registers and spills
        built[name] = time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:  # one nvcc a source, started together
        list(pool.map(build, ("fused_scan", "frontier_refresh")))
    fused_scan.load()
    frontier_refresh.load()
    print(f"phase 2 build: fused_scan {built['fused_scan']:.1f}s, frontier_refresh "
          f"{built['frontier_refresh']:.1f}s, both {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    helpers = native.helpers()
    print(f"phase 2 host helpers: matcher {helpers['matcher']}, fastcopy {helpers['fastcopy']} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    # -- phase 3: kernel vs plain on the card; oracle vs backend ----------
    for workload in ("mixed", "plain"):
        m, pods, pctx = cluster(1000, 2000, workload, seed=1)
        _, s, st = segment(m, pods, pctx, "cuda")
        r = compare(s, st)
        print(f"phase 3 {workload} 1000x2000: kernel == scan_ref, bound {r['bound']}/"
              f"{r['pods']}, rr {r['rr']}, max_abs_err {r['max_abs_err']}", flush=True)
    shape_errs, shape_cells = repaired_shapes()
    refresh_ports = shape_cells.pop("refresh_ports_600")
    wide_wave()
    m, pods, pctx = cluster(1000, 300, "mixed", seed=2)
    oracle = GenericScheduler()
    want = oracle_bindings(m, pods, pctx, oracle)
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
    runs = []
    for frontier in (False, True, True, False):  # in turns
        runs.append(batch_run(m, pods, pctx, frontier))
    main = next(r for r in runs if r["frontier"])  # the default route: the main path
    launches, refresh_launches = main["launches"], main["refresh_launches"]
    walls = {f: [r["wall"] for r in runs if r["frontier"] == f] for f in (True, False)}
    print(f"phase 4 frontier on/off in turns: walls on {walls[True]} off {walls[False]}, "
          f"ratio of the means on/off {sum(walls[True]) / sum(walls[False]):.4f}; card {card}",
          flush=True)

    # the main path's segment: its bindings against the plain version
    r_main = compare(s_main, st_main)
    names = [main_static.node_names[j] if j >= 0 else None for j in r_main["chosen"]]
    for r in runs:
        if names != r["assignments"] or r["rr"] != r_main["rr"]:
            raise AssertionError(f"BatchBackend (frontier {r['frontier']}) bindings != scan_ref "
                                 "on the main-path segment")
    print(f"phase 4 main segment: kernel == scan_ref == BatchBackend with the frontier on and "
          f"off, rr {r_main['rr']}", flush=True)
    print(plan_line("main segment", s_main, st_main), flush=True)
    other_errs, refresh_wide = other_segments()
    errs = [r_main["max_abs_err"], *other_errs, *shape_errs]

    ms = time_kernel(s_main, st_main)
    plain_ms = r_main["plain_ms"]
    bound_ms, bound_by, detail = bound(s_main, st_main)
    chunk_ms = time_chunk(s_main, st_main)
    print(f"phase 4 times on the main segment ({s_main.n_pad} nodes x {s_main.p_real} pods): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({detail['bytes']} bytes, {detail['ops']} ops); one 512-pod chunk "
          f"launch (write-back on) {chunk_ms:.3f} ms, x {-(-s_main.p_real // 512)} chunks "
          f"{chunk_ms * -(-s_main.p_real // 512):.3f} ms (device times: launches behind a "
          f"device-side sleep)", flush=True)
    refresh_main = refresh_cell("4 main segment", s_main, st_main)
    loop_cell(*segment(m, pods, pctx, "cuda", frontier=True)[1:], card)
    node_cache_cell(main_static)

    (churn_launches, churn_refresh), lazy_pps = churn_phase()
    (eager_launches, _), eager_pps = churn_phase(lazy_ingest=False)
    print(f"phase 5c ingest A/B in this call, 5000x20000 mixed churn: lazy, framed "
          f"{lazy_pps:.1f} pods/s (5a) against eager {eager_pps:.1f} pods/s (5c), "
          f"ratio {lazy_pps / eager_pps:.3f}", flush=True)
    daemon_launches, pps_6a, idle_6a, daemon_refresh = daemon_phase()
    preemption_launches, _ = preemption_phase()
    policy_launches = policy_phase()
    policy_daemon_phase()
    traced_launches = traced_daemon_phase(pps_6a, idle_6a)
    fault_launches = faults_phase()
    overload_launches, _ = overload_phase()
    pool_launches, pool_refresh, pool_errs, pool_refresh_errs, refresh_pool = pool_phase()
    admitted_launches, admitted_refresh = admitted_phase(pps_6a)

    entry = {
        "name": "fused_scan", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": REPLACES,
        "launches": (launches + churn_launches + daemon_launches + preemption_launches
                     + policy_launches + traced_launches + fault_launches + overload_launches
                     + pool_launches + admitted_launches),
        "launches_by_path": {"batch": launches, "churn": churn_launches,
                             "daemon": daemon_launches, "churn_eager": eager_launches,
                             "preemption": preemption_launches, "policy": policy_launches,
                             "traced_daemon": traced_launches, "faults": fault_launches,
                             "overload": overload_launches, "pool": pool_launches,
                             "apiserver_defaults": admitted_launches},
        # the repaired shapes' segments (phase 3): many zones, a wide port row
        "cells": shape_cells,
        "max_abs_err": max(errs + pool_errs),
        "ms": ms, "us_per_pod": ms * 1e3 / s_main.p_real, "chunk_ms": chunk_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    refresh_cells = {"pool_1024": refresh_pool, "main_5120": refresh_main,
                     "wide_20224": refresh_wide, "ports_600": refresh_ports}
    refresh_entry = {
        "name": "frontier_refresh", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/frontier_refresh.cu",
        "replaces": "kubernetes_tpu/ops/batch_kernel.py:782",
        "launches": (refresh_launches + churn_refresh + daemon_refresh + pool_refresh
                     + admitted_refresh),
        "launches_by_path": {"batch": refresh_launches, "churn": churn_refresh,
                             "daemon": daemon_refresh, "pool": pool_refresh,
                             "apiserver_defaults": admitted_refresh},
        # the main segment's width; the other widths and the launch floor in cells
        "cells": refresh_cells,
        "max_abs_err": max([c["max_abs_err"] for c in refresh_cells.values()]
                           + pool_refresh_errs),
        "ms": refresh_main["ms"], "floor_ms": refresh_main["floor_ms"],
        "host_ms": refresh_main["host_ms"], "host_same_ms": refresh_main["host_same_ms"],
        "plain_ms": refresh_main["plain_ms"],
        "bound_ms": refresh_main["bound_ms"], "bound_by": refresh_main["bound_by"],
        "library_ms": None,
    }
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [entry, refresh_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
