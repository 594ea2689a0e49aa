#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

1. the card: name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from ``kubernetes_tpu_torch/ops/csrc`` (the fused
   scan, the frontier loop's refresh, the mesh scan and the fused scan's
   super-step build of 8 pods a loop iteration, ``-DFUSED_SCAN_K=8``, one
   ``nvcc`` each, started together; meanwhile the segments of phases 3, 4,
   10 and 17b that the kernels are held against are carried to the card
   and their plain versions run there, which needs no kernel), and name which host
   helpers (``native.py``: the label matcher and the store's deep copy)
   serve, ``native`` or ``python``;
3. the kernel against its plain PyTorch version (``ops/scan_ref.py``) on
   the card, on 1000-node x 500-pod ``mixed`` and ``plain`` segments; on
   the same ``mixed`` cluster with its zone label over 16 zones (the
   kernel's shared-memory zone path, timed beside the 3-zone segment),
   over 300 zones (shared memory at the plan's 4-block cluster) and over
   1000 zones (the global-memory zone path with its second fold), each
   with its plan line, time and bound; on 2000 pods, one in three with
   its own host port, 600 distinct host ports (``BatchBackend`` cuts the batch under a signature row's port slot;
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
   launch counts read around it, its wall, kernel_ms and host syncs (with
   the frontier on, within the static budget: the ``# device: sync``
   sites ``kubernetes_tpu_torch.analysis`` sanctions in ``ops/frontier.py``,
   a loop run's and a run's); all
   four bind as one launch of the kernel on that very segment does; the
   segment's resource-axis selection (``r_sel`` [0, 1]: cpu and memory)
   and the R = 2 the kernel runs it at; then
   the kernel against the plain version on two windows of it (its first
   1024 pods from the initial state, its last 1024 from the state the
   kernel wrote back after the pods before them; the first window also
   against the plain version at full width, R = 4, from the same host
   arrays), on a 5000-node x
   500-pod one, on a 10 000-node x
   500-pod one and on a 20 000-node x 500-pod one (whose plan leaves
   planes in global memory), the kernel's plan (cluster and block size,
   the planes in shared memory), its times, one 512-pod chunk launch's
   time, the refresh kernel against its plain version at the main
   segment's width and at the 20 000-node segment's, with its device time,
   launch floor, host enqueue time and bound, and the frontier loop against
   one launch of the segment in turns; then the ``PallasSuperSteps`` gate
   on (K = 8 pods a loop iteration): the main segment's kernel at K = 8
   and K = 1 in turns (three pairs), bit-identical, each K's registers and
   local memory a thread; ``BatchBackend`` on the default route with the
   gate on, binding as the K = 1 launch does with its launches counted
   under the K = 8 build; and the K = 8 build against the plain version
   on the 5000-node x 500-pod segment (500 = 62 x 8 + 4: an inert tail);
5. the serving path: (a) ``workload.run_churn`` at full width, 20 000
   ``mixed`` pods arriving in 10 waves on 5000 nodes and served by the
   port's ``Scheduler.run_batch_loop`` on ``BatchBackend(device="cuda")``
   with events on, on the default ingest path (lazy decode, watch frames,
   columnar LIST, the frame confirm), the launch count read around it;
   (b) a 1000-node x 400-pod churn run on the card replayed wave by wave
   through the port's per-pod oracle (``workload.oracle_replay_waves``);
   (c) 5b again on the eager ingest path (typed decode of every event,
   per-event delivery), held like 5b's, its launches counted as the
   ``churn_eager`` path (5a's eager arm, the same-call A/B of ingest, is
   cut for the script's time).  Every wave prints its
   frames, frame events, lazy promotions, confirm fallbacks and decode
   seconds; 5a prints the ``DeviceNodeCache``'s reuses and the share of
   node columns uploaded;
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
   filled by 20 000 priority-0 pods, then 625 priority-100 preemptors
   (fill batch, failing batch, the cohort pass, follow-up batch; each
   batch a kernel launch): evictions per second, the cohort split (state
   build, ranking, evictions), victims == preemptors == bound after, the
   failing and follow-up batches' kernel segments against the plain scan;
   (b) 1000 nodes, 4000 fillers and 40 preemptors, a seeded tenth of
   them with a host port or a required affinity: every cohort decision
   held against the exhaustive ``find_preemption_target``, the later
   batches' kernel segments against the plain scan; (c) the two daemons
   at their defaults (batch backend, preemption on, leader election) over
   HTTP at 1000 nodes, 4000 fillers and 250 preemptors: every preemptor
   bound, the daemon's victims printed;
8. the upstream ``ClusterAutoscalerProvider`` as a policy file
   (``load_policy_file``) at 1000 x 500 ``mixed``: the scan's ``most``
   weight plane, kernel == plain scan == the sequential oracle on it;
   (8b) the daemons with a ``ServiceSpreadingPriority`` policy, which the
   scan does not express, on ``--device cuda``: 6b's parity set binds on
   the host oracle, equal to the sequential oracle on the policy, with
   ``scheduler_backend_oracle_pods_total`` > 0 on /metrics;
9. tracing, faults and overload: (a) 6a's waves of 2000 pods on 5000
   nodes, three of them, with the daemon's
   ``--trace --timeseries --telemetry-sink``: its pods/s beside 6a's, the
   chrome trace from /debug/traces (one root span a wave, the
   ``tensorize`` spans' seconds equal to the daemon's ``tensorize_s``,
   the ``dispatch`` spans' launches and ``kernel_ms`` equal to its
   launches and ``kernel_ms``), the sink's time series covering every
   wave, and the
   per-wave idle share from the spans; (b) in process on the card, 1000
   nodes and 1000 ``mixed`` pods in five waves, one fault a wave from a
   seeded ``FaultPlan`` (``backend.pallas.segment``: the wave raises and
   its pods are requeued; ``scheduler.bind``: forget, requeue, rebind;
   ``scheduler.pipeline.prep``: contained; ``backend.compact`` at the
   frontier's prefilter: the wave raises and its pods are requeued, as
   for the kernel), each with a flight-recorder dump naming the point and
   its wave, the bindings against the per-wave oracle replay; (c) ``workload.run_overload`` at 5000 nodes
   (surge at 3x the calibrated drain for at most 5 s, recovery, tail):
   each tier's goodput and e2e p50/p99, the rung timeline, transitions,
   score-plane sheds and 429s; every segment scanned with the interpod
   score plane shed is held against the plain scan afterwards, the
   ladder must engage and recover, and the tail at rung 0 must equal the
   oracle replay; the tensorizer's ``bucket_scale`` at rung 1 (2) and
   the padded signature axis it gave (a multiple of 64), which no later
   segment shrinks;
10. a pool that fills: 1024 nodes, half of them taking 4 pods and half 110,
   and 6000 identical pods at the default frontier settings (what a
   batch job draining into a nearly full node pool sends): a
   ``backend.compact`` fault at the first compaction raises; then the
   frontier route binds the batch, compacting at least once, equal to the
   full-width kernel and to the plain scan, with at most compactions + 2
   host syncs and within the static budget (phase 4's); the refresh
   kernel is held against its plain version at
   every loop exit and timed at the pool's width; the widths trajectory
   and times are printed; the same batch through the chunked host loop
   (``frontier_device_loop=False``, and a chunk of 384) binds pod for pod
   as the device loop does, a fused launch and a refresh a chunk, and
   prints its host syncs (2 x chunks - 1) beside the device loop's; and
   ``gather_node_axis`` is timed alone on the first compaction's inputs
   (phase 4 also times ``DeviceNodeCache``'s upload of the main segment's
   node statics); the batch again with the ``PallasSuperSteps`` gate on
   (the K = 8 build a chunk), equal to the K = 1 loop's bindings, counter,
   widths and compactions;
11. the apiserver as the JAX package starts it (no ``--disable-admission``:
   the default admission chain on; earlier phases keep the flag): (a) 1000
   nodes, a tenth tainted ``node.alpha.kubernetes.io/unreachable:NoExecute``,
   a namespace, a LimitRange (100m / 128Mi default requests), two
   PriorityClasses and a pod quota; 1000 pods with no requests POSTed one
   at a time (half naming ``high``) and three that must answer 403 (past
   the quota, a missing namespace, a missing class); every stored pod
   carries the admitted requests, tolerations and priority, some bind to
   the tainted nodes, the daemon's bindings and rr equal the sequential
   oracle over the objects as read back, and the in-process batch path
   over them has kernel == scan_ref on every segment; (b) 5000 nodes x
   6000 ``mixed`` pods in 5 waves of 1200 through a
   ``--data-dir`` apiserver, SIGKILLed while wave 3 is
   being bound and restarted on the same port and directory under the
   same scheduler daemon: every bind of the LIST before the kill reads
   back, every pod ends bound, no node over capacity, the daemon's watch
   reconnects on /metrics, the recovery line printed, waves 1-2's pods/s
   beside 6a's; (c) what ``--fsync`` costs: a 1000-pod wave at 1000 nodes
   under no flag, ``--data-dir`` and ``--data-dir --fsync``, one of
   each, create and bind seconds and create->bind p99 per arm;
12. auth, PKI, TLS and kubeconfig: (a) the control plane as ``cluster
   init`` starts it, at 6a's waves: the apiserver at its defaults with
   ``--tls-cert-file``, ``--tls-private-key-file``, ``--client-ca-file``
   and ``--audit-log`` (the committed test PKI,
   ``kubernetes_tpu_torch/testing/pki``: nothing is minted here), the
   scheduler daemon on ``--kubeconfig`` (its client certificate and no
   token) with ``--leader-elect`` at its defaults, and
   ``workload.run_wire_churn`` through the admin kubeconfig, 6000
   ``mixed`` pods in 3 waves on 5000 nodes, every pod bound: pods/s,
   create->bind p50/p99, the ratio to 6a's pods/s in this call, both
   kernels' launches as the daemon counted them (each > 0), the audit
   log's lines and its users (the creates ``kubernetes-admin``'s, the binds
   and the lease ``system:kube-scheduler``'s); (b) on the same server, the
   refusals: anonymous requests get 403 but ``/healthz`` and the
   ``kube-public`` configmaps; a certificate of another CA is refused at
   the handshake; a malformed bearer token gets 401; a bootstrap token
   whose Secret the admin created authenticates as
   ``system:bootstrap:<id>``, an expired one gets 401; four connections
   that send nothing do not keep the server from answering; (c) RBAC
   mode over HTTP (``--token-file``, ``--authorization-mode RBAC``, the
   grants seeded into ``--data-dir`` by ``Store``): 1000 nodes x 500
   pods in 2 waves, bindings and rr equal to the sequential oracle wave
   by wave, a token with no binding gets 403 on create;
13. a node drain under the card's scheduler: (a) the apiserver at its
   defaults, the scheduler daemon with ``--leader-elect`` at its defaults
   started once the cluster exists; 5000 nodes x 20 000 ``mixed`` pods
   (seed 7) in 10 waves, all bound; one PodDisruptionBudget an ``app``
   label, its ``status.disruptionsAllowed`` written by the script (a
   quarter of the app's pods on the drained nodes, half for ``db``, none
   for ``lonely``); ``node-00000``..``node-00499`` cordoned by one
   strategic-merge PATCH each (every node reads back with only
   ``spec.unschedulable`` changed); every pod on them evicted through
   ``pods/{name}/eviction`` from 8 threads (the 201s equal the budgets'
   sum, the 429s the rest, every budget ends at 0); a replacement for each
   evicted pod in one ``:batch`` POST over ``RemoteStore(binary=True)``;
   the daemon binds them all, none on a cordoned node, no node over
   capacity, equal to the port's sequential oracle with rr over the cluster
   as read back before the wave (run in a process of its own beside the
   rest of the phase and then beside phase 14); the wave's uploaded-column
   share from the daemon's /metrics and its ``DeviceNodeCache`` stats (a
   diff, not a full upload);
   the uncordon by JSON patch; PATCHes/s, evictions/s, the wave's pods/s
   and create->bind p50/p99, both kernels' launches as the daemon counted
   them (each > 0); (b) on the same server, ``/openapi/v2`` with a path for
   each of the registry's kinds (the JAX package's 35, federation's Cluster
   among them), an ``apps/v1beta1`` Deployment read back in hub form with
   its 25% surge resolved, a binary LIST of the 20 000 pods equal to the
   JSON LIST (both byte counts printed), and ``/apis/<group>`` proxied to a
   sample backend on loopback that an APIService names (an unregistered
   group 404);
14. a kubemark density run under the card's scheduler: (a) the apiserver
   at its defaults; 5000 hollow nodes (``kubernetes_tpu_torch.kubelet``'s
   ``HollowFleet``) register themselves from spawned processes, one for
   every two cores (``workload.run_hollow_fleet``), kubelet *i* with node
   *i*'s cpu, memory, pods and labels of the seeded ``mixed`` cluster
   (seed 7), heartbeating every 10 s (a tick's overdue ones between
   kubelets) and starting a pod 0.5 s after it
   admits it; the tenth that the cluster taints gets its taint by PATCH,
   as ``kubectl taint`` does; then the scheduler daemon (``--device
   cuda``); 3000 ``mixed`` pods in 3 ``:batch`` POSTs, each once the
   last is bound, watched from before the first: the waves' pods/s and
   create->bind p50/p99, pod startup latency p50/p99 (create to the
   Running update on the watch) against the density test's 5 s SLO,
   Running pods/s, each fleet process's tick seconds (a tick that raises
   ends its process with a nonzero exit, which fails the phase), the apiserver's
   requests by verb and resource (heartbeats are node GETs and PUTs, a
   pod's status a GET and a PUT), the daemon's node and pod events, batch,
   tensorize and dispatch seconds, the card's idle share, both kernels'
   launches (each > 0); every pod Running, no kubelet admission rejection,
   no node over capacity, no pod IP twice on a node (the count of
   addresses on more than one node printed: with no IPAM controller the
   kubelets' hash-fallback bases could meet); (b) ``python -m kubernetes_tpu_torch
   kubelet --count 1000`` as one process, 1000 ``plain`` pods in 4 waves
   through the card's scheduler, every pod Running, the bindings and rr
   equal to the sequential oracle over the cluster as read back (in a
   spawned process), the fleet's exit 0 on SIGTERM;
15. the controller manager at 2000 nodes under the card's scheduler: the
   apiserver at its defaults, a 2000-node cluster seeded as 14a's,
   registered by 4 fleet processes (500 nodes each, a quarter of every
   zone) while ``python -m
   kubernetes_tpu_torch controller-manager --leader-elect`` at its
   defaults (every controller, 2 workers, a 5 s node monitor period) and
   the scheduler daemon start; (a) 10 Deployments of 24 replicas, each
   template one of the ``mixed`` generator's request shapes (seed 7),
   maxSurge and maxUnavailable 12, each with a Service: the time until
   every Deployment is ready, the ReplicaSet controller's creates per
   second, create->bind and create->Running p50/p99 on a watch; (b) a new
   image on every Deployment: the time until each has 24 updated and
   ready replicas and its old ReplicaSet is at 0, every pod owned by the
   newest ReplicaSet; (c) one fleet process SIGKILLed: the time until the
   node lifecycle controller has marked exactly its 500 nodes
   ``Unknown`` (no other node is ever not Ready), then app-0 scaled to 48:
   none of the new pods on a lost node, no pod deleted; (d) ``kubelet
   --name real --count 1 --serve-logs --real-containers`` and a
   1-replica Deployment selecting its node: the pod's ``log``, ``exec``
   (``echo ok``), ``cp`` (PUT then GET, the same bytes), ``attach`` and
   the node proxy's ``stats/summary`` through the apiserver answer 200, an
   unknown container, ``tailLines=abc`` and an unscheduled pod 400.
   Every pod bound and Running, 0 kubelet rejections, no node over
   capacity, no IP twice on a node, each Service's Endpoints exactly its
   ready pods' IPs, 1024 distinct podCIDRs inside 10.8.0.0/14, the fused
   scan launched; printed with the controller manager's CPU share, each
   controller's syncs and queue depth, the zone states and the
   apiserver's requests by verb and resource;
16. a cluster as ``cluster init`` and ``join`` turn it up, under the card's
   scheduler: (a) ``python -m kubernetes_tpu_torch.cluster init`` at its
   defaults but the ports (the apiserver, the scheduler with the batch
   backend on ``cuda``, the controller manager, the kube-dns addon), its
   seconds to exit 0; ``join`` with a wrong token exits non-zero and
   starts no kubelet, ``join --name join-0`` and ``join-1`` with the
   printed token start a kubelet each with its hollow kube-proxy; (b) two
   fleet processes, ``kubelet --count 500 --proxy --healthz-port N``
   (kubemark's hollow node: a kubelet and a kube-proxy), their nodes
   labelled and tainted by PATCH as 14a's seeded cluster's, and ``python -m
   kubernetes_tpu_torch cloud-controller-manager --leader-elect``; 10
   Deployments x 25, each one of ``app_templates``' request shapes, a
   Service each with a named port (app-0's a LoadBalancer, app-9's
   headless): every pod Running, none rejected, no node over capacity;
   each Service by name over UDP through the addon (A: its cluster IP, or
   app-9's ready pod IPs; SRV: the Service, or a target a ready pod); on
   each fleet's /metrics every proxier's rule set equal to the one worked
   out from the Services and their ready pods (its digest, rules and
   endpoints summed, none differing); app-0's ingress IP and the fake
   cloud's balancer over every Ready node, its routes equal to the nodes'
   podCIDRs (the cloud controller manager's stats line on SIGTERM);
   Running pods/s, create->Running p50/p99, DNS lookup ms, the fleets'
   ticks, CPU shares, the apiserver's requests; (d) ``python -m
   kubernetes_tpu_torch kubectl`` on that cluster in
   ``tests/test_conformance.py``'s order, a process a command: ``get
   nodes`` lists every node, ``run web`` (50 replicas, the rolling update
   patched to a quarter), ``rollout status``, ``get pods -l run=web -o
   json`` equal to the wire (every pod bound and Running), ``set image``
   and ``rollout history`` (2 revisions), ``rollout undo`` (back to
   app:v1), ``scale`` to 10, ``expose`` (the Endpoints exactly the ready
   pods), ``logs`` and ``exec`` through the apiserver's kubelet proxy,
   ``top nodes``, ``top pods``, ``cordon`` and ``drain`` of a node holding
   a web pod (every evicted pod replaced, bound elsewhere, Running), then
   ``uncordon`` and ``delete``; (e) ``python -m
   kubernetes_tpu_torch.federation`` with the cluster joined by ``kubefed
   join``: a federated Deployment of 50 placed on it appears there with
   the federated spec, its pods Running, the federation's status rolled up
   to 50 ready, ``kubefed get-clusters`` Ready, its deletion reaching the
   member, ``unjoin``, and the federation's exit 0 on SIGTERM; the
   scheduler's fused-scan launches (its ``/metrics``) rise across (d) and
   across (e); (c) ``cluster down``:
   every process it recorded gone, the apiserver's port closed, the state
   file removed, and the scheduler's stats line in its log (``device
   cuda``, fused-scan launches > 0: the ``cluster`` path);
17. the node-axis mesh on the card (``parallel/mesh.py``,
   ``ops/csrc/mesh_scan.cu``; the shards share the one card): (a) phase 4's
   main segment (5000 x 20 000 ``mixed``, seed 0) through
   ``schedule_batch_sharded`` in 2 and 4 shards and its 20 000 x 500
   segment in 4, each equal pod for pod and in rr to the fused scan's
   launch, with the mesh kernel's device time, µs a pod and bound; (b) the
   mesh kernel against its plain version (``scan_ref.scan_shards``) at
   1000 x 256 ``mixed`` in 4 shards, on an uneven 1003-node x 128-pod
   segment padded to 1004 columns (no padded column chosen), on the
   20 000 x 500 segment's first 16 pods in 2 shards (planes the planner
   leaves partly in global memory) and on 5120 x 4 in 5000 zones in 4
   shards (the zone totals in global memory), and ``FrontierRun(mesh=)`` on a tie
   fixture (40 nodes with staggered pod caps, 300 pods) in 2, 4 and 8
   shards on the card against the same loop on the CPU, compacting at
   least once; (c) ``BatchBackend(frontier_mesh=True, mesh_devices=4)``
   under the scheduler's churn at 5000 nodes, 4 waves of 1000 pods (run
   right after phase 6, its per-pod oracle replay in a process of its own
   beside phases 7-16): every segment in mesh mode on 4 shards within
   compactions + 2 host syncs, the churn's host syncs within the static
   budget of its frontier runs (phase 4's), the per-shard upload fractions and the
   three mesh gauges set, every wave's bindings and the counter at each
   batch's start equal to the oracle's; (d) the mesh in several launches
   (mailboxes across launches at system scope, each launch on a stream of
   its own), here as launches on the one card: the main segment in 4
   shards as 2 launches of 2, bit-identical to the single launch of 4 and
   to the fused scan, both timed in turns (3 pairs) with their ratio and
   each launch's registers and spills; the tie fixture in 2 and 4 launches
   of one shard against ``scan_ref.scan_shards``; ``FrontierRun(mesh=)`` in
   2 launches on phase 10's 6000-pod pool, equal to the single launch's
   loop in bindings, counter, widths and compactions, within the static
   sync budget.  With two cards or more (a) and the loop run again with a
   launch a card, peer access on; with one, a line says so.

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

Every process the run starts, and every one those start (the cluster's
components in their own sessions, a kubelet's containers), inherits
``CHIP_SMOKE_RUN`` from the environment.  After each phase the script
stops what still carries it and names it on a ``left running`` line; at
its end, on SIGTERM or SIGINT, and past ``SELF_LIMIT_S`` (it must end
within 1200 s) it stops every such process before it exits, the last
two with a non-zero code.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# 32-bit rate that the scan's integer ALU work runs at
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
REPLACES = "kubernetes_tpu/ops/pallas_kernel.py:178"
# the same kernel's super-step loop (k_unroll > 1)
K_REPLACES = "kubernetes_tpu/ops/pallas_kernel.py:572"
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


def segment(m, pods, pctx, device, frontier: bool = False, pad_multiple: int = 128,
            shards: int = 1, full_width: bool = False):
    """One segment tensorized exactly as BatchBackend tensorizes its first
    segment of the same batch, carried to ``device`` (its resource axis cut
    to the tensorizer's ``r_sel``); ``frontier`` seeds its ``still_ok``
    plane (``frontier_seed``) for a frontier loop; ``pad_multiple`` is the
    tensorizer's node-axis padding, and ``shards`` pads the axis on to a
    multiple of a mesh's shard count (``pad_segment_to_multiple``).
    ``full_width`` adds a fourth item: the same host arrays carried with
    every resource slot (``r_sel`` cleared)."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import (HostBatchState, Tensorizer, frontier_seed,
                                                      pad_segment_to_multiple)
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    w = BatchBackend(device=device)._config_supported()
    tz = Tensorizer(pad_multiple=pad_multiple)
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
    static, init = pad_segment_to_multiple(static, init, shards)
    s, st = from_reference(vars(static), vars(init), device)
    if full_width:
        full = dict(vars(static), r_sel=None)
        return static, s, st, from_reference(full, vars(init), device)
    return static, s, st


def timed_on_card(fn) -> tuple:
    """``fn()`` between two CUDA events: its result and the ms between."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def plain_scan(s, st) -> tuple:
    """The plain version on the card: chosen (numpy), rr and its ms."""
    from kubernetes_tpu_torch.ops import scan_ref

    (want, rr), ms = timed_on_card(lambda: scan_ref.scan(s, st))
    return want.cpu().numpy(), rr, ms


def compare(s, st, plain: tuple = None) -> dict:
    """Kernel and plain version on the same inputs (``plain``: the plain
    version's ``plain_scan`` result, made before); raises on mismatch."""
    from kubernetes_tpu_torch.ops import fused_scan

    got, rr_got = fused_scan.schedule(s, st)
    want, rr_want, plain_ms = plain if plain is not None else plain_scan(s, st)
    err = int(abs(got.astype("int64") - want.astype("int64")).max()) if len(want) else 0
    if err != 0 or rr_got != rr_want:
        raise AssertionError(
            f"fused scan != scan_ref: max index diff {err}, rr {rr_got} vs {rr_want}")
    return {"max_abs_err": err, "bound": int((want >= 0).sum()), "pods": len(want),
            "rr": rr_got, "chosen": want, "plain_ms": plain_ms}


# the main segment's pods held against the plain scan: its first and its
# last MAIN_WINDOW (the plain scan of all 20 000 took 55-68 s a run, two
# windows of 4096 31.1 s)
MAIN_WINDOW = 1024


def compare_windows(s, st, whole, rr_whole: int, w: int = MAIN_WINDOW,
                    head: tuple = None) -> dict:
    """The kernel against the plain version on two windows of a segment
    whose whole launch chose ``whole`` and ended at ``rr_whole``: its first
    ``w`` pods from the initial state (one chunk launch of the frontier
    loop's, against ``scan_ref.scan_range``; the chunk's and the whole
    launch's chosen nodes and the counter exact), and its last ``w`` pods
    from the state a chunk launch of the pods before them wrote back (the
    whole launch's last ``w`` and ``rr_whole`` against ``scan_ref
    .scan_range`` from there).  The scan is sequential, so the first
    window is the whole run's own.  ``head`` is the plain version's first
    window, made before (``plain_range``).  Raises on a difference.
    Returns the plain ms and the kernel's device ms over the two
    windows."""
    import torch

    from kubernetes_tpu_torch.ops import fused_scan

    pl = fused_scan.plan(s)
    cut = s.p_real - w

    def chunk(start: int, count: int, advance: int = 0):
        """Fresh buffers advanced by a chunk launch of the first
        ``advance`` pods, and the launch of ``count`` pods from ``start``."""
        bufs = fused_scan.pack(s, st, pl)
        ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=s.device)
        ctl[fused_scan.CTL_RR] = st.round_robin
        if advance:
            fused_scan.launch(s, st, bufs, pl, start=0, count=advance, ctl=ctl)
        return bufs, ctl, lambda: fused_scan.launch(s, st, bufs, pl, start=start, count=count,
                                                     ctl=ctl)

    bufs, ctl, go = chunk(0, w)
    go()
    got = bufs["chosen"][:w].cpu().numpy()
    want, rr_want, head_ms = head if head is not None else plain_range(s, st, 0, w)
    err = int(abs(got.astype("int64") - want.astype("int64")).max())
    if err or int(ctl[fused_scan.CTL_RR]) != rr_want or list(whole[:w]) != list(want):
        raise AssertionError(f"fused scan != scan_ref on the first {w} pods: max index diff "
                             f"{err}, rr {int(ctl[fused_scan.CTL_RR])} vs {rr_want}, the whole "
                             f"launch's first {w} equal: {list(whole[:w]) == list(want)}")
    bufs, ctl, go = chunk(0, cut)
    go()
    state = fused_scan.unpack_state(s, bufs, int(ctl[fused_scan.CTL_RR]))
    want_tail, rr_tail, tail_ms = plain_range(s, state, cut, s.p_real)
    tail_err = int(abs(whole[cut:].astype("int64") - want_tail.astype("int64")).max())
    if tail_err or rr_tail != rr_whole:
        raise AssertionError(f"fused scan != scan_ref on the last {w} pods from the kernel's "
                             f"state before them: max index diff {tail_err}, rr {rr_whole} vs "
                             f"{rr_tail}")
    kernel_ms = (device_ms([chunk(0, w)[2] for _ in range(2)])[0]
                 + device_ms([chunk(cut, w, advance=cut)[2] for _ in range(2)])[0])
    return {"max_abs_err": max(err, tail_err), "pods": 2 * w, "plain_ms": head_ms + tail_ms,
            "kernel_ms": kernel_ms}


def plain_range(s, st, start: int, stop: int) -> tuple:
    """The plain version on a segment's pods ``start:stop`` from state
    ``st``: chosen (numpy), rr and its ms."""
    from kubernetes_tpu_torch.ops import scan_ref

    (want, final), ms = timed_on_card(lambda: scan_ref.scan_range(s, st, start, stop))
    return want.cpu().numpy(), final.round_robin, ms


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


# the super-step count phases 2, 4 and 10 build and run (PallasSuperSteps)
SUPERSTEP_K = 8
K_NAME = f"fused_scan_k{SUPERSTEP_K}"


@contextlib.contextmanager
def superstep(k: int):
    """The fused scan at ``k`` pods a loop iteration inside the block: the
    ``PallasSuperSteps`` gate on (off for 1) and ``KTPU_SUPERSTEP_K``."""
    from kubernetes_tpu_torch.ops import fused_scan
    from kubernetes_tpu_torch.utils.features import DEFAULT_FEATURE_GATES

    old = os.environ.get("KTPU_SUPERSTEP_K")
    os.environ["KTPU_SUPERSTEP_K"] = str(k)
    try:
        with DEFAULT_FEATURE_GATES.override("PallasSuperSteps", k > 1):
            if fused_scan.superstep_k() != k:
                raise AssertionError(f"superstep_k() is {fused_scan.superstep_k()}, not {k}")
            yield
    finally:
        if old is None:
            os.environ.pop("KTPU_SUPERSTEP_K", None)
        else:
            os.environ["KTPU_SUPERSTEP_K"] = old


@contextlib.contextmanager
def frontier_runs():
    """Every ``FrontierRun`` that finishes inside the block: its stats
    (loop runs, host syncs), for the static sync budget."""
    from kubernetes_tpu_torch.ops.frontier import FrontierRun

    done: list = []
    finalize = FrontierRun.finalize

    def recorded(self):
        out = finalize(self)
        done.append(dict(self.stats))
        return out

    FrontierRun.finalize = recorded
    try:
        yield done
    finally:
        FrontierRun.finalize = finalize


def sync_budget(runs: list) -> int:
    """The static host-sync budget of frontier ``runs``: the ``# device:
    sync`` sites the analyzer sanctions in ``ops/frontier.py``,
    ``_sync_loop``'s once a loop run and ``finalize``'s once a run (the
    bound ``tests/test_torch_analysis.py`` holds on the CPU), where each
    ``.cpu()`` is a real device sync."""
    from kubernetes_tpu_torch.analysis.device_contracts import sanctioned_sync_sites

    rel = "kubernetes_tpu_torch/ops/frontier.py"
    sites = sanctioned_sync_sites(ROOT, paths=[rel])[rel]
    return sum(sites["FrontierRun._sync_loop"] * r["loop_runs"] + sites["FrontierRun.finalize"]
               for r in runs)


def batch_run(m, pods, pctx, frontier: bool) -> dict:
    """One ``BatchBackend(device="cuda", frontier=...)`` batch with both
    kernels' launch counts set to 0 just before it and read just after."""
    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend

    backend = BatchBackend(device="cuda", frontier=frontier)
    torch.cuda.synchronize()
    fused_scan.launches = frontier_refresh.launches = 0
    fused_scan.launches_k.clear()
    t0 = time.perf_counter()
    with frontier_runs() as runs:
        assignments = backend.schedule_batch(pods, m, pctx)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, refresh = fused_scan.launches, frontier_refresh.launches
    launches_k = dict(fused_scan.launches_k)
    st = backend.stats
    budget = sync_budget(runs)
    n_bound = sum(a is not None for a in assignments)
    lf = backend.last_frontier
    print(f"phase 4 main {len(m)}x{len(pods)} mixed, frontier {'on' if frontier else 'off'}: "
          f"bound {n_bound} unbound {len(pods) - n_bound} segments {st['segments']} kernel_pods "
          f"{st['kernel_pods']} oracle_pods {st['oracle_pods']} launches {launches} "
          f"refresh_launches {refresh} host_syncs {st['host_syncs']} (static budget {budget} "
          f"over {sum(r['loop_runs'] for r in runs)} loop runs) tensorize_s "
          f"{st['tensorize_s']:.3f} dispatch_s {st['dispatch_s']:.3f} device_wait_s "
          f"{st['device_wait_s']:.3f} kernel_ms {st['kernel_ms']:.3f} wall_s {wall:.3f} "
          f"pods_per_s {len(pods) / wall:.1f} frontier {lf} superstep_k {st['superstep_k']} "
          f"launches by K {launches_k}", flush=True)
    if launches < 1 or st["oracle_pods"] != 0 or st["kernel_pods"] != len(pods):
        raise AssertionError("the main path did not run every pod through the fused kernel")
    if st["segments"] != 1:
        raise AssertionError(f"expected one segment, got {st['segments']}")
    if frontier and (refresh < 1 or not lf or lf[0]["mode"] != "loop"
                     or st["host_syncs"] > lf[0]["compactions"] + 2
                     or len(runs) != 1 or st["host_syncs"] > budget):
        raise AssertionError(f"the frontier route did not run its loop: {lf}, {st}")
    if not frontier and (refresh or lf or st["host_syncs"] != 1):
        raise AssertionError(f"the frontier was off but ran: {lf}, {st}")
    if launches_k != {st["superstep_k"]: launches}:
        raise AssertionError(f"launches by K {launches_k}: every launch should have run the "
                             f"K = {st['superstep_k']} build")
    return {"frontier": frontier, "assignments": assignments, "wall": wall,
            "rr": backend.algorithm._round_robin, "launches": launches,
            "refresh_launches": refresh, "launches_k": launches_k, "stats": dict(st)}


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


# phase 3's pods a segment (the plain scan takes ~3.3 ms a pod at 1000
# nodes); the 600 distinct host ports, one every third pod, take 2000
SHAPE_PODS = 500


def repaired_shapes() -> tuple[list, dict]:
    """Phase 3's shapes the kernel used to refuse: 16, 300 and 1000 zones,
    600 distinct host ports (and the refresh at that batch's widest port
    row), and one pod with 257.  Returns their max_abs_err and the timed
    cells."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import fused_scan

    errs, cells = [], {}
    n = SHAPE_PODS
    m, pods, pctx = cluster(1000, n, "mixed", seed=1, zones=16)
    got, seen, backend = checked_batch(m, pods, pctx)
    (pl, r, s, st), = seen
    if s.num_zones != 16 or backend.stats["kernel_pods"] != len(pods):
        raise AssertionError(f"16-zone batch: {s.num_zones} zones, {len(seen)} segments")
    zone_ms = time_kernel(s, st)
    _, s3, st3 = segment(*cluster(1000, n, "mixed", seed=1), "cuda")
    reg_ms = time_kernel(s3, st3)
    errs.append(r["max_abs_err"])
    print(f"phase 3 mixed 1000x{n} over 16 zones: kernel == scan_ref, bound {r['bound']}/"
          f"{r['pods']}, rr {r['rr']}, max_abs_err {r['max_abs_err']}; shared-memory zone path "
          f"(msg_a {pl.msg_a} words, zone arrays at {pl.zone_off}) {zone_ms:.3f} ms against "
          f"{reg_ms:.3f} ms for the same cluster's 3-zone segment (register path)", flush=True)

    for zones, where in ((300, "shared"), (1000, "global")):
        m, pods, pctx = cluster(1000, n, "mixed", seed=1, zones=zones)
        got, seen, backend = checked_batch(m, pods, pctx)
        (pl, r, s, st), = seen
        if (s.num_zones != zones or pl.zones_at != where
                or backend.stats["kernel_pods"] != len(pods)):
            raise AssertionError(f"{zones}-zone batch: {s.num_zones} zones in {pl.zones_at} "
                                 f"memory, kernel_pods {backend.stats['kernel_pods']}")
        errs.append(r["max_abs_err"])
        cells[f"zones_{zones}"] = shape_cell(f"mixed 1000x{n} over {zones} zones", pl, r, s, st)

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

    m, pods, pctx = cluster(1000, n, "mixed", seed=1)
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
    print(f"phase 3 mixed 1000x{n} with one pod of {fused_scan.MAX_PORTS + 1} host ports: "
          f"{len(seen)} segments (the pod alone in the middle one), every segment kernel == "
          f"scan_ref, bound {sum(g is not None for g in got)}/{len(pods)}, the wide pod on "
          f"{got[25]}; port widths {[x[2].g_ports.shape[1] for x in seen]}", flush=True)
    cells["wide_port_257"] = shape_cell("the 257-port pod's segment", *wide_segs[0])
    return errs, cells


# phase 4's other segments: nodes, pods, seed
OTHER_SEGMENTS = ((5000, 500, 3), (10000, 500, 4), (20000, 500, 6))


def other_segments() -> tuple[list, dict, tuple, dict]:
    """Phase 4's other segments, kernel against the plain version; returns
    their max_abs_err, the refresh's cell at the 20 000-node segment's
    width, that segment with the kernel's result (ScanStatic, ScanState,
    chosen, rr: phase 17 holds the mesh against it) and the K = 8 build's
    cell at the 5000-node segment (500 pods = 62 x 8 + 4: its last
    iteration runs 4 inert sub-steps), held against the same plain result
    and timed beside K = 1.  5000 and 10 000 nodes keep every plane in 16
    blocks' shared memory; 20 000 nodes leave spread and the node rows in
    global memory.  Their segments and plain results were made while the
    kernels built (``plain_ahead``), which freed their clusters."""
    from kubernetes_tpu_torch.ops import fused_scan

    errs, cell, wide, k_cell = [], None, None, None
    for n_nodes, n_pods, seed in OTHER_SEGMENTS:
        s, st, plain = PRE.pop(("segment", n_nodes))
        r = compare(s, st, plain)
        errs.append(r["max_abs_err"])
        print(f"phase 4 mixed {n_nodes}x{n_pods}: kernel == scan_ref, bound {r['bound']}/"
              f"{r['pods']}, rr {r['rr']}", flush=True)
        if n_nodes == 5000:
            with superstep(SUPERSTEP_K):
                rk = compare(s, st, plain)
                k_ms = time_kernel(s, st)
            errs.append(rk["max_abs_err"])
            k_cell = {"pods": rk["pods"], "max_abs_err": rk["max_abs_err"], "ms": k_ms,
                      "k1_ms": time_kernel(s, st), "plain_ms": plain[2]}
            print(f"phase 4 mixed {n_nodes}x{n_pods} at K = {SUPERSTEP_K}: kernel == scan_ref "
                  f"(the last iteration's {-rk['pods'] % SUPERSTEP_K} tail sub-steps inert), "
                  f"rr {rk['rr']}; {k_ms:.3f} ms against K = 1 {k_cell['k1_ms']:.3f} ms, plain "
                  f"{plain[2]:.1f} ms", flush=True)
        if n_nodes == 20000:
            print(plan_line(f"mixed {n_nodes}x{n_pods}", s, st), flush=True)
            if not fused_scan.plan(s).global_:
                raise AssertionError("the 20 000-node segment was meant to leave planes "
                                     "in global memory")
            cell = refresh_cell(f"4 mixed {n_nodes}x{n_pods}", s, st)
            wide = (s, st, r["chosen"], r["rr"])
    return errs, cell, wide, k_cell


def superstep_phase(m, pods, pctx, s, st, whole, rr_whole: int, names: list) -> dict:
    """Phase 4 with the ``PallasSuperSteps`` gate on: the main segment's
    kernel at K = ``SUPERSTEP_K`` and K = 1 in turns (three pairs, each
    ``time_kernel``), the K build's whole launch bit-identical to the
    K = 1 launch's ``whole`` and ``rr_whole``, each build's registers and
    local memory a thread for the plan's instantiation (as the card
    reports them), and ``BatchBackend`` on the default route with the gate
    on, its launches counted (the K build's main path), binding ``names``
    with the counter at ``rr_whole``.  Returns the K build's cell."""
    from kubernetes_tpu_torch.ops import fused_scan

    k = SUPERSTEP_K
    pl = fused_scan.plan(s)
    attrs = {kk: fused_scan.query(s, st, fused_scan.pack(s, st, pl), pl, k=kk) for kk in (1, k)}
    with superstep(k):
        got, rr = fused_scan.schedule(s, st)
    err = int(abs(got.astype("int64") - whole.astype("int64")).max())
    if err or rr != rr_whole:
        raise AssertionError(f"the K = {k} build != K = 1 on the main segment: max index diff "
                             f"{err}, rr {rr} vs {rr_whole}")
    ms = {1: [], k: []}
    for kk in (1, k, k, 1, 1, k):  # in turns
        with superstep(kk):
            ms[kk].append(time_kernel(s, st))
    with superstep(k):
        run = batch_run(m, pods, pctx, frontier=True)
    if run["assignments"] != names or run["rr"] != rr_whole:
        raise AssertionError(f"BatchBackend with PallasSuperSteps on != the K = 1 launch on the "
                             f"main segment (rr {run['rr']} vs {rr_whole})")
    ratio = sum(ms[k]) / sum(ms[1])
    print(f"phase 4 main segment at K = {k} and K = 1 in turns: {ms[k]} / {ms[1]} ms, ratio of "
          f"the means {ratio:.4f}; K = {k} == K = 1 (all {s.p_real} pods, rr {rr}); registers a "
          f"thread {attrs[k]['regs']} / {attrs[1]['regs']}, local memory (spills) "
          f"{attrs[k]['local_bytes']} / {attrs[1]['local_bytes']} bytes; BatchBackend with the "
          f"gate on == the K = 1 launch, {run['launches']} launches of the K = {k} build",
          flush=True)
    return {"batch": run["launches"], "ms": sum(ms[k]) / len(ms[k]), "ms_turns": ms[k],
            "k1_ms_turns": ms[1], "ratio": ratio, "max_abs_err": err,
            "regs": {str(kk): a["regs"] for kk, a in attrs.items()},
            "local_bytes": {str(kk): a["local_bytes"] for kk, a in attrs.items()}}


INGEST_KEYS = ("frames", "frame_events", "promotions", "confirm_fallbacks", "decode_s")
# over the wire the watch readers also parse each line before the decode
WIRE_KEYS = INGEST_KEYS + ("parse_s",)
SECONDS_KEYS = ("decode_s", "parse_s")


def ingest_line(ph: dict, keys: tuple = INGEST_KEYS) -> str:
    return " ".join(f"{k} {ph[k]:.4f}" if k in SECONDS_KEYS else f"{k} {int(ph[k])}"
                    for k in keys)


def churn_phase() -> tuple[int, int]:
    """Phase 5a-5b: the serving path at full width on the default ingest
    path, then per-wave oracle parity of a smaller churn run.  Returns the
    fused-scan and the refresh kernels' launches of the full-width run."""
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.workload import run_churn

    n_nodes, n_pods, waves = 5000, 20000, 10
    fused_scan.launches = frontier_refresh.launches = 0
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=0, device="cuda")
    launches, refresh = fused_scan.launches, frontier_refresh.launches
    st = r["backend"]
    nc = r["node_cache"]
    e2e = r["e2e_scheduling_ms"]
    print(f"phase 5a churn {n_nodes}x{n_pods} mixed in {waves} waves, lazy, framed ingest: "
          f"bound {r['bound']} "
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
        print(f"phase 5a wave {w}: bound {ph['bound']} " + " ".join(
            f"{k} {ph[k]:.4f}" for k in ("pump_s", "apply_s", "tensorize_s", "dispatch_s",
                                        "device_wait_s", "commit_s", "prep_s", "kernel_ms"))
              + " " + ingest_line(ph), flush=True)
    idle = 1.0 - st["kernel_ms"] / 1e3 / r["wall_s"]
    print(f"phase 5a device idle share over the wall (1 - kernel_ms / wall): {idle:.4f}",
          flush=True)
    totals = {k: sum(ph[k] for ph in r["phase_timers"]) for k in INGEST_KEYS}
    if totals["frames"] <= 0 or totals["promotions"] <= 0:
        raise AssertionError(f"the default ingest path ran no frames or promotions: {totals}")
    if launches < waves:
        raise AssertionError(f"churn launched the fused kernel {launches} times in {waves} waves")
    if st["oracle_pods"] != 0 or st["kernel_pods"] != r["drained"]:
        raise AssertionError("the churn path did not run every drained pod through the scan")
    if r["bound"] + r["unbound"] != r["pods"] or r["scheduled_events"] != r["bound"]:
        raise AssertionError(f"churn accounting: bound {r['bound']} unbound {r['unbound']} "
                             f"events {r['scheduled_events']} of {n_pods} pods")

    churn_parity()
    return launches, refresh


def churn_parity(lazy_ingest: bool = True) -> tuple[int, int]:
    """Phase 5b: a 1000-node x 400-pod churn run on the card replayed wave
    by wave through the per-pod oracle; ``lazy_ingest=False`` runs it on
    the eager ingest path (phase 5c).  Returns the run's fused-scan and
    refresh launches."""
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan
    from kubernetes_tpu_torch.workload import oracle_replay_waves, run_churn

    b = "5b" if lazy_ingest else "5c"
    path = "lazy, framed ingest" if lazy_ingest else "eager ingest"
    n_nodes, n_pods, waves, seed = 1000, 400, 4, 5
    fused_scan.launches = frontier_refresh.launches = 0
    r = run_churn(n_nodes, n_pods, waves, "mixed", seed=seed, device="cuda",
                  lazy_ingest=lazy_ingest)
    launches, refresh = fused_scan.launches, frontier_refresh.launches
    if launches <= 0:
        raise AssertionError(f"phase {b}: the churn run launched no fused scan")
    for w, ph in enumerate(r["phase_timers"]):
        print(f"phase {b} wave {w}: bound {ph['bound']} " + ingest_line(ph), flush=True)
    totals = {k: sum(ph[k] for ph in r["phase_timers"]) for k in INGEST_KEYS}
    if not lazy_ingest and (totals["frames"] or totals["promotions"]):
        raise AssertionError(f"the eager ingest path ran frames or lazy views: {totals}")
    o = oracle_replay_waves(r["drain_batches"], r["assignments"], n_nodes, n_pods,
                            "mixed", seed)
    print(f"phase {b} churn {n_nodes}x{n_pods} in {waves} waves, {path}, vs per-wave oracle "
          f"replay: {o['mode']}, checked {o['checked']}, mismatches {o['mismatches']}, rr "
          f"{r['round_robin']} vs {o['round_robin']}", flush=True)
    if (o["mode"] != "exact per-wave replay" or o["checked"] != r["pods"]
            or o["mismatches"] != 0 or o["round_robin"] != r["round_robin"]):
        raise AssertionError(f"churn bindings != per-wave oracle replay: {o}")
    return launches, refresh


def free_port() -> int:
    """A free loopback port below the kernel's ephemeral range: a port in
    that range can be taken by a client's outgoing connection between this
    pick and the daemon's bind (phase 14's fleet opens tens of thousands)."""
    lo = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    pick = random.SystemRandom()
    for _ in range(1000):
        port = pick.randrange(max(1024, lo - 16384), lo)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free loopback port below {lo}")


RUN_TAG = "CHIP_SMOKE_RUN"
# past this the script stops itself, and every process it started, before
# the 1200 s it has
SELF_LIMIT_S = 1180.0


def own_processes() -> dict:
    """pid -> command line of every live process but this one whose
    environment carries this run's tag, the multiprocessing resource
    tracker aside (it ends once this process has)."""
    tag = f"{RUN_TAG}={os.environ[RUN_TAG]}".encode()
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                if tag not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{entry}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X"):
                    continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, IndexError):
            continue  # gone meanwhile, or not ours to read
        if "multiprocessing.resource_tracker" not in cmd:
            found[int(entry)] = cmd
    return found


def stop_own_processes(grace_s: float = 10.0, keep=()) -> dict:
    """SIGTERM what ``own_processes`` finds but the pids in ``keep`` (a
    worker meant to outlive the phase), SIGKILL what still runs
    ``grace_s`` later; returns what it found."""
    found = {pid: cmd for pid, cmd in own_processes().items() if pid not in keep}
    for pid in found:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + grace_s
    while found.keys() & own_processes().keys() and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid in found.keys() & own_processes().keys():
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return found


def http_get(url: str, ctx=None, token: str = None) -> bytes:
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
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
    daemon's stats line; ``close`` ends whatever still runs.  With ``tls``
    the apiserver serves HTTPS with the test PKI's serving pair (``ctx``
    trusts its CA); ``api_extra`` adds flags, ``health_token`` is the bearer
    token its /healthz probe sends, and ``connect`` replaces the
    scheduler's ``--apiserver URL`` (a ``--kubeconfig``, a ``--token``)."""

    def __init__(self, workdir: str, tag: str, admitted: bool = False,
                 data_dir: str = None, fsync: bool = False, tls: bool = False,
                 api_extra: tuple = (), health_token: str = None):
        self.workdir, self.tag = workdir, tag
        self.api_port, self.health_port = free_port(), free_port()
        self.url = f"{'https' if tls else 'http'}://127.0.0.1:{self.api_port}"
        self.ctx = None
        self.health_token = health_token  # a bearer token for the apiserver's /healthz
        self.env = {**os.environ, "PYTHONPATH": ROOT}
        self.scheduler = None
        self.connect = ["--apiserver", self.url]
        self.api_args = ["kubernetes_tpu_torch.apiserver", "--port", str(self.api_port)]
        if not admitted:
            self.api_args.append("--disable-admission")
        if data_dir:
            self.api_args += ["--data-dir", data_dir] + (["--fsync"] if fsync else [])
        if tls:
            import ssl

            from kubernetes_tpu_torch.testing import pki as fixture

            self.ctx = ssl.create_default_context(cafile=fixture.path("ca.crt"))
            self.api_args += ["--tls-cert-file", fixture.path("apiserver.crt"),
                              "--tls-private-key-file", fixture.path("apiserver.key")]
        self.api_args += list(api_extra)
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
        wait_until(lambda: b"ok" in http_get(self.url + "/healthz", self.ctx, self.health_token),
                   self.apiserver, "apiserver /healthz", 120)

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
            "kubernetes_tpu_torch.scheduler", *self.connect, "--leader-elect",
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
    on the card: 5000 nodes, 20 000 fillers, 625 preemptors, the
    preemptor and follow-up batches' kernel segments held against the
    plain scan; (b) 1000
    nodes, 4000 fillers and 40 preemptors, a seeded tenth of them with a
    host port or a required affinity (branch and bound): every cohort
    decision held against the exhaustive ``find_preemption_target`` on the
    state it was made on, and the preemptor and follow-up batches' kernel
    segments against the plain scan; (c) the daemons at their defaults
    over HTTP, 1000 nodes, 4000 fillers and 250 preemptors.  Returns the
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
        r = run_preemption(5000, 20000, 625, device="cuda", seed=0, backend_cls=checked)
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
        # 40 preemptors (8 by branch and bound): the exhaustive oracle is
        # the phase's wall (0.15-0.25 s a decision), and the script must
        # end within its time limit
        r = run_preemption(1000, 4000, 40, device="cuda", seed=7, odd_share=0.1,
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
            w = run_wire_preemption(d.url, 1000, 4000, 250, deadline_s=120.0)
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
    LeastRequested), loaded by ``load_policy_file`` and run at 1000 x 500
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
    m, pods, pctx = cluster(1000, 500, "mixed", seed=1)
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
    """Phase 9a: three of 6a's waves with the daemon's tracing and
    continuous telemetry on.  Returns the fused-kernel launches, as the daemon
    counted them."""
    from kubernetes_tpu_torch.workload import run_wire_churn

    n_nodes, n_pods, waves = 5000, 6000, 3
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
    """Phase 9b: faults on the card, in process: 1000 nodes and 1000
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

    n_nodes, n_pods, seed = 1000, 1000, 8
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
    buckets: list = []  # (the tensorizer's bucket_scale, the padded group axis) a segment

    class ShedRecorder(BatchBackend):
        def _dispatch(self, static, init):
            buckets.append((self.tensorizer.bucket_scale, int(static.static_ok.shape[0])))
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
    r = run_overload(n_nodes=5000, surge_mult=3.0, max_surge_s=5.0, device="cuda",
                     backend_cls=ShedRecorder)
    launches = fused_scan.launches
    t1 = time.perf_counter()
    coarse = [g for scale, g in buckets if scale > 1]
    print(f"phase 9c bucket_scale: {len(coarse)} of {len(buckets)} segments at bucket_scale "
          f"{max((scale for scale, _ in buckets), default=1)} (rung >= 1), padded group axis "
          f"{sorted(set(coarse))} there, {sorted(set(g for _, g in buckets))} over the run",
          flush=True)
    if not coarse or any(g % 64 for g in coarse) or any(
            later < first for (_, first), (_, later) in zip(buckets, buckets[1:])):
        raise AssertionError(f"phase 9c: rung 1 coarsened no shape bucket: {buckets}")
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
          f"{sum(x['arrivals'] for x in r['tiers'].values())} created in the 5 s window, the "
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


def pool_cluster(n_nodes: int = 1024, n_pods: int = 6000):
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


def pool_phase() -> tuple[int, int, list, list, dict, dict, dict]:
    """Phase 10: a pool that fills.  1024 nodes (half take 4 pods, half
    110; four zones) and 6000 identical pods at the default frontier
    settings (512-pod chunks, compaction at half the width, width floor
    128): the small half fills within the first few chunks and the loop
    compacts.  A ``backend.compact`` fault at the first compaction
    raises first (no full-width retry); then the counted run, whose
    bindings must equal the full-width kernel's and the plain scan's, with
    at most compactions + 2 host syncs; at every loop exit the refresh
    kernel is held (after the run) against ``scan_ref.refresh`` on the
    exit's state from an all-True plane, and the loop's own plane must lie
    inside that one.  Then the chunked host loop on the same batch, built
    with ``frontier_device_loop=False`` and with a chunk of 384 (not a
    power of two): pod for pod the device loop's bindings and counter, a
    chunk launch and a refresh a chunk, 2 x chunks - 1 host syncs.  Then
    the device loop again with the ``PallasSuperSteps`` gate on: the
    counted run's bindings, counter, widths and compactions, its chunks
    launched on the K build.  Returns the run's fused-scan and refresh
    launches and the mismatches of each kernel, the refresh's cell at the
    pool's width, the host loop runs' launches and the K run."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.faults import FaultInjected, FaultPlan
    from kubernetes_tpu_torch.ops import backend as backend_mod
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, scan_ref

    t0 = time.perf_counter()
    m, pods, pctx, static, s, st, plain = PRE.pop("pool")
    n_nodes, n_pods = len(m), len(pods)
    # the full-width kernel against the plain scan (made while the kernels
    # built)
    r_full = compare(s, st, plain)
    full_ms = time_kernel(s, st)
    pool_cell = refresh_cell(f"10 pool {n_nodes}x{n_pods}", s, st)
    names = [static.node_names[j] if j >= 0 else None for j in r_full["chosen"]]

    exits: list = []

    class Recorded(backend_mod.FrontierRun):
        """Keeps each loop exit's state on the card for the checks after
        the counted run (one shard: the refresh's plane and mask are its
        first)."""

        def _sync_loop(self):
            out = super()._sync_loop()
            exits.append((self.static, self._plan, {k: v.clone() for k, v in self._bufs.items()},
                          self._still[0].clone(), self._alive[0].clone(), self._ctl.clone(),
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
        with frontier_runs() as runs:
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
    budget = sync_budget(runs)
    # the chunked host loop on the same batch, each run's launches counted
    host_loops = {}
    for label, kw in (("device_loop_off", dict(frontier_device_loop=False)),
                      ("chunk_384", dict(frontier_chunk=384))):
        hb = backend_mod.BatchBackend(device="cuda", **kw)
        torch.cuda.synchronize()
        fused_scan.launches = frontier_refresh.launches = 0
        h_got = hb.schedule_batch(pods, m, pctx)
        torch.cuda.synchronize()
        hl = hb.last_frontier[0]
        host_loops[label] = {
            "launches": fused_scan.launches, "refresh_launches": frontier_refresh.launches,
            "mismatches": (sum(a != b for a, b in zip(h_got, got))
                           + int(hb.algorithm._round_robin != backend.algorithm._round_robin)),
            "kernel_ms": round(hb.stats["kernel_ms"], 3),
            **{k: hl[k] for k in ("mode", "chunks", "host_syncs", "compactions", "widths")}}
    print(f"phase 10 the chunked host loop on the same batch: {json.dumps(host_loops)}; the "
          f"device loop's host_syncs {lf['host_syncs']} over {lf['chunks']} chunks", flush=True)
    # the device loop with the K build a chunk
    kb = backend_mod.BatchBackend(device="cuda")
    torch.cuda.synchronize()
    fused_scan.launches_k.clear()
    with superstep(SUPERSTEP_K):
        k_got = kb.schedule_batch(pods, m, pctx)
        torch.cuda.synchronize()
    klf = kb.last_frontier[0]
    k_run = {"launches": fused_scan.launches_k.get(SUPERSTEP_K, 0),
             "mismatches": (sum(a != b for a, b in zip(k_got, got))
                            + int(kb.algorithm._round_robin != backend.algorithm._round_robin)),
             "kernel_ms": round(kb.stats["kernel_ms"], 3), "k1_kernel_ms": round(st_b["kernel_ms"], 3),
             **{k: klf[k] for k in ("mode", "chunks", "host_syncs", "compactions", "widths")}}
    print(f"phase 10 the device loop at K = {SUPERSTEP_K}: {json.dumps(k_run)}", flush=True)
    if (k_run["mismatches"] or set(fused_scan.launches_k) != {SUPERSTEP_K}
            or k_run["launches"] != launches
            or any(k_run[k] != lf[k] for k in ("mode", "chunks", "compactions", "widths"))):
        raise AssertionError(f"phase 10 at K = {SUPERSTEP_K}: {k_run} against the K = 1 loop {lf}")
    for label, h in host_loops.items():
        chunk = 384 if label == "chunk_384" else 512
        if (h["mismatches"] or h["mode"] != "chunked" or h["chunks"] != -(-n_pods // chunk)
                or h["host_syncs"] != 2 * h["chunks"] - 1
                or h["launches"] != h["chunks"] or h["refresh_launches"] != h["chunks"]):
            raise AssertionError(f"phase 10 host loop {label}: {h}")
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
          f"host_syncs {lf['host_syncs']} (static budget {budget} over "
          f"{sum(r['loop_runs'] for r in runs)} loop runs); launches {launches} fused + "
          f"{refresh_launches} "
          f"refresh; refresh kernel == scan_ref.refresh at {len(exits)} loop exits (mismatches "
          f"{sum(refresh_errs)}); a gather fault raised the batch first", flush=True)
    print(f"phase 10 times: frontier route wall {wall:.3f} s, its kernel_ms {st_b['kernel_ms']:.3f} "
          f"(tensorize {st_b['tensorize_s']:.3f} s, dispatch {st_b['dispatch_s']:.3f} s, device "
          f"wait {st_b['device_wait_s']:.3f} s); the full-width kernel {full_ms:.3f} ms; plain scan "
          f"{r_full['plain_ms']:.1f} ms ({time.perf_counter() - t0:.1f} s)", flush=True)
    if (any(fused_errs) or any(refresh_errs) or lf["compactions"] < 1 or not exits
            or lf["host_syncs"] > lf["compactions"] + 2 or lf["host_syncs"] > budget
            or len(runs) != 1 or launches < 1 or refresh_launches < 1
            or st_b["oracle_pods"] != 0):
        raise AssertionError(f"phase 10: {fused_errs}, {refresh_errs}, {lf}, {st_b}")
    return launches, refresh_launches, fused_errs, refresh_errs, pool_cell, host_loops, k_run


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


def admitted_parity(workdir: str, n_nodes: int = 1000, n_pods: int = 1000) -> tuple[int, int]:
    """Phase 11a: 1000 nodes (a tenth tainted unreachable:NoExecute), the
    objects the chain reads, 1000 pods with no requests POSTed one at a
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


def crash_recovery(workdir: str, pps_6a: float, n_nodes: int = 5000, n_pods: int = 6000,
                   waves: int = 5) -> tuple[int, int]:
    """Phase 11b: 5 waves of 1200 pods through a durable apiserver at
    its defaults; once wave 3's creates are acknowledged, while the daemon
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


def fsync_cost(workdir: str, n_nodes: int = 1000, per_wave: int = 1000,
               reps: int = 1) -> tuple[int, int]:
    """Phase 11c: at 1000 nodes, one 1000-pod wave under each of: no flag,
    ``--data-dir``, ``--data-dir --fsync`` (each arm its own apiserver at
    its defaults and scheduler daemon, all started first), ``reps`` waves
    an arm interleaved (arm by arm within a round).  Returns the daemons'
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


def audit_summary(path: str) -> tuple[int, dict]:
    """The audit log's line count and, for the requests that completed
    under 400, the users by ``verb resource`` (the scheduler's lease, an
    Event in ``kube-system``, as ``lease``)."""
    lines, users = 0, {}
    with open(path) as f:
        for line in f:
            lines += 1
            r = json.loads(line)
            if r["stage"] != "ResponseComplete" or not 0 < r["code"] < 400:
                continue
            key = ("lease" if (r["resource"], r["namespace"]) == ("events", "kube-system")
                   else f"{r['verb']} {r['resource']}")
            users.setdefault(key, set()).add(r["user"])
    return lines, {k: sorted(v) for k, v in users.items()}


def refusals(d: "Daemons", admin_kubeconfig: str) -> dict:
    """Phase 12b, on 12a's server: what it must refuse and what it must
    serve.  Returns each check's outcome."""
    from kubernetes_tpu_torch.client.remote import RemoteStore, tls_refused
    from kubernetes_tpu_torch.daemon import remote_clientset
    from kubernetes_tpu_torch.testing import pki as fixture

    def code(path: str, token: str = None) -> int:
        req = urllib.request.Request(d.url + path)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=10, context=d.ctx) as r:
                r.read()
                return r.status
        except urllib.error.HTTPError as e:
            e.read()
            return e.code

    out = {"anonymous pods": code("/api/v1/pods"), "anonymous healthz": code("/healthz"),
           "anonymous kube-public configmaps": code("/api/v1/configmaps?namespace=kube-public"),
           "malformed bearer": code("/api/v1/pods", token="not-a.token!")}
    other = RemoteStore(d.url, ca_file=fixture.path("ca.crt"),
                        client_cert=fixture.path("other/client.crt"),
                        client_key=fixture.path("other/client.key"))
    try:
        other.list("Pod")
        out["second CA's certificate"] = "served"
    except OSError as e:
        out["second CA's certificate"] = "refused" if tls_refused(e) else repr(e)
    admin = remote_clientset(kubeconfig=admin_kubeconfig, timeout=60.0)
    for tid, expires in (("abcdef", time.time() + 3600), ("expird", time.time() - 3600)):
        admin.store.create("Secret", {
            "kind": "Secret", "type": "bootstrap.kubernetes.io/token",
            "metadata": {"name": f"bootstrap-token-{tid}", "namespace": "kube-system"},
            "data": {"token-id": tid, "token-secret": "0123456789abcdef",
                     "expiration": str(expires), "usage-bootstrap-authentication": "true"}})
    out["bootstrap token"] = code("/api/v1/services?namespace=kube-system",
                                  "abcdef.0123456789abcdef")
    out["expired bootstrap token"] = code("/api/v1/services?namespace=kube-system",
                                          "expird.0123456789abcdef")
    # clients that connect and say nothing hold their own threads
    silent = [socket.create_connection(("127.0.0.1", d.api_port), timeout=10) for _ in range(4)]
    try:
        t = time.perf_counter()
        served = code("/healthz") == 200 and admin.store.list("Service", "kube-system")[0] == []
        out["served beside 4 silent connections (s)"] = (
            round(time.perf_counter() - t, 4) if served else "not served")
    finally:
        for sock in silent:
            sock.close()
    return out


def tls_control_plane(workdir: str, pps_6a: float) -> tuple[int, int]:
    """Phases 12a-12b: the control plane as ``cluster init`` starts it.
    Returns the daemon's fused-scan and refresh launches."""
    from kubernetes_tpu_torch.pki import write_kubeconfig
    from kubernetes_tpu_torch.testing import pki as fixture
    from kubernetes_tpu_torch.workload import run_wire_churn

    n_nodes, n_pods, waves = 5000, 6000, 3
    audit = os.path.join(workdir, "12a-audit.jsonl")
    d = Daemons(workdir, "12a", admitted=True, tls=True,
                api_extra=("--client-ca-file", fixture.path("ca.crt"), "--audit-log", audit))
    try:
        kc = {name: write_kubeconfig(workdir, name, d.url, fixture.path("ca.crt"),
                                     *fixture.pair(name)) for name in ("admin", "kube-scheduler")}
        # the scheduler holds no token: its client certificate is its identity
        d.connect = ["--kubeconfig", kc["kube-scheduler"]]
        d.start_scheduler()
        r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=0,
                           kubeconfig=kc["admin"])
        st = d.stop_scheduler()
        refused = refusals(d, kc["admin"])
    except BaseException:
        print(f"phase 12a scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
        raise
    finally:
        d.close()
    lines, users = audit_summary(audit)
    c2b = r["create_to_bind_ms"]
    print(f"phase 12a TLS control plane (--tls-cert-file --tls-private-key-file "
          f"--client-ca-file --audit-log; admission on), the scheduler on --kubeconfig "
          f"(client certificate {fixture.CLIENTS['kube-scheduler'][0]}) --leader-elect, "
          f"{n_nodes}x{n_pods} mixed in {waves} waves through the admin kubeconfig: bound "
          f"{r['bound']} unbound {r['unbound']} wall_s {r['wall_s']:.3f} pods_per_s "
          f"{r['pods_per_sec']:.1f} create_to_bind_p50_ms {c2b['p50']:.1f} "
          f"create_to_bind_p99_ms {c2b['p99']:.1f}; ratio to 6a's {pps_6a:.1f} pods/s in this "
          f"call {r['pods_per_sec'] / pps_6a:.3f}; the daemon's launches: fused_scan "
          f"{st['launches']} frontier_refresh {st['refresh_launches']} (segments "
          f"{st['segments']}, kernel_ms {st['kernel_ms']:.3f}, batch_s {st['batch_s']:.3f}); "
          f"its watch readers parsed {st['ingest_bytes']} wire bytes in "
          f"{st['ingest_parse_s']:.3f} s (the TLS read and decryption not included), decode "
          f"{st['ingest_decode_s']:.3f} s, apply {st['ingest_apply_s']:.3f} s; device idle "
          f"share {1.0 - st['kernel_ms'] / 1e3 / r['wall_s']:.4f}; wave seconds "
          + " ".join(f"{x:.3f}" for x in r["wave_s"]), flush=True)
    print(f"phase 12a audit log: {lines} lines; users by verb and resource (completed under "
          f"400): {json.dumps(users, sort_keys=True)}", flush=True)
    print(f"phase 12b refusals on the same server: {json.dumps(refused)}", flush=True)
    bootstrap_users = users.get("list services", [])
    want = {"anonymous pods": 403, "anonymous healthz": 200,
            "anonymous kube-public configmaps": 200, "malformed bearer": 401,
            "second CA's certificate": "refused", "bootstrap token": 200,
            "expired bootstrap token": 401}
    bad = {k: v for k, v in want.items() if refused[k] != v}
    slow = refused["served beside 4 silent connections (s)"]
    if bad or not isinstance(slow, float) or slow > 2.0 or "system:bootstrap:abcdef" not in (
            bootstrap_users):
        raise AssertionError(f"phase 12b: {bad}, silent connections {slow}, "
                             f"list services by {bootstrap_users}")
    if r["bound"] != n_pods or st["launches"] <= 0 or st["refresh_launches"] <= 0:
        raise AssertionError(f"phase 12a: bound {r['bound']}, launches {st['launches']} + "
                             f"{st['refresh_launches']}")
    if (users.get("create pods") != ["kubernetes-admin"]
            or users.get("bind pods") != ["system:kube-scheduler"]
            or users.get("lease") != ["system:kube-scheduler"]):
        raise AssertionError(f"phase 12a: the audit's users {users}")
    return st["launches"], st["refresh_launches"]


def rbac_mode(workdir: str) -> tuple[int, int]:
    """Phase 12c: plain HTTP with ``--token-file`` and ``--authorization-mode
    RBAC`` over a ``--data-dir`` seeded beforehand with the grants (RBAC
    mode has none of its own).  Returns the daemon's launches."""
    from kubernetes_tpu_torch.api import (
        ClusterRole,
        ClusterRoleBinding,
        ObjectMeta,
        PolicyRule,
        Subject,
    )
    from kubernetes_tpu_torch.client.remote import ForbiddenError, RemoteStore
    from kubernetes_tpu_torch.pki import write_kubeconfig
    from kubernetes_tpu_torch.store.store import Store
    from kubernetes_tpu_torch.testing import pki as fixture
    from kubernetes_tpu_torch.workload import oracle_replay_waves, run_wire_churn

    n_nodes, n_pods, waves, seed = 1000, 500, 2, 7
    data = os.path.join(workdir, "12c-data")
    tokens = os.path.join(workdir, "12c-tokens.csv")
    with open(tokens, "w") as f:
        f.write("scheduler-token,system:kube-scheduler\nload-token,load\n"
                "nobody-token,nobody\n")
    read = ["get", "list", "watch"]
    # the RBAC kinds have no nonResourceURLs: /healthz is the resource ""
    grants = {
        "system:kube-scheduler": [
            PolicyRule(verbs=read, resources=["nodes", "services", "replicasets",
                                               "replicationcontrollers", "statefulsets",
                                               "persistentvolumes", "persistentvolumeclaims"]),
            PolicyRule(verbs=read + ["update", "delete", "bind"], resources=["pods"]),
            PolicyRule(verbs=["create"], resources=["bindings"]),
            # Events: the scheduler's own and its lease (an Event in kube-system)
            PolicyRule(verbs=read + ["create", "update"], resources=["events", "leases"])],
        "load": [PolicyRule(verbs=read + ["create"],
                            resources=["nodes", "services", "pods", "events", ""])]}
    seeded = Store(data_dir=data)
    for user, rules in grants.items():
        seeded.create("ClusterRole", ClusterRole(meta=ObjectMeta(name=user),
                                                 rules=rules).to_dict())
        seeded.create("ClusterRoleBinding", ClusterRoleBinding(
            meta=ObjectMeta(name=user), role_name=user,
            subjects=[Subject(kind="User", name=user)]).to_dict())
    seeded.close()
    d = Daemons(workdir, "12c", admitted=True, data_dir=data,
                api_extra=("--token-file", tokens, "--authorization-mode", "RBAC"),
                health_token="load-token")
    try:
        nobody = RemoteStore(d.url, token="nobody-token", max_retries=0)
        try:
            nobody.create("Node", {"kind": "Node", "metadata": {"name": "intruder"}})
            refused = "created"
        except ForbiddenError:
            refused = "403"
        load = write_kubeconfig(workdir, "12c-load", d.url, fixture.path("ca.crt"),
                                token="load-token")
        d.connect = ["--apiserver", d.url, "--token", "scheduler-token"]
        # the scheduler starts once the nodes and services exist, so its
        # informers hold them before the first wave: a pod drained before
        # its nodes reach the Node informer (another watch stream) fails,
        # backs off and binds later, out of the oracle's order, as the JAX
        # scheduler's does (ROADMAP Queue 3 item 8, a kept divergence)
        r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=seed, kubeconfig=load,
                           before_wave=lambda w: w == 0 and d.start_scheduler())
        st = d.stop_scheduler()
    except BaseException:
        print(f"phase 12c scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
        raise
    finally:
        d.close()
    o = oracle_replay_waves(r["wave_keys"], r["assignments"], n_nodes, n_pods, "mixed", seed)
    print(f"phase 12c RBAC mode over HTTP (--token-file --authorization-mode RBAC, grants "
          f"seeded in --data-dir), {n_nodes}x{n_pods} mixed in {waves} waves: bound "
          f"{r['bound']} pods_per_s {r['pods_per_sec']:.1f} create_to_bind_p99_ms "
          f"{r['create_to_bind_ms']['p99']:.1f}; vs the sequential oracle wave by wave: "
          f"{o['mode']}, checked {o['checked']}, mismatches {o['mismatches']}, rr "
          f"{st['round_robin']} vs {o['round_robin']}; a token with no binding: {refused} on "
          f"create; launches fused_scan {st['launches']} frontier_refresh "
          f"{st['refresh_launches']}", flush=True)
    if (r["bound"] != n_pods or o["checked"] != n_pods or o["mismatches"] != 0
            or o["round_robin"] != st["round_robin"] or refused != "403"
            or st["launches"] <= 0):
        raise AssertionError(f"phase 12c: {o}, rr {st['round_robin']}, refused {refused}")
    return st["launches"], st["refresh_launches"]


def auth_phase(pps_6a: float) -> tuple[int, int]:
    """Phase 12: auth, PKI, TLS and kubeconfig.  Returns the daemons'
    fused-scan and refresh launches over 12a and 12c."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        la, ra = tls_control_plane(workdir, pps_6a)
        t1 = time.perf_counter()
        lc, rc = rbac_mode(workdir)
    t2 = time.perf_counter()
    print(f"phase 12 took {t2 - t0:.1f} s: 12a-12b {t1 - t0:.1f}, 12c {t2 - t1:.1f}; launches "
          f"{la} + {lc} fused, {ra} + {rc} refresh", flush=True)
    return la + lc, ra + rc


# -- phase 13: a node drain under the card's scheduler -------------------------

# the kinds of the JAX package's registry (its api package, and the
# federation group's Cluster, which each apiserver registers): the port's
# registry must hold the same
JAX_KINDS = frozenset({
    "APIService", "CertificateSigningRequest", "Cluster", "ClusterRole", "ClusterRoleBinding",
    "ConfigMap", "CronJob", "CustomResourceDefinition", "DaemonSet", "Deployment", "Endpoints",
    "Event", "HorizontalPodAutoscaler", "Job", "LimitRange", "Namespace", "NetworkPolicy",
    "Node", "PersistentVolume", "PersistentVolumeClaim", "Pod", "PodDisruptionBudget",
    "PodPreset", "PodSecurityPolicy", "PriorityClass", "ReplicaSet", "ReplicationController",
    "ResourceQuota", "Role", "RoleBinding", "Secret", "Service", "ServiceAccount",
    "StatefulSet", "StorageClass"})
# each app's disruption budget as a divisor of its pods on the drained
# nodes (0: no disruption allowed); the sum is the number of evictions
# that must succeed, the rest must answer 429
DRAIN_DIVISORS = {"web": 4, "api": 4, "db": 2, "batch": 4, "lonely": 0}
UPLOAD_FRACTION = "scheduler_tensorize_upload_fraction"


def quantiles_ms(seconds: list) -> tuple[float, float]:
    xs = sorted(seconds)
    return tuple(xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 for q in (0.5, 0.99))


def evict_all(url: str, names: list, threads: int = 8) -> tuple[dict, float]:
    """``POST .../pods/{name}/eviction`` for every name, from ``threads``
    threads; returns each name's status code and the seconds taken."""
    codes: dict = {}
    mu = threading.Lock()

    def worker(mine: list) -> None:
        for name in mine:
            req = urllib.request.Request(
                f"{url}/api/v1/namespaces/default/pods/{name}/eviction", data=b"{}",
                method="POST", headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    r.read()
                    code = r.status
            except urllib.error.HTTPError as e:
                e.read()
                code = e.code
            with mu:
                codes[name] = code

    t = time.perf_counter()
    pool = [threading.Thread(target=worker, args=(names[i::threads],)) for i in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    return codes, time.perf_counter() - t


def replacement_of(pod: dict) -> dict:
    """The pod the ReplicaSet controller would create for an evicted one: a
    new name, the same labels and spec, no node."""
    meta = pod["metadata"]
    return {"kind": "Pod",
            "metadata": {"name": meta["name"] + "-r", "namespace": meta["namespace"],
                         "labels": dict(meta.get("labels") or {})},
            "spec": {k: v for k, v in pod["spec"].items() if k != "nodeName"},
            "status": dict(pod.get("status") or {})}


def node_drain(d: "Daemons", oracle_pool) -> dict:
    """Phase 13a on ``d``'s apiserver at its defaults.  Returns the run's
    figures, the daemon's stats and the oracle's future."""
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.workload import (
        oracle_replay_state,
        overcommitted_nodes,
        run_wire_churn,
    )

    n_nodes, n_pods, waves, seed = 5000, 20000, 10, 7
    cordoned = [f"node-{i:05d}" for i in range(n_nodes // 10)]
    # the scheduler starts once the cluster exists (ROADMAP Queue 3 item 8:
    # started before it, it binds the first wave out of the oracle's order,
    # as the JAX scheduler does)
    t_start = time.perf_counter()
    r = run_wire_churn(d.url, n_nodes, n_pods, waves, "mixed", seed=seed,
                       before_wave=lambda w: w == 0 and d.start_scheduler())
    if r["bound"] != n_pods:
        raise AssertionError(f"phase 13a: {r['bound']} of {n_pods} bound before the drain")
    out = {"waves_pps": r["pods_per_sec"], "shape": f"{n_nodes}x{n_pods} mixed in {waves} waves"}
    rs = RemoteStore(d.url, timeout=120.0)
    pods, _ = rs.list("Pod")
    drained_set = set(cordoned)
    drained = sorted((p for p in pods if p["spec"].get("nodeName") in drained_set),
                     key=lambda p: p["metadata"]["name"])
    by_app: dict = {}
    for p in drained:
        app = p["metadata"]["labels"]["app"]
        by_app[app] = by_app.get(app, 0) + 1
    budgets = {app: by_app.get(app, 0) // div if div else 0
               for app, div in DRAIN_DIVISORS.items()}
    # the script stands in for the disruption controller: it writes status
    for app, budget in budgets.items():
        rs.create("PodDisruptionBudget", {
            "kind": "PodDisruptionBudget",
            "metadata": {"name": f"{app}-pdb", "namespace": "default"},
            "spec": {"minAvailable": by_app.get(app, 0) - budget,
                     "selector": {"matchLabels": {"app": app}}},
            "status": {"disruptionsAllowed": budget}})
    read = {p["metadata"]["name"]: p["status"]["disruptionsAllowed"]
            for p in rs.list("PodDisruptionBudget", "default")[0]}
    if read != {f"{a}-pdb": b for a, b in budgets.items()}:
        raise AssertionError(f"phase 13a: the budgets read back {read}, written {budgets}")

    # cordon a tenth of the fleet, one strategic-merge PATCH a node
    before = {n["metadata"]["name"]: n for n in rs.list("Node")[0]}
    t = time.perf_counter()
    for name in cordoned:
        rs.patch("Node", "", name, {"spec": {"unschedulable": True}}, patch_type="strategic")
    out["patch_s"] = time.perf_counter() - t
    after = {n["metadata"]["name"]: n for n in rs.list("Node")[0]}

    def rest(n: dict) -> dict:
        meta = {k: v for k, v in n["metadata"].items() if k != "resourceVersion"}
        spec = {k: v for k, v in n["spec"].items() if k != "unschedulable"}
        return {**n, "metadata": meta, "spec": spec}

    bad = [name for name, n in after.items()
           if bool(n["spec"].get("unschedulable")) != (name in drained_set)
           or rest(n) != rest(before[name])]
    if bad or len(after) != n_nodes:
        raise AssertionError(f"phase 13a: {len(bad)} nodes read back wrong after the cordon, "
                             f"e.g. {bad[:3]}")

    # evict every pod bound to the cordoned nodes
    codes, out["evict_s"] = evict_all(d.url, [p["metadata"]["name"] for p in drained])
    n201 = sum(1 for c in codes.values() if c == 201)
    n429 = sum(1 for c in codes.values() if c == 429)
    want201 = sum(budgets.values())
    left = {p["metadata"]["name"]: p["status"]["disruptionsAllowed"]
            for p in rs.list("PodDisruptionBudget", "default")[0]}
    out.update(cordoned=len(cordoned), drained=len(drained), evicted=n201, refused=n429,
               budgets=budgets, by_app=by_app)
    if n201 != want201 or n429 != len(drained) - want201 or any(v != 0 for v in left.values()):
        raise AssertionError(f"phase 13a: {n201} evictions (want {want201}), {n429} refused "
                             f"(want {len(drained) - want201}), budgets left {left}, other "
                             f"codes {sorted(set(codes.values()) - {201, 429})}")

    # the cluster as read back before the replacement wave, for the oracle
    evicted = [p for p in drained if codes[p["metadata"]["name"]] == 201]
    replacements = [replacement_of(p) for p in evicted]
    state = {"Node": rs.list("Node")[0], "Service": rs.list("Service")[0]}
    state["Pod"], rev = rs.list("Pod")
    if len(state["Pod"]) != n_pods - n201:
        raise AssertionError("phase 13a: the evicted pods are not gone")
    # every pod bound once: the tie-break counter stands at the pods bound
    oracle = oracle_pool.submit(oracle_replay_state, state, replacements, n_pods)

    # the replacement wave: one :batch POST in the binary wire form
    text = d.metrics_text()
    frac0 = (metric_value(text, UPLOAD_FRACTION + "_sum"),
             metric_value(text, UPLOAD_FRACTION + "_count"))
    keys = {f"default/{p['metadata']['name']}" for p in replacements}
    watch = rs.watch("Pod", from_revision=rev)
    bound_at: dict = {}
    try:
        t_create = time.perf_counter()
        created = RemoteStore(d.url, timeout=120.0, binary=True).create_many("Pod", replacements)
        if len(created) != len(replacements) or any(c is None for c in created):
            raise AssertionError("phase 13a: a replacement's create failed")
        deadline = time.monotonic() + 60
        while len(bound_at) < len(keys):
            if time.monotonic() > deadline:
                raise TimeoutError(f"phase 13a: {len(keys) - len(bound_at)} replacements "
                                   "unbound after 60 s")
            ev = watch.get(timeout=1.0)
            if ev is None or ev.key not in keys or ev.key in bound_at:
                continue
            node = ((ev.object or {}).get("spec") or {}).get("nodeName")
            if node:
                bound_at[ev.key] = (time.perf_counter() - t_create, node)
    finally:
        watch.stop()
    # the daemon observes a wave's upload share after its binds land, so
    # the watch can see the last bind first: wait (at most 30 s) for it
    deadline = time.monotonic() + 30
    while True:
        text = d.metrics_text()
        waves_up = metric_value(text, UPLOAD_FRACTION + "_count") - frac0[1]
        if waves_up or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    out["upload_fraction"] = ((metric_value(text, UPLOAD_FRACTION + "_sum") - frac0[0])
                              / waves_up if waves_up else None)
    out["wall_s"] = time.perf_counter() - t_start
    lat = [s for s, _ in bound_at.values()]
    out["wave_pps"] = len(lat) / max(lat)
    out["c2b_ms"] = quantiles_ms(lat)
    out["replacements"] = len(replacements)
    got = {k: node for k, (_, node) in bound_at.items()}
    on_cordoned = sorted(k for k, n in got.items() if n in drained_set)
    pods_now, _ = rs.list("Pod")
    over = overcommitted_nodes(pods_now, state["Node"])
    if on_cordoned or over:
        raise AssertionError(f"phase 13a: replacements on cordoned nodes {on_cordoned[:3]}, "
                             f"nodes over capacity {over[:3]}")

    # uncordon by JSON patch
    t = time.perf_counter()
    for name in cordoned:
        rs.patch("Node", "", name, [{"op": "replace", "path": "/spec/unschedulable",
                                     "value": False}], patch_type="json")
    out["unpatch_s"] = time.perf_counter() - t
    still = [n["metadata"]["name"] for n in rs.list("Node")[0] if n["spec"].get("unschedulable")]
    if still:
        raise AssertionError(f"phase 13a: {len(still)} nodes still cordoned, e.g. {still[:3]}")
    out["stats"] = d.stop_scheduler()
    out["got"], out["oracle"] = got, oracle
    return out


class _SampleAPI(BaseHTTPRequestHandler):
    """A sample aggregated API server on loopback: one resource of its
    group, echoing who the aggregator said the caller is."""

    GROUP = "metrics.example.com"

    def log_message(self, *a):
        pass

    def do_GET(self):
        found = self.path.startswith(f"/apis/{self.GROUP}/v1/nodemetrics")
        data = json.dumps({"items": [{"node": "node-00000"}],
                           "user": self.headers.get("X-Remote-User", ""),
                           "auth": self.headers.get("Authorization", "")} if found
                          else {"kind": "Status", "code": 404}).encode()
        self.send_response(200 if found else 404)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def api_surface(url: str) -> dict:
    """Phase 13b on the drained cluster's apiserver: OpenAPI, an era
    Deployment through the scheme, a binary LIST beside a JSON one, and
    aggregation to a sample backend."""
    from kubernetes_tpu_torch.api import wire
    from kubernetes_tpu_torch.api.types import CLUSTER_SCOPED_KINDS, KIND_PLURALS, KINDS
    from kubernetes_tpu_torch.client.remote import RemoteStore

    out = {}
    doc = json.loads(http_get(url + "/openapi/v2"))
    missing = []
    for kind, plural in KIND_PLURALS.items():
        base = (f"/api/v1/{plural}" if kind in CLUSTER_SCOPED_KINDS
                else f"/api/v1/namespaces/{{namespace}}/{plural}")
        if base not in doc["paths"] or base + "/{name}" not in doc["paths"]:
            missing.append(kind)
    out["openapi_kinds"] = len(KINDS)
    if missing or set(KINDS) != JAX_KINDS or len(doc["definitions"]) != len(KINDS):
        raise AssertionError(f"phase 13b: OpenAPI misses {missing}; registry minus the JAX "
                             f"package's {sorted(set(KINDS) ^ JAX_KINDS)}")

    # an era apps/v1beta1 Deployment: nested rollingUpdate, a 25% surge
    era = {"apiVersion": "apps/v1beta1", "kind": "Deployment",
           "metadata": {"name": "web-era", "namespace": "default"},
           "spec": {"replicas": 10, "strategy": {"type": "RollingUpdate", "rollingUpdate": {
               "maxSurge": "25%", "maxUnavailable": "25%"}},
               "template": {"metadata": {"labels": {"app": "web-era"}},
                            "spec": {"containers": [{"name": "c", "image": "nginx:1.7.9"}]}}}}
    rs = RemoteStore(url, timeout=120.0)
    rs.create("Deployment", era)
    dep = rs.get("Deployment", "default", "web-era")
    spec = dep["spec"]
    out["deployment"] = {k: spec[k] for k in ("strategy", "maxSurge", "maxUnavailable")}
    if (out["deployment"] != {"strategy": "RollingUpdate", "maxSurge": 3, "maxUnavailable": 2}
            or spec["selector"] != {"matchLabels": {"app": "web-era"}} or "apiVersion" in dep):
        raise AssertionError(f"phase 13b: the era Deployment read back {spec}")

    # the pod LIST in both wire forms
    t = time.perf_counter()
    as_json = http_get(url + "/api/v1/pods")
    out["json_s"] = time.perf_counter() - t
    req = urllib.request.Request(url + "/api/v1/pods", headers={"Accept": wire.CONTENT_TYPE})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype, as_binary = r.headers["Content-Type"], r.read()
    out["binary_s"] = time.perf_counter() - t
    items_json = json.loads(as_json)["items"]
    items_bin = wire.decode(as_binary)["items"]
    out.update(json_bytes=len(as_json), binary_bytes=len(as_binary), listed=len(items_bin))
    if ctype != wire.CONTENT_TYPE or items_bin != items_json:
        raise AssertionError(f"phase 13b: the binary LIST ({ctype}) != the JSON LIST")

    # aggregation to a backend on loopback
    backend = ThreadingHTTPServer(("127.0.0.1", 0), _SampleAPI)
    threading.Thread(target=backend.serve_forever, daemon=True).start()
    try:
        rs.create("APIService", {"kind": "APIService",
                                 "metadata": {"name": f"v1.{_SampleAPI.GROUP}"},
                                 "spec": {"group": _SampleAPI.GROUP,
                                          "url": f"http://127.0.0.1:{backend.server_port}"}})
        got = json.loads(http_get(f"{url}/apis/{_SampleAPI.GROUP}/v1/nodemetrics",
                                  token="not-forwarded"))
        try:
            http_get(f"{url}/apis/nope.example.com/v1/x")
            unregistered = 200
        except urllib.error.HTTPError as e:
            unregistered = e.code
        groups = json.loads(http_get(url + "/apis"))["groups"]
    finally:
        backend.shutdown()
        backend.server_close()
    out["aggregated"] = {"items": got["items"], "auth": got["auth"], "unregistered": unregistered,
                         "groups": groups}
    if (got["items"] != [{"node": "node-00000"}] or got["auth"] != "" or unregistered != 404
            or groups != [{"name": _SampleAPI.GROUP, "available": True}]):
        raise AssertionError(f"phase 13b: aggregation {out['aggregated']}")
    return out


def drain_phase(pps_6a: float, oracle_pool, meanwhile) -> tuple:
    """Phase 13: a node drain under the card's scheduler (13a) and the API
    surface on the same server (13b).  The sequential oracle of 13a's
    replacement wave runs in a process of ``oracle_pool``'s; ``meanwhile()``
    (the next phase) runs while it works, then 13a's parity is printed and
    checked here.  Returns the daemon's fused-scan and refresh launches and
    what ``meanwhile()`` returned."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        d = Daemons(workdir, "13a", admitted=True)
        try:
            r = node_drain(d, oracle_pool)
            t1 = time.perf_counter()
            s = api_surface(d.url)
        except BaseException:
            print(f"phase 13 scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
    t2 = time.perf_counter()
    st = r["stats"]
    print(f"phase 13a node drain, {r['shape']} (bound at "
          f"{r['waves_pps']:.1f} pods/s; 6a {pps_6a:.1f} in this call) on the apiserver at its "
          f"defaults: cordon {r['cordoned']} nodes by strategic-merge PATCH in "
          f"{r['patch_s']:.3f} s ({r['cordoned'] / r['patch_s']:.1f} PATCHes/s), every node "
          f"read back "
          f"with only spec.unschedulable changed; {r['drained']} pods on them by app "
          f"{json.dumps(r['by_app'], sort_keys=True)}, budgets "
          f"{json.dumps(r['budgets'], sort_keys=True)}; evictions from 8 threads: "
          f"{r['evicted']} x 201 (= the budgets' sum) and {r['refused']} x 429 in "
          f"{r['evict_s']:.3f} s ({r['evicted'] / r['evict_s']:.1f} evictions/s), every budget "
          f"at 0; {r['replacements']} replacements in one binary :batch POST, bound at "
          f"{r['wave_pps']:.1f} pods/s, create_to_bind_p50_ms {r['c2b_ms'][0]:.1f} "
          f"create_to_bind_p99_ms {r['c2b_ms'][1]:.1f}, none on a cordoned node, no node over "
          f"capacity; uncordon by JSON patch in {r['unpatch_s']:.3f} s; the "
          f"replacement wave's uploaded-column share {r['upload_fraction']}, node cache "
          f"{st['node_cache']}; the daemon's launches fused_scan {st['launches']} "
          f"frontier_refresh {st['refresh_launches']}, kernel_ms {st['kernel_ms']:.3f}, "
          f"device idle share over 13a's {r['wall_s']:.3f} s from the cluster's creation to "
          f"the last replacement bound {1.0 - st['kernel_ms'] / 1e3 / r['wall_s']:.4f}",
          flush=True)
    print(f"phase 13b the API surface on the same server: /openapi/v2 paths for all "
          f"{s['openapi_kinds']} kinds (the JAX package's set); an apps/v1beta1 Deployment "
          f"read back as {json.dumps(s['deployment'], sort_keys=True)}; LIST of "
          f"{s['listed']} pods: JSON {s['json_bytes']} bytes in {s['json_s']:.3f} s, binary "
          f"{s['binary_bytes']} bytes ({s['binary_bytes'] / s['json_bytes']:.4f} of JSON) in "
          f"{s['binary_s']:.3f} s, equal items; aggregation: "
          f"{json.dumps(s['aggregated'], sort_keys=True)}", flush=True)
    print(f"phase 13 took {t2 - t0:.1f} s: 13a {t1 - t0:.1f}, 13b {t2 - t1:.1f} (13a's "
          f"oracle runs on beside the next phase)", flush=True)
    fraction = r["upload_fraction"]
    if (st["launches"] <= 0 or st["refresh_launches"] <= 0 or r["replacements"] <= 512
            or st["node_cache"]["col_updates"] < 1 or fraction is None or fraction >= 0.125):
        raise AssertionError(f"phase 13a: launches {st['launches']} + "
                             f"{st['refresh_launches']}, replacements {r['replacements']}, "
                             f"upload fraction {fraction}, node cache {st['node_cache']}")
    after = meanwhile()
    t = time.perf_counter()
    oracle = r["oracle"].result()
    mismatches = sum(1 for k, n in r["got"].items() if oracle["assignments"].get(k) != n)
    print(f"phase 13a the replacement wave vs the sequential oracle over the cluster as "
          f"read back: mismatches {mismatches} of {len(r['got'])}, rr "
          f"{st['round_robin']} vs {oracle['round_robin']} (waited "
          f"{time.perf_counter() - t:.1f} s for it after the next phase)", flush=True)
    if (mismatches or set(oracle["assignments"]) != set(r["got"])
            or oracle["round_robin"] != st["round_robin"]):
        raise AssertionError(f"phase 13a: the daemon's replacement bindings != the "
                             f"sequential oracle: {mismatches} differ, rr "
                             f"{st['round_robin']} vs {oracle['round_robin']}")
    return st["launches"], st["refresh_launches"], after


# -- phase 14: a kubemark density run under the card's scheduler -------------

# the reference density test's SLO (test/e2e/density.go): pod startup
# latency, create to Running as the test's watch sees it, p99 <= 5 s
STARTUP_SLO_S = 5.0


def request_counts(text: str) -> dict:
    """``apiserver_requests_total`` from an apiserver's /metrics, keyed
    ``"<verb> <resource>"``."""
    out = {}
    for line in text.splitlines():
        if line.startswith("apiserver_requests_total{"):
            labels, value = line.rsplit(" ", 1)
            verb = labels.split('verb="', 1)[1].split('"', 1)[0]
            resource = labels.split('resource="', 1)[1].split('"', 1)[0]
            out[f"{verb} {resource}"] = int(float(value))
    return out


class PodTimes:
    """A watch on Pods from ``rev`` on a thread of its own: when each pod was
    first seen (its create, for pods a controller makes), bound (and to
    which node) and reached Running as this client saw it, and the pods the
    kubelets rejected (Failed, reason OutOf<resource>)."""

    def __init__(self, rs, rev: int):
        self.mu = threading.Lock()
        self.added: dict = {}
        self.bound: dict = {}
        self.running: dict = {}
        self.rejected: dict = {}
        self.nodes: dict = {}  # the node each pod was bound to
        self.watch = rs.watch("Pod", from_revision=rev)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="pod-times")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            ev = self.watch.get(timeout=0.5)
            if ev is None or ev.object is None:
                continue
            now = time.perf_counter()
            spec, status = ev.object.get("spec") or {}, ev.object.get("status") or {}
            with self.mu:
                self.added.setdefault(ev.key, now)
                if spec.get("nodeName") and ev.key not in self.bound:
                    self.bound[ev.key] = now
                    self.nodes[ev.key] = spec["nodeName"]
                if status.get("phase") == "Running" and ev.key not in self.running:
                    self.running[ev.key] = now
                if (status.get("phase") == "Failed"
                        and (status.get("reason") or "").startswith("OutOf")):
                    self.rejected[ev.key] = status["reason"]

    def wait(self, keys: list, which: str, deadline_s: float, what: str) -> None:
        """Poll (every 20 ms) until every key is ``which`` (bound, running)."""
        seen = getattr(self, which)
        deadline = time.monotonic() + deadline_s
        while True:
            with self.mu:
                missing = sum(1 for k in keys if k not in seen)
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: {missing} pods not {which} after "
                                   f"{deadline_s} s (rejected {len(self.rejected)})")
            time.sleep(0.02)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.watch.stop()


def run_waves(url: str, pods: list, waves: int, times: PodTimes, what: str) -> tuple:
    """Create ``pods`` in ``waves`` ``:batch`` POSTs, each once the last is
    bound; returns each pod's create time and the waves' seconds."""
    from kubernetes_tpu_torch.client.remote import RemoteStore

    rs = RemoteStore(url, timeout=120.0)
    per = len(pods) // waves
    created, wave_s = {}, []
    for w in range(waves):
        batch = pods[w * per:(w + 1) * per]
        keys = [f"default/{d['metadata']['name']}" for d in batch]
        t = time.perf_counter()
        for k in keys:
            created[k] = t
        out = rs.create_many("Pod", batch)
        if len(out) != len(batch) or any(x is None for x in out):
            raise AssertionError(f"{what} wave {w}: a create failed")
        times.wait(keys, "bound", 60, f"{what} wave {w}")
        wave_s.append(time.perf_counter() - t)
    return created, wave_s


def cpu_s(pid: int) -> float:
    """The CPU seconds (user and system) process ``pid`` has used so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def ip_check(pods: list) -> tuple[int, int]:
    """Pod IPs: the duplicates within a node (must be 0) and the addresses
    held on more than one node (the hash fallback's /24 bases can meet:
    there is no IPAM controller to allocate podCIDRs yet)."""
    by_node: dict = {}
    for p in pods:
        by_node.setdefault(p["spec"]["nodeName"], []).append(p["status"].get("podIP"))
    within = sum(len(ips) - len(set(ips)) for ips in by_node.values())
    owners: dict = {}
    for node, ips in by_node.items():
        for ip in set(ips):
            owners.setdefault(ip, set()).add(node)
    return within, sum(1 for nodes in owners.values() if len(nodes) > 1)


def density(d: "Daemons", k_procs: int) -> dict:
    """Phase 14a on ``d``'s apiserver at its defaults, the kubelets spread
    over ``k_procs`` fleet processes."""
    import multiprocessing

    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.workload import (
        make_nodes,
        make_pods,
        make_services,
        overcommitted_nodes,
        run_hollow_fleet,
    )

    # a wave of 1000 pods outlasts one 512-pod chunk, so the refresh runs
    n_nodes, n_pods, waves, seed = 5000, 3000, 3, 7
    rng = random.Random(seed)
    nodes = make_nodes(n_nodes, rng, "mixed")
    services = [s.to_dict() for s in make_services()]
    pods = [p.to_dict() for p in make_pods(n_pods, rng, "mixed")]
    mp = multiprocessing.get_context("spawn")
    stop, results = mp.Event(), mp.Queue()
    share = -(-n_nodes // k_procs)
    procs = [mp.Process(target=run_hollow_fleet, name=f"fleet-{i}",
                        args=(d.url, n_nodes, "mixed", seed, i * share,
                              min(share, n_nodes - i * share), stop, results))
             for i in range(k_procs)]
    out = {"shape": f"{n_nodes} hollow nodes x {n_pods} mixed pods in {waves} waves",
           "fleet": {}}
    times = None
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        register_s = {}
        while len(register_s) < k_procs:
            try:
                tag, first, value = results.get(timeout=1.0)
            except queue.Empty:  # check the processes are alive
                if any(not proc.is_alive() for proc in procs):
                    raise RuntimeError("phase 14a: a fleet process died while registering")
                if time.perf_counter() - t0 > 300:
                    raise TimeoutError("phase 14a: the fleet did not register in 300 s")
                continue
            register_s[first] = value
        out["register_s"] = time.perf_counter() - t0
        rs = RemoteStore(d.url, timeout=120.0)
        # kubectl taint: the kubelets register no taints
        t = time.perf_counter()
        tainted = [n for n in nodes if n.spec.taints]
        for n in tainted:
            rs.patch("Node", "", n.meta.name,
                     {"spec": {"taints": [x.to_dict() for x in n.spec.taints]}})
        out["taint_s"], out["tainted"] = time.perf_counter() - t, len(tainted)
        rs.create_many("Service", services)
        read = {n["metadata"]["name"]: n for n in rs.list("Node")[0]}
        want_taints = {n.meta.name for n in tainted}
        got_taints = {name for name, n in read.items() if (n.get("spec") or {}).get("taints")}
        if len(read) != n_nodes or got_taints != want_taints:
            raise AssertionError(f"phase 14a: {len(read)} nodes registered, "
                                 f"{len(got_taints ^ want_taints)} taints wrong")
        # the scheduler starts once the cluster exists (kept divergence k)
        t = time.perf_counter()
        d.start_scheduler()
        out["scheduler_start_s"] = time.perf_counter() - t
        metrics0 = request_counts(http_get(d.url + "/metrics").decode())
        _, rev = rs.list("Pod")
        times = PodTimes(rs, rev)
        pids = {"apiserver": d.apiserver.pid, "scheduler": d.scheduler.pid,
                "fleet": [proc.pid for proc in procs]}
        cpu0 = {k: sum(cpu_s(p) for p in (v if isinstance(v, list) else [v]))
                for k, v in pids.items()}
        t_first = time.perf_counter()
        created, out["wave_s"] = run_waves(d.url, pods, waves, times, "phase 14a")
        keys = list(created)
        times.wait(keys, "running", 180, "phase 14a")
        t_end = time.perf_counter()
        out["wall_s"] = t_end - t_first
        # each process's share of a core over the window: the apiserver is
        # one Python process, so 1.0 is all it can use
        out["cpu_share"] = {
            k: (sum(cpu_s(p) for p in (v if isinstance(v, list) else [v])) - cpu0[k])
            / out["wall_s"] for k, v in pids.items()}
        metrics1 = request_counts(http_get(d.url + "/metrics").decode())
        out["requests"] = {k: v - metrics0.get(k, 0) for k, v in metrics1.items()
                           if v - metrics0.get(k, 0)}
        with times.mu:
            bind = [times.bound[k] - created[k] for k in keys]
            start = [times.running[k] - created[k] for k in keys]
            out["running_pps"] = n_pods / (max(times.running[k] for k in keys) - t_first)
            out["rejected"] = dict(times.rejected)
        out["waves_pps"] = n_pods / sum(out["wave_s"])
        out["c2b_ms"], out["startup_ms"] = quantiles_ms(bind), quantiles_ms(start)
    finally:
        t_stop = time.perf_counter()
        stop.set()
        reports = {}
        deadline = time.monotonic() + 120
        while len(reports) < len(procs) and time.monotonic() < deadline:
            if not any(proc.is_alive() for proc in procs) and results.empty():
                break
            try:
                tag, first, value = results.get(timeout=1.0)
            except queue.Empty:
                continue
            if tag == "done":
                reports[first] = value
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        if times is not None:
            times.stop()
    out["stop_s"] = time.perf_counter() - t_stop
    if len(reports) != k_procs or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"phase 14a: {len(reports)} of {k_procs} fleet reports, exit "
                             f"codes {[proc.exitcode for proc in procs]}")
    for first in sorted(reports):
        r = reports[first]
        ticks = sorted(r["ticks"])
        out["fleet"][first] = {
            "kubelets": min(share, n_nodes - first), "register_s": register_s[first],
            "ticks": len(ticks), "tick_mean_s": sum(ticks) / len(ticks),
            "tick_p50_s": ticks[len(ticks) // 2], "tick_max_s": ticks[-1],
            "totals": r["totals"]}
    t = time.perf_counter()
    items = rs.list("Pod")[0]
    out["not_running"] = [p["metadata"]["name"] for p in items
                          if (p.get("status") or {}).get("phase") != "Running"]
    out["over"] = overcommitted_nodes(items, rs.list("Node")[0])
    out["ips_within"], out["ips_across"] = ip_check(items)
    out["stats"] = d.stop_scheduler()
    out["check_s"] = time.perf_counter() - t
    return out


def kubelet_entry(d: "Daemons", oracle_pool) -> dict:
    """Phase 14b: ``python -m kubernetes_tpu_torch kubelet --count 1000``
    as one process under the card's scheduler."""
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.workload import make_pods, oracle_replay_state

    n_nodes, n_pods, waves, seed = 1000, 1000, 4, 7
    fleet = d._spawn("kubelet", ["kubernetes_tpu_torch", "kubelet", "--apiserver", d.url,
                                 "--count", str(n_nodes), "--name", "hollow"])
    rs = RemoteStore(d.url, timeout=120.0)
    times = None
    try:
        t = time.perf_counter()
        wait_until(lambda: len(rs.list("Node")[0]) == n_nodes, fleet, "the fleet", 180)
        out = {"register_s": time.perf_counter() - t}
        nodes = rs.list("Node")[0]
        pods = [p.to_dict() for p in make_pods(n_pods, random.Random(seed), "plain")]
        # the sequential oracle over the cluster as read back, beside the run
        oracle = oracle_pool.submit(oracle_replay_state, {"Node": nodes}, pods, 0)
        d.start_scheduler()
        _, rev = rs.list("Pod")
        times = PodTimes(rs, rev)
        t = time.perf_counter()
        created, out["wave_s"] = run_waves(d.url, pods, waves, times, "phase 14b")
        times.wait(list(created), "running", 120, "phase 14b")
        out["wall_s"] = time.perf_counter() - t
        with times.mu:
            out["startup_ms"] = quantiles_ms([times.running[k] - created[k] for k in created])
            out["rejected"] = dict(times.rejected)
        items = rs.list("Pod")[0]
        out["got"] = {f"default/{p['metadata']['name']}": p["spec"].get("nodeName")
                      for p in items}
        out["stats"] = d.stop_scheduler()
    finally:
        if times is not None:
            times.stop()
        fleet.send_signal(signal.SIGTERM)
        try:
            out_rc = fleet.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fleet.kill()
            fleet.wait(timeout=30)
            raise
    out["fleet_rc"] = out_rc
    out["oracle"] = oracle.result()
    return out


def kubelet_phase(pps_6a: float, oracle_pool) -> tuple[int, int]:
    """Phase 14: a kubemark density run under the card's scheduler (14a)
    and the kubelet's own entry point (14b), whose sequential oracle runs
    in a process of ``oracle_pool``'s.  Returns the daemons' fused and
    refresh launches."""
    # half the host's cores: the apiserver, the scheduler daemon and this
    # script take the rest
    k_procs = max(2, (os.cpu_count() or 4) // 2)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        d = Daemons(workdir, "14a", admitted=True)
        try:
            a = density(d, k_procs)
        except BaseException:
            print(f"phase 14a scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
        t1 = time.perf_counter()
        d = Daemons(workdir, "14b", admitted=True)
        try:
            b = kubelet_entry(d, oracle_pool)
        except BaseException:
            print(f"phase 14b scheduler stderr tail:\n{d.stderr_tail()}", file=sys.stderr)
            raise
        finally:
            d.close()
    t2 = time.perf_counter()
    st, ev = a["stats"], a["stats"]["informer_events"]
    fleet = "; ".join(
        f"[{first}] {f['kubelets']} kubelets, registered in {f['register_s']:.3f} s, "
        f"{f['ticks']} ticks mean {f['tick_mean_s']:.3f} p50 {f['tick_p50_s']:.3f} max "
        f"{f['tick_max_s']:.3f} s, {json.dumps(f['totals'])}"
        for first, f in sorted(a["fleet"].items()))
    req = a["requests"]
    hb_s = a["wall_s"]
    print(f"phase 14a kubemark density, {a['shape']} (seed 7) on the apiserver at its "
          f"defaults, the scheduler daemon started once the {a['tainted']} taints were "
          f"PATCHed ({a['taint_s']:.3f} s; the daemon serving {a['scheduler_start_s']:.3f} s "
          f"later): {k_procs} fleet processes (half of {os.cpu_count()} cores) registered "
          f"every node in {a['register_s']:.3f} s; waves "
          f"bound at {a['waves_pps']:.1f} pods/s (6a {pps_6a:.1f} in this call), "
          f"create_to_bind_p50_ms {a['c2b_ms'][0]:.1f} create_to_bind_p99_ms "
          f"{a['c2b_ms'][1]:.1f}; pod startup (create -> Running on this watch) "
          f"p50_ms {a['startup_ms'][0]:.1f} p99_ms {a['startup_ms'][1]:.1f} against the "
          f"{STARTUP_SLO_S:.0f} s SLO ({'within' if a['startup_ms'][1] <= STARTUP_SLO_S * 1e3 else 'OVER'}); "
          f"{a['running_pps']:.1f} Running pods/s over {a['wall_s']:.3f} s from the first "
          f"create to the last Running; fleet ticks (1 s apart, heartbeat 10 s, start latency "
          f"0.5 s): {fleet}; apiserver requests in that window "
          f"{json.dumps(req, sort_keys=True)}: heartbeats "
          f"{req.get('get nodes', 0) / hb_s:.1f} GET/s and "
          f"{req.get('update nodes', 0) / hb_s:.1f} PUT/s on nodes, pod status updates "
          f"{req.get('update pods', 0) / hb_s:.1f}/s; the scheduler daemon applied "
          f"{ev.get('Node', 0)} node and {ev.get('Pod', 0)} pod events, batch_s "
          f"{st['batch_s']:.3f} tensorize_s {st['tensorize_s']:.3f} dispatch_s "
          f"{st['dispatch_s']:.3f}, node cache {json.dumps(st['node_cache'])}; launches "
          f"fused_scan {st['launches']} frontier_refresh {st['refresh_launches']}, kernel_ms "
          f"{st['kernel_ms']:.3f}, device idle share over the {a['wall_s']:.3f} s "
          f"{1.0 - st['kernel_ms'] / 1e3 / a['wall_s']:.4f}; CPU over that window in cores "
          f"(the fleet's {k_procs} processes together) "
          f"{json.dumps({k: round(v, 3) for k, v in a['cpu_share'].items()})}; the fleet stopped in "
          f"{a['stop_s']:.3f} s, the read-back checks took {a['check_s']:.3f} s; kubelet "
          f"admission rejections "
          f"{len(a['rejected'])}, pods not Running {len(a['not_running'])}, nodes over "
          f"capacity {len(a['over'])}, pod IPs duplicated within a node {a['ips_within']}, "
          f"addresses on more than one node (hash fallback, no IPAM yet) {a['ips_across']}",
          flush=True)
    bst = b["stats"]
    mismatches = sum(1 for k, n in b["got"].items() if b["oracle"]["assignments"].get(k) != n)
    print(f"phase 14b python -m kubernetes_tpu_torch kubelet --count 1000 as one process, "
          f"registered in {b['register_s']:.3f} s; {len(b['got'])} plain pods in 4 waves bound and Running "
          f"in {b['wall_s']:.3f} s (waves {', '.join(f'{x:.3f}' for x in b['wave_s'])} s), "
          f"startup p50_ms {b['startup_ms'][0]:.1f} p99_ms {b['startup_ms'][1]:.1f}; vs the "
          f"sequential oracle over the cluster as read back: mismatches {mismatches} of "
          f"{len(b['got'])}, rr {bst['round_robin']} vs {b['oracle']['round_robin']}; "
          f"rejections {len(b['rejected'])}; launches fused_scan {bst['launches']} "
          f"frontier_refresh {bst['refresh_launches']}; the fleet exited {b['fleet_rc']} on "
          f"SIGTERM", flush=True)
    print(f"phase 14 took {t2 - t0:.1f} s: 14a {t1 - t0:.1f}, 14b {t2 - t1:.1f}", flush=True)
    if (a["rejected"] or a["not_running"] or a["over"] or a["ips_within"]
            or st["launches"] <= 0 or st["refresh_launches"] <= 0):
        raise AssertionError(f"phase 14a: rejections {list(a['rejected'].items())[:3]}, not "
                             f"Running {a['not_running'][:3]}, over capacity {a['over'][:3]}, "
                             f"IPs duplicated within a node {a['ips_within']}, launches "
                             f"{st['launches']} + {st['refresh_launches']}")
    if (mismatches or set(b["oracle"]["assignments"]) != set(b["got"])
            or b["oracle"]["round_robin"] != bst["round_robin"] or b["rejected"]
            or b["fleet_rc"] != 0):
        raise AssertionError(f"phase 14b: {mismatches} bindings differ from the oracle, rr "
                             f"{bst['round_robin']} vs {b['oracle']['round_robin']}, "
                             f"rejections {len(b['rejected'])}, fleet exit {b['fleet_rc']}")
    return st["launches"] + bst["launches"], st["refresh_launches"] + bst["refresh_launches"]


class NodeWatch:
    """A watch on Nodes from ``rev`` on a thread of its own: the first time
    this client saw each node's Ready condition at anything but True."""

    def __init__(self, rs, rev: int):
        self.mu = threading.Lock()
        self.not_ready: dict = {}
        self.watch = rs.watch("Node", from_revision=rev)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="node-watch")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            ev = self.watch.get(timeout=0.5)
            if ev is None or ev.object is None:
                continue
            conds = (ev.object.get("status") or {}).get("conditions") or []
            ready = next((c for c in conds if c.get("type") == "Ready"), None)
            if ready is not None and ready.get("status") != "True":
                with self.mu:
                    self.not_ready.setdefault(ev.object["metadata"]["name"], time.perf_counter())

    def snapshot(self) -> dict:
        with self.mu:
            return dict(self.not_ready)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.watch.stop()


def app_templates(n_apps: int, seed: int = 7) -> list:
    """``n_apps`` distinct request shapes of the ``mixed`` generator at
    ``seed``, in the order it makes them: the pod kinds (affinity, anti-
    affinity, a disk volume of each kind, a node selector, a toleration)
    and the four plain shapes.  Each is a pod template whose labels gain
    ``deployment: app-<i>``."""
    from kubernetes_tpu_torch.api.types import PodSpec, PodTemplateSpec
    from kubernetes_tpu_torch.workload import make_pods

    seen, out = set(), []
    for pod in make_pods(400, random.Random(seed), "mixed"):
        vol = pod.spec.volumes[0].disk_kind if pod.spec.volumes else ""
        key = (pod.meta.name.split("-")[0], pod.meta.labels.get("app"), vol)
        if key in seen:
            continue
        seen.add(key)
        labels = dict(pod.meta.labels, deployment=f"app-{len(out)}")
        out.append(PodTemplateSpec(labels=labels, spec=PodSpec.from_dict(pod.spec.to_dict())))
        if len(out) == n_apps:
            return out
    raise AssertionError(f"the mixed generator has fewer than {n_apps} request shapes")


def wait_for(what: str, ready, deadline_s: float, every: float = 0.25):
    """Poll ``ready()`` until it returns a true value, which is returned."""
    deadline = time.monotonic() + deadline_s
    while True:
        got = ready()
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: not done after {deadline_s} s")
        time.sleep(every)


def proxy_call(url: str, method: str = "GET", body: bytes = None, ctype: str = None) -> tuple:
    """One request through the apiserver's kubelet proxies: (code, body,
    seconds)."""
    req = urllib.request.Request(url, data=body, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    return code, data, time.perf_counter() - t


def probe_proxies(d: "Daemons", cs) -> dict:
    """Phase 15d: a 1-replica Deployment on the real kubelet's node, then
    every kubelet proxy through the apiserver."""
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.selectors import LabelSelector
    from kubernetes_tpu_torch.api.types import Container, Deployment, Pod, PodSpec, PodTemplateSpec

    kubelet = d._spawn("kubelet-real", ["kubernetes_tpu_torch", "kubelet", "--apiserver", d.url,
                                        "--name", "real", "--count", "1", "--serve-logs",
                                        "--real-containers"])
    out = {}
    try:
        t = time.perf_counter()
        wait_until(lambda: "real" in {n.meta.name for n in cs.nodes.list()[0]}, kubelet,
                   "the real kubelet", 60)
        out["register_s"] = time.perf_counter() - t
        labels = {"deployment": "probe"}
        cs.deployments.create(Deployment(
            meta=ObjectMeta(name="probe", namespace="default"), replicas=1,
            selector=LabelSelector.from_match_labels(labels),
            template=PodTemplateSpec(labels=labels, spec=PodSpec(
                node_selector={"kubernetes.io/hostname": "real"},
                containers=[Container(name="c", image="busybox", command=[
                    "/bin/sh", "-c", "echo probe-started; exec sleep 3600"])]))))
        # a pod no node fits: the subresources answer 400 until it is bound
        cs.pods.create(Pod(meta=ObjectMeta(name="unschedulable", namespace="default"),
                           spec=PodSpec(node_selector={"kubernetes.io/hostname": "nowhere"},
                                        containers=[Container(name="c")])))

        def running():
            pods = [p for p in cs.pods.list("default")[0]
                    if p.meta.labels.get("deployment") == "probe"]
            return pods if pods and pods[0].status.phase == "Running" else None

        t = time.perf_counter()
        pod = wait_for("phase 15d probe pod", running, 60)[0]
        out["start_s"] = time.perf_counter() - t
        out["node"] = pod.spec.node_name
        base = f"{d.url}/api/v1/namespaces/default/pods"
        p = f"{base}/{pod.meta.name}"
        # Running is reported with the sandbox; the container's process
        # has run once its first line is in the log
        t = time.perf_counter()
        wait_for("phase 15d probe log", lambda: b"probe-started" in proxy_call(f"{p}/log")[1], 30)
        out["log_s"] = time.perf_counter() - t
        blob = bytes(range(256)) * 64
        calls = {
            "log": proxy_call(f"{p}/log"),
            "exec": proxy_call(f"{p}/exec", "POST", json.dumps({"command": ["echo", "ok"]}).encode(),
                               "application/json"),
            "cp_put": proxy_call(f"{p}/cp?path=/tmp/blob", "PUT", blob,
                                 "application/octet-stream"),
            "cp_get": proxy_call(f"{p}/cp?path=/tmp/blob"),
            "attach": proxy_call(f"{p}/attach"),
            "node_stats": proxy_call(f"{d.url}/api/v1/nodes/real/proxy/stats/summary"),
            "bad_container": proxy_call(f"{p}/log?container=nope"),
            "bad_tail": proxy_call(f"{p}/log?tailLines=abc"),
            "unscheduled": proxy_call(f"{base}/unschedulable/log"),
        }
        out["codes"] = {k: v[0] for k, v in calls.items()}
        out["seconds"] = {k: v[2] for k, v in calls.items()}
        out["log_ok"] = b"probe-started" in calls["log"][1]
        exec_body = json.loads(calls["exec"][1]) if calls["exec"][0] == 200 else {}
        out["exec_ok"] = exec_body.get("stdout", "").strip() == "ok" and exec_body.get("exitCode") == 0
        out["cp_ok"] = calls["cp_get"][1] == blob
        stats = json.loads(calls["node_stats"][1]) if calls["node_stats"][0] == 200 else {}
        out["stats_ok"] = (stats.get("node") or {}).get("nodeName") == "real"
        cs.pods.delete("unschedulable", "default")
        cs.deployments.delete("probe", "default")
    finally:
        kubelet.send_signal(signal.SIGTERM)
        try:
            out["kubelet_rc"] = kubelet.wait(timeout=60)
        except subprocess.TimeoutExpired:
            kubelet.kill()
            kubelet.wait(timeout=30)
            raise
    return out


def start_controller_manager(d: "Daemons") -> subprocess.Popen:
    """``python -m kubernetes_tpu_torch controller-manager --apiserver URL
    --leader-elect`` at its defaults (every controller, 2 workers each, a
    5 s node monitor period); returns once it leads and runs."""
    cm = d._spawn("controller-manager", ["kubernetes_tpu_torch", "controller-manager",
                                         "--apiserver", d.url, "--leader-elect"])
    err = os.path.join(d.workdir, f"{d.tag}-controller-manager.err")
    wait_until(lambda: "controller manager running" in open(err).read(), cm,
               "the controller manager", 120)
    return cm


def stop_controller_manager(d: "Daemons", cm: subprocess.Popen) -> dict:
    cm.send_signal(signal.SIGTERM)
    rc = cm.wait(timeout=120)
    if rc != 0:
        raise RuntimeError(f"the controller manager exited {rc} on SIGTERM")
    out = open(os.path.join(d.workdir, f"{d.tag}-controller-manager.out")).read()
    lines = [ln for ln in out.splitlines() if ln.startswith('{"controller_manager_stats"')]
    if len(lines) != 1:
        raise AssertionError(f"expected one stats line from the controller manager, got "
                             f"{len(lines)}")
    return json.loads(lines[0])["controller_manager_stats"]


def endpoints_mismatch(rs, apps: list) -> list:
    """The Services whose Endpoints do not hold exactly the IPs of their
    ready pods (Running, Ready condition True) as stored."""
    pods = rs.list("Pod", "default")[0]
    eps = {e["metadata"]["name"]: e for e in rs.list("Endpoints", "default")[0]}
    bad = []
    for app in apps:
        want = set()
        for p in pods:
            st = p.get("status") or {}
            if (p["metadata"].get("labels") or {}).get("deployment") != app or not st.get("podIP"):
                continue
            ready = next((c for c in st.get("conditions") or [] if c.get("type") == "Ready"), None)
            if st.get("phase") == "Running" and (ready is None or ready.get("status") == "True"):
                want.add(st["podIP"])
        got = {a["ip"] for s in (eps.get(app, {}).get("subsets") or [])
               for a in s.get("addresses") or []}
        if got != want:
            bad.append(app)
    return bad


def rollout(d: "Daemons", k_procs: int, n_nodes: int = 5000, n_apps: int = 10,
            replicas: int = 100, step: int = 25, lose: int = 1, sched_args: tuple = ()) -> dict:
    """Phase 15a-15d on ``d``'s apiserver at its defaults: ``k_procs`` fleet
    processes register ``n_nodes`` of 14a's seeded cluster, the controller
    manager and the card's scheduler start, ``n_apps`` Deployments of
    ``replicas`` roll out, roll to a new image, ``lose`` fleet processes
    are SIGKILLed and ``app-0`` doubles; then the proxies."""
    import ipaddress
    import multiprocessing

    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.selectors import LabelSelector
    from kubernetes_tpu_torch.api.types import Deployment, Service, ServicePort
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.controllers.deployment import template_hash
    from kubernetes_tpu_torch.workload import make_nodes, overcommitted_nodes, run_hollow_fleet

    seed = 7
    nodes = make_nodes(n_nodes, random.Random(seed), "mixed")
    apps = [f"app-{i}" for i in range(n_apps)]
    templates = app_templates(n_apps, seed)
    mp = multiprocessing.get_context("spawn")
    # an Event a process: setting one that a SIGKILLed process waited on
    # would wait for that process to wake
    stops, results = [mp.Event() for _ in range(k_procs)], mp.Queue()
    share = -(-n_nodes // k_procs)
    procs = [mp.Process(target=run_hollow_fleet, name=f"fleet-{i}",
                        args=(d.url, n_nodes, "mixed", seed, i * share,
                              min(share, n_nodes - i * share), stops[i], results))
             for i in range(k_procs)]
    lost_procs = procs[k_procs - lose:]
    lost = {n.meta.name for i, n in enumerate(nodes) if i >= (k_procs - lose) * share}
    out = {"shape": f"{n_nodes} hollow nodes, {n_apps} Deployments x {replicas}",
           "fleet": {}, "k_procs": k_procs, "replicas": replicas, "step": step,
           "cidrs_want": min(1024, n_nodes + 1)}
    rs = RemoteStore(d.url, timeout=120.0)
    cs = Clientset(RemoteStore(d.url, timeout=120.0))
    cm = times = nodes_seen = None
    t0 = time.perf_counter()
    try:
        # every node's Ready condition is watched from before the first one
        # registers; the controller manager and the scheduler start while
        # the fleet registers (no check here is of binding order)
        _, node_rev = rs.list("Node")
        nodes_seen = NodeWatch(rs, node_rev)
        metrics0 = request_counts(http_get(d.url + "/metrics").decode())
        for proc in procs:
            proc.start()
        t = time.perf_counter()
        cm = start_controller_manager(d)
        out["cm_start_s"] = time.perf_counter() - t
        d.start_scheduler(*sched_args)
        registered = 0
        while registered < k_procs:
            try:
                tag, first, value = results.get(timeout=1.0)
            except queue.Empty:
                if any(not proc.is_alive() for proc in procs):
                    raise RuntimeError("phase 15: a fleet process died while registering")
                if time.perf_counter() - t0 > 300:
                    raise TimeoutError("phase 15: the fleet did not register in 300 s")
                continue
            registered += 1
        out["register_s"] = time.perf_counter() - t0
        for n in nodes:  # kubectl taint, as in 14a
            if n.spec.taints:
                rs.patch("Node", "", n.meta.name,
                         {"spec": {"taints": [x.to_dict() for x in n.spec.taints]}})
        _, rev = rs.list("Pod")
        times = PodTimes(rs, rev)
        pids = {"apiserver": d.apiserver.pid, "scheduler": d.scheduler.pid,
                "controller_manager": cm.pid, "fleet": [proc.pid for proc in procs]}
        cpu0 = {k: sum(cpu_s(p) for p in (v if isinstance(v, list) else [v]))
                for k, v in pids.items()}
        t_phase = time.perf_counter()

        # -- 15a: the rollout ------------------------------------------------
        for app, tpl in zip(apps, templates):
            cs.services.create(Service(meta=ObjectMeta(name=app, namespace="default"),
                                       selector={"deployment": app},
                                       ports=[ServicePort(port=80, target_port=8080)]))
        t_a = time.perf_counter()
        for app, tpl in zip(apps, templates):
            cs.deployments.create(Deployment(
                meta=ObjectMeta(name=app, namespace="default"), replicas=replicas,
                selector=LabelSelector.from_match_labels({"deployment": app}), template=tpl,
                max_surge=step, max_unavailable=step))

        def all_ready(want: int, updated: bool = False):
            deps = [dp for dp in cs.deployments.list("default")[0] if dp.meta.name in apps]
            return len(deps) == n_apps and all(
                dp.status_ready_replicas == want and (not updated or dp.status_updated_replicas
                                                      == want) for dp in deps)

        wait_for("phase 15a rollout", lambda: all_ready(replicas), 300)
        out["a_s"] = time.perf_counter() - t_a
        with times.mu:
            keys_a = list(times.added)
        times.wait(keys_a, "running", 60, "phase 15a")
        with times.mu:
            created = sorted(times.added.values())
            out["a_creates_per_s"] = len(created) / max(created[-1] - created[0], 1e-9)
            out["a_c2b_ms"] = quantiles_ms([times.bound[k] - times.added[k] for k in keys_a])
            out["a_c2r_ms"] = quantiles_ms([times.running[k] - times.added[k] for k in keys_a])
        if len(keys_a) != n_apps * replicas:
            raise AssertionError(f"phase 15a: {len(keys_a)} pods made for "
                                 f"{n_apps * replicas} replicas")

        # -- 15b: a rolling update -------------------------------------------
        t_b = time.perf_counter()
        new_rs = {}
        for app in apps:
            def _image(dp):
                dp.template.spec.containers[0].image = "registry.example/app:v2"
                return dp

            got = cs.deployments.guaranteed_update(app, _image, "default")
            new_rs[app] = f"{app}-{template_hash(got.template)}"

        def rolled():
            if not all_ready(replicas, updated=True):
                return False
            sets = cs.replicasets.list("default")[0]
            return all(r.replicas == 0 and r.status_replicas == 0 for r in sets
                       if r.meta.name not in new_rs.values())

        wait_for("phase 15b rolling update", rolled, 400)
        out["b_s"] = time.perf_counter() - t_b
        pods = rs.list("Pod", "default")[0]
        out["b_not_newest"] = [p["metadata"]["name"] for p in pods
                               if (p["metadata"].get("labels") or {}).get("deployment") in new_rs
                               and next((r["name"] for r in p["metadata"].get("ownerReferences")
                                         or [] if r.get("controller")), None)
                               != new_rs[p["metadata"]["labels"]["deployment"]]]
        with times.mu:
            keys_b = [k for k in times.added if k not in set(keys_a)]
        times.wait(keys_b, "running", 60, "phase 15b")
        with times.mu:
            out["b_c2r_ms"] = quantiles_ms([times.running[k] - times.added[k] for k in keys_b])
        out["b_pods"] = len(keys_b)

        # -- 15c: a lost node pool -------------------------------------------
        deletes0 = request_counts(http_get(d.url + "/metrics").decode()).get("delete pods", 0)
        t_c = time.perf_counter()
        for proc in lost_procs:
            proc.kill()  # SIGKILL: the kubelets stop heartbeating at once
            proc.join(timeout=30)
        unknown = wait_for("phase 15c nodes Unknown",
                           lambda: lost <= set(nodes_seen.snapshot()) and nodes_seen.snapshot(),
                           180, every=0.5)
        out["c_unknown_s"] = max(unknown[n] for n in lost) - t_c
        out["c_unknown_first_s"] = min(unknown[n] for n in lost) - t_c
        with times.mu:
            before = set(times.added)

        def _scale(dp):
            dp.replicas = 2 * replicas
            return dp

        t_scale = time.perf_counter()
        cs.deployments.guaranteed_update(apps[0], _scale, "default")

        def scaled():
            with times.mu:
                new = [k for k in times.added if k not in before]
                done = len(new) >= replicas and all(k in times.running for k in new)
            dp = cs.deployments.get(apps[0], "default")
            return new if done and dp.status_ready_replicas == 2 * replicas else None

        new_c = wait_for("phase 15c scale-up", scaled, 180)
        out["c_scale_s"] = time.perf_counter() - t_scale
        with times.mu:
            out["c_on_lost"] = [k for k in new_c if times.nodes.get(k) in lost]
            out["c_c2r_ms"] = quantiles_ms([times.running[k] - times.added[k] for k in new_c])
        out["c_pods"] = len(new_c)
        out["c_deletes"] = (request_counts(http_get(d.url + "/metrics").decode())
                            .get("delete pods", 0) - deletes0)
        out["c_s"] = time.perf_counter() - t_c

        # endpoints converge on the pods as stored
        t = time.perf_counter()
        try:
            wait_for("phase 15 endpoints", lambda: not endpoints_mismatch(rs, apps), 60, every=1.0)
        except TimeoutError:
            pass  # reported and checked below
        out["endpoints_bad"] = endpoints_mismatch(rs, apps)
        out["endpoints_s"] = time.perf_counter() - t

        # -- 15d: the proxies ------------------------------------------------
        t_d = time.perf_counter()
        out["d"] = probe_proxies(d, cs)
        out["d_s"] = time.perf_counter() - t_d
        t_end = time.perf_counter()
        out["wall_s"] = t_end - t_phase
        out["cpu_share"] = {
            k: (sum(cpu_s(p) for p in (v if isinstance(v, list) else [v])
                    if p not in {lp.pid for lp in lost_procs}) - cpu0[k]) / out["wall_s"]
            for k, v in pids.items() if k != "fleet"}
        metrics1 = request_counts(http_get(d.url + "/metrics").decode())
        out["requests"] = {k: v - metrics0.get(k, 0) for k, v in metrics1.items()
                           if v - metrics0.get(k, 0)}
        out["not_ready_nodes"] = set(nodes_seen.snapshot())
        with times.mu:
            out["rejected"] = dict(times.rejected)
        out["cm"] = stop_controller_manager(d, cm)
        cm = None
        out["stats"] = d.stop_scheduler()
    finally:
        live = [proc for proc in procs if proc not in lost_procs]
        for proc, ev in zip(procs, stops):
            if proc in live:
                ev.set()
        reports = {}
        deadline = time.monotonic() + 120
        while len(reports) < len(live) and time.monotonic() < deadline:
            if not any(proc.is_alive() for proc in live) and results.empty():
                break
            try:
                tag, first, value = results.get(timeout=1.0)
            except queue.Empty:
                continue
            if tag == "done":
                reports[first] = value
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        if cm is not None and cm.poll() is None:
            cm.kill()
            cm.wait(timeout=30)
        for w in (times, nodes_seen):
            if w is not None:
                w.stop()
    if len(reports) != len(live) or any(proc.exitcode != 0 for proc in live):
        raise AssertionError(f"phase 15: {len(reports)} of {len(live)} live fleet reports, exit "
                             f"codes {[proc.exitcode for proc in live]}")
    for first in sorted(reports):
        ticks = sorted(reports[first]["ticks"])
        out["fleet"][first] = {"ticks": len(ticks), "tick_mean_s": sum(ticks) / len(ticks),
                               "tick_max_s": ticks[-1]}
    items = rs.list("Pod")[0]
    node_items = rs.list("Node")[0]
    out["not_running"] = [p["metadata"]["name"] for p in items
                          if (p.get("status") or {}).get("phase") != "Running"]
    out["unbound"] = [p["metadata"]["name"] for p in items if not p["spec"].get("nodeName")]
    out["over"] = overcommitted_nodes(items, node_items)
    out["ips_within"], _ = ip_check(items)
    cidrs = [(n.get("spec") or {}).get("podCIDR") for n in node_items]
    cidrs = [c for c in cidrs if c]
    net = ipaddress.ip_network("10.8.0.0/14")
    out["cidrs"] = len(cidrs)
    out["cidrs_ok"] = (len(set(cidrs)) == len(cidrs)
                       and all(ipaddress.ip_network(c).subnet_of(net) for c in cidrs))
    out["lost"] = lost
    return out


def controller_phase(pps_6a: float) -> tuple[int, int]:
    """Phase 15: the controller manager at 2000 nodes under the card's
    scheduler.  Returns the scheduler daemon's fused and refresh launches."""
    # 500 nodes a process: one is a quarter of every zone.  2000 nodes, not
    # 14a's 5000: at 5000 the hollow kubelets' heartbeats and the controllers'
    # syncs of them held 8 cores and the phase took 224 s of the run's 1180
    k_procs, n_nodes = 4, 2000
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        d = Daemons(workdir, "15", admitted=True)
        try:
            # half the replicas a rolling step: two rounds a rollout
            r = rollout(d, k_procs, n_nodes=n_nodes, replicas=24, step=12)
        except BaseException:
            for name in ("scheduler", "controller-manager"):
                path = os.path.join(workdir, f"15-{name}.err")
                if os.path.exists(path):
                    print(f"phase 15 {name} stderr tail:\n{open(path).read()[-4000:]}",
                          file=sys.stderr)
            raise
        finally:
            d.close()
    report_controllers(r, pps_6a, time.perf_counter() - t0)
    return r["stats"]["launches"], r["stats"]["refresh_launches"]


def report_controllers(r: dict, pps_6a: float, phase_s: float) -> None:
    """Print phase 15's lines and hold its exact checks."""
    st, cm, dd = r["stats"], r["cm"], r["d"]
    req = r["requests"]
    ctl = "; ".join(f"{k} {v['syncs']} syncs {v['sync_s']:.3f} s queue {v['queue']}"
                    + (f" errors {v['errors']}" if v["errors"] else "")
                    for k, v in sorted(cm["controllers"].items()) if v["syncs"] or v["queue"])
    ticks = "; ".join(f"{k} {v['ticks']} x mean {v['s'] / max(v['ticks'], 1):.4f} max "
                      f"{v['max_s']:.4f} s" for k, v in sorted(cm["ticks"].items()))
    fleet = "; ".join(f"[{first}] {f['ticks']} ticks mean {f['tick_mean_s']:.3f} max "
                      f"{f['tick_max_s']:.3f} s" for first, f in sorted(r["fleet"].items()))
    print(f"phase 15a controller-driven rollout, {r['shape']} (the mixed generator's request "
          f"shapes, seed 7; maxSurge/maxUnavailable {r['step']}), the apiserver at its defaults, "
          f"{r['k_procs']} fleet processes registered in {r['register_s']:.3f} s while the "
          f"controller manager (leading {r['cm_start_s']:.3f} s after its start) and the "
          f"scheduler started: every "
          f"Deployment ready in {r['a_s']:.3f} s; the ReplicaSet controller created "
          f"{r['a_creates_per_s']:.1f} pods/s; create_to_bind p50_ms {r['a_c2b_ms'][0]:.1f} "
          f"p99_ms {r['a_c2b_ms'][1]:.1f}, create_to_running p50_ms {r['a_c2r_ms'][0]:.1f} "
          f"p99_ms {r['a_c2r_ms'][1]:.1f} (6a {pps_6a:.1f} pods/s in this call)", flush=True)
    print(f"phase 15b rolling update to a new image: {r['b_pods']} new pods, every Deployment "
          f"updated == ready == {r['replicas']} and its old ReplicaSet at 0 in {r['b_s']:.3f} s, "
          f"create_to_running p50_ms {r['b_c2r_ms'][0]:.1f} p99_ms {r['b_c2r_ms'][1]:.1f}; "
          f"pods not owned by their Deployment's newest ReplicaSet {len(r['b_not_newest'])}",
          flush=True)
    print(f"phase 15c lost node pool: a fleet process SIGKILLed ({len(r['lost'])} nodes); the "
          f"node lifecycle controller set Ready=Unknown on the first {r['c_unknown_first_s']:.3f} "
          f"s and on all of them {r['c_unknown_s']:.3f} s after the kill (grace 40 s, monitor "
          f"period 5 s); nodes ever not Ready {len(r['not_ready_nodes'])}, of them outside the "
          f"lost pool {len(r['not_ready_nodes'] - r['lost'])}; zone states "
          f"{json.dumps(cm.get('zone_states', {}), sort_keys=True)}; app-0 {r['replicas']} -> {2 * r['replicas']}: "
          f"{r['c_pods']} new pods Running in {r['c_scale_s']:.3f} s (create_to_running p50_ms "
          f"{r['c_c2r_ms'][0]:.1f} p99_ms {r['c_c2r_ms'][1]:.1f}), on lost nodes "
          f"{len(r['c_on_lost'])}; pod deletes in 15c {r['c_deletes']}", flush=True)
    print(f"phase 15d the kubelet proxies on the real kubelet (registered in "
          f"{dd['register_s']:.3f} s, the probe pod Running {dd['start_s']:.3f} s after its "
          f"Deployment, on {dd['node']}): codes {json.dumps(dd['codes'], sort_keys=True)}, "
          f"seconds {json.dumps({k: round(v, 4) for k, v in dd['seconds'].items()}, sort_keys=True)}; "
          f"log {dd['log_ok']}, exec echo ok {dd['exec_ok']}, cp round trip {dd['cp_ok']}, "
          f"stats summary {dd['stats_ok']}; the kubelet exited {dd['kubelet_rc']} on SIGTERM",
          flush=True)
    print(f"phase 15 the controller manager: CPU over the phase in cores "
          f"{json.dumps({k: round(v, 3) for k, v in r['cpu_share'].items()})} (phase "
          f"{r['wall_s']:.3f} s); controllers {ctl}; ticks {ticks}; node-ipam podCIDRs "
          f"{r['cidrs']} (distinct and inside 10.8.0.0/14: {r['cidrs_ok']}); Endpoints equal to "
          f"their ready pods after {r['endpoints_s']:.3f} s, differing {r['endpoints_bad']}; "
          f"fleet ticks {fleet}; apiserver requests {json.dumps(req, sort_keys=True)}; the "
          f"scheduler daemon: launches fused_scan {st['launches']} frontier_refresh "
          f"{st['refresh_launches']}, kernel_ms {st['kernel_ms']:.3f}; rejections "
          f"{len(r['rejected'])}, unbound {len(r['unbound'])}, not Running "
          f"{len(r['not_running'])}, over capacity {len(r['over'])}, IPs duplicated within a "
          f"node {r['ips_within']}", flush=True)
    print(f"phase 15 took {phase_s:.1f} s: 15a {r['a_s']:.1f}, 15b {r['b_s']:.1f}, 15c "
          f"{r['c_s']:.1f}, 15d {r['d_s']:.1f}", flush=True)
    codes = dd["codes"]
    want_codes = {"log": 200, "exec": 200, "cp_put": 200, "cp_get": 200, "attach": 200,
                  "node_stats": 200, "bad_container": 400, "bad_tail": 400, "unscheduled": 400}
    failures = {
        "rejections": len(r["rejected"]), "unbound": r["unbound"][:3],
        "not Running": r["not_running"][:3], "over capacity": r["over"][:3],
        "IPs duplicated within a node": r["ips_within"],
        "pods not of the newest ReplicaSet": r["b_not_newest"][:3],
        "Endpoints differing": r["endpoints_bad"],
        "new pods on lost nodes": r["c_on_lost"][:3],
        "nodes not Ready outside the lost pool": sorted(r["not_ready_nodes"] - r["lost"])[:3],
        "lost nodes never Unknown": sorted(r["lost"] - r["not_ready_nodes"])[:3],
        "pod deletes in 15c": r["c_deletes"],
        "podCIDRs": None if r["cidrs"] == r["cidrs_want"] and r["cidrs_ok"] else r["cidrs"],
        "fused launches": None if st["launches"] > 0 else st["launches"],
        "proxy codes": None if codes == want_codes else codes,
        "proxy bodies": None if dd["log_ok"] and dd["exec_ok"] and dd["cp_ok"]
        and dd["stats_ok"] else (dd["log_ok"], dd["exec_ok"], dd["cp_ok"], dd["stats_ok"]),
        "real kubelet exit": dd["kubelet_rc"] or None,
    }
    failed = {k: v for k, v in failures.items() if v}
    if failed:
        raise AssertionError(f"phase 15: {failed}")



# -- phase 16: a cluster as `cluster init` and `join` turn it up -------------

def free_udp_port() -> int:
    """A ``free_port()`` whose number is free for UDP too (the DNS addon's)."""
    for _ in range(100):
        port = free_port()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no loopback port free for both TCP and UDP")


def metric_lines(url: str, prefix: str) -> dict:
    """The ``prefix``-named samples of a daemon's /metrics, by name."""
    return {line.split(" ", 1)[0]: float(line.split(" ", 1)[1])
            for line in http_get(url + "/metrics").decode().splitlines()
            if line.startswith(prefix) and " " in line}


def ready_pods(pods: list, app: str, key: str = "deployment") -> list:
    """The pods (wire dicts) labelled ``key=app`` that are Running with a
    pod IP and not unready: what the Endpoints of ``app`` must hold."""
    out = []
    for p in pods:
        st = p.get("status") or {}
        if (p["metadata"].get("labels") or {}).get(key) != app or not st.get("podIP"):
            continue
        ready = next((c for c in st.get("conditions") or [] if c.get("type") == "Ready"), None)
        if st.get("phase") == "Running" and (ready is None or ready.get("status") == "True"):
            out.append(p)
    return out


def want_rules(services: list, pods: list) -> list:
    """The rule rows (``proxy.hollow.rule_rows``'s form) every proxier must
    hold, worked out from the Services and their ready pods: one rule a
    port of each Service with a cluster IP, its endpoints the ready pods'
    IPs at the target port (a REJECT with none), and a NodePort rule for a
    LoadBalancer's port with endpoints."""
    rows = []
    for svc in services:
        if svc.cluster_ip in ("", "None"):
            continue
        ips = [p["status"]["podIP"] for p in ready_pods(pods, svc.meta.name)]
        for sp in svc.ports:
            eps = sorted([ip, sp.target_port] for ip in ips)
            spn = f"{svc.meta.namespace}/{svc.meta.name}:{sp.name}"
            rows.append(["cluster" if eps else "reject", svc.cluster_ip, sp.port, sp.protocol,
                         spn, eps])
            if eps and sp.node_port and svc.type in ("NodePort", "LoadBalancer"):
                rows.append(["nodeport", "", sp.node_port, sp.protocol, spn, eps])
    return sorted(rows)


def dns_mismatch(addr: tuple, services: list, pods: list, lookup) -> tuple[list, list]:
    """Each Service by name over UDP through the addon: A is its cluster IP,
    or a headless Service's ready pod IPs; SRV of its named port is the
    Service, or one target a ready pod.  Returns the names that differ and
    each lookup's seconds."""
    bad, seconds = [], []
    for svc in services:
        base = f"{svc.meta.name}.{svc.meta.namespace}.svc.cluster.local"
        ready = ready_pods(pods, svc.meta.name)
        headless = svc.cluster_ip in ("", "None")
        want_a = sorted({p["status"]["podIP"] for p in ready}) if headless else [svc.cluster_ip]
        checks = [(base, "A", want_a)]
        for sp in svc.ports:
            want = (sorted((sp.port, f"{p['metadata']['name']}.{base}") for p in ready)
                    if headless else [(sp.port, base)])
            checks.append((f"_{sp.name}._{sp.protocol.lower()}.{base}", "SRV", want))
        for name, qtype, want in checks:
            t = time.perf_counter()
            got = lookup(addr, name, qtype)
            seconds.append(time.perf_counter() - t)
            if (sorted(got) if qtype == "SRV" else got) != want:
                bad.append(f"{qtype} {name}")
    return bad, seconds


class Cli:
    """A tool of the hyperkube run as a user runs it: ``python -m
    kubernetes_tpu_torch <prefix...> <args...>``, one process a command, in
    this run's environment (``CHIP_SMOKE_RUN`` included).  Keeps each
    call's wall seconds."""

    def __init__(self, what: str, cwd: str, env: dict, *prefix: str):
        self.what, self.cwd, self.env, self.prefix = what, cwd, env, prefix
        self.walls: list = []

    def __call__(self, *args: str) -> str:
        """The command's output; any exit code but 0 fails the phase."""
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch", *self.prefix, *args],
                           cwd=self.cwd, env=self.env, capture_output=True, text=True,
                           timeout=120)
        self.walls.append(time.perf_counter() - t)
        if p.returncode != 0:
            raise AssertionError(f"{self.what}: {self.prefix[0]} {' '.join(args)} exited "
                                 f"{p.returncode}: {(p.stdout + p.stderr)[-1500:]}")
        return p.stdout


def labelled(rs, key: str, value: str) -> list:
    """The default namespace's pods (wire dicts) with label ``key=value``."""
    return [p for p in rs.list("Pod", "default")[0]
            if (p["metadata"].get("labels") or {}).get(key) == value]


def bound_running(pod: dict) -> bool:
    return bool(pod["spec"].get("nodeName")) and (
        (pod.get("status") or {}).get("phase") == "Running")


def all_running(rs, key: str, value: str, n: int):
    """The ``n`` pods labelled ``key=value`` once every one is bound and
    Running, else None."""
    pods = labelled(rs, key, value)
    return pods if len(pods) == n and all(map(bound_running, pods)) else None


def kubectl_steps(kubectl: Cli, rs, n_nodes: int, launches) -> dict:
    """Phase 16d: ``tests/test_conformance.py``'s order through ``python -m
    kubernetes_tpu_torch kubectl`` on phase 16's cluster.  Every command's
    exit code and the fact named beside it are exact checks; the card's
    scheduler binds every pod the commands make.  A rollout is awaited
    in this process, by kubectl's own check over the wire, before ``rollout
    status`` runs as a command (the port's is one-shot, without ``-w``)."""
    from kubernetes_tpu_torch.cli.kubectl import Kubectl
    from kubernetes_tpu_torch.client.clientset import Clientset

    what = "phase 16d"
    out = {"steps": {}, "launches_before": launches()}
    t_step = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        out["steps"][name] = now - t_step[0]
        t_step[0] = now

    def fail(fact: str, got) -> None:
        raise AssertionError(f"{what}: {fact}: {got}")

    probe = Kubectl(Clientset(rs), out=io.StringIO())

    def rolled_out() -> None:
        wait_for(f"{what} rollout of web", lambda: probe.rollout_status("web") == 0, 180)
        kubectl("rollout", "status", "deployment/web")

    rev = rs.list("Pod")[1]
    times = PodTimes(rs, rev)
    try:
        nodes = kubectl("get", "nodes").splitlines()[1:]
        if len(nodes) != n_nodes:
            fail(f"get nodes lists {len(nodes)} nodes, not", n_nodes)
        step("get_nodes")
        kubectl("run", "web", "--image", "app:v1", "--replicas", "50")
        # the rolling update's 25 % (apps/v1beta1's default; the run
        # generator's Deployment moves one pod at a time): 13 surge, 12
        # unavailable of 50
        kubectl("patch", "deployment", "web", "-p",
                json.dumps({"spec": {"maxSurge": 13, "maxUnavailable": 12}}))
        rolled_out()
        step("run")
        listed = json.loads(kubectl("get", "pods", "-l", "run=web", "-o", "json"))["items"]
        by_kubectl = {p["metadata"]["name"]: p["spec"].get("nodeName") for p in listed}
        wire = {p["metadata"]["name"]: p["spec"].get("nodeName")
                for p in labelled(rs, "run", "web")}
        if len(listed) != 50 or not all(map(bound_running, listed)) or by_kubectl != wire:
            fail("get pods -l run=web: 50 pods bound and Running, as the wire lists them",
                 {"listed": len(listed), "running": sum(map(bound_running, listed)),
                  "equal": by_kubectl == wire})
        out["web_nodes"] = len(set(by_kubectl.values()))
        step("get_pods")

        def images() -> set:
            return {p["spec"]["containers"][0]["image"] for p in labelled(rs, "run", "web")}

        kubectl("set", "image", "deployment/web", "web=app:v2")
        rolled_out()
        history = kubectl("rollout", "history", "deployment/web").splitlines()[2:]
        revisions = [ln.split()[0] for ln in history if ln.strip()]
        if revisions != ["1", "2"]:
            fail("rollout history shows revisions", revisions)
        wait_for(f"{what} pods on app:v2", lambda: images() == {"app:v2"}, 60)
        step("set_image")
        kubectl("rollout", "undo", "deployment/web")
        rolled_out()
        image = kubectl("get", "deployment", "web", "-o",
                        "jsonpath={.spec.template.spec.containers[0].image}").strip()
        if image != "app:v1":
            fail("after rollout undo the template's image is", image)
        wait_for(f"{what} pods back on app:v1", lambda: images() == {"app:v1"}, 60)
        step("undo")
        kubectl("scale", "deployment", "web", "--replicas", "10")
        rolled_out()
        web = wait_for(f"{what} 10 web pods", lambda: all_running(rs, "run", "web", 10), 60)
        step("scale")
        kubectl("expose", "deployment", "web", "--port", "80")

        def endpoints_hold():
            try:
                eps = rs.get("Endpoints", "default", "web")
            except KeyError:
                return None
            got = {a["ip"] for s in eps.get("subsets") or [] for a in s.get("addresses") or []}
            want = {p["status"]["podIP"] for p in ready_pods(labelled(rs, "run", "web"), "web",
                                                             key="run")}
            return got if got == want and len(got) == 10 else None

        out["endpoints"] = len(wait_for(f"{what} Endpoints of web", endpoints_hold, 60))
        step("expose")
        pod = next(p for p in sorted(web, key=lambda p: p["metadata"]["name"])
                   if p["spec"]["nodeName"].startswith("pool-"))
        name, node = pod["metadata"]["name"], pod["spec"]["nodeName"]
        logs = kubectl("logs", name)
        if "container web started" not in logs:
            fail(f"logs {name} on {node} holds no start line", logs[-300:])
        said = kubectl("exec", name, "--", "echo", "hello")
        if said != "echo hello\n":
            fail(f"exec {name} on {node} answered", said)
        step("logs_exec")
        rows = kubectl("top", "nodes").splitlines()[1:]
        if len(rows) != n_nodes:
            fail("top nodes lists", len(rows))
        step("top_nodes")
        listed = {ln.split()[0] for ln in kubectl("top", "pods").splitlines()[1:]}
        if not {p["metadata"]["name"] for p in web} <= listed:
            fail("top pods lists no row for a web pod", sorted(listed)[:5])
        step("top_pods")
        # drain a fleet node that holds a web pod: every pod on it is evicted
        # and its replacement bound by the card to another node, Running
        before = {p["metadata"]["name"]: p["spec"].get("nodeName")
                  for p in rs.list("Pod", "default")[0]}
        evicted = sorted(n for n, at in before.items() if at == node)
        kubectl("cordon", node)
        kubectl("drain", node)

        def replaced():
            pods = rs.list("Pod", "default")[0]
            new = [p for p in pods if p["metadata"]["name"] not in before]
            left = [p["metadata"]["name"] for p in pods if p["spec"].get("nodeName") == node]
            if (len(new) == len(evicted) and not left and all(map(bound_running, new))
                    and not any(p["metadata"]["name"] in evicted for p in pods)):
                return new
            return None

        new = wait_for(f"{what} the drained node's pods replaced", replaced, 120)
        out["drain"] = {"node": node, "evicted": len(evicted),
                        "replacement_nodes": len({p["spec"]["nodeName"] for p in new})}
        kubectl("uncordon", node)
        step("drain")
        kubectl("delete", "deployment", "web")
        kubectl("delete", "service", "web")
        wait_for(f"{what} web's pods gone", lambda: not labelled(rs, "run", "web"), 120)
        step("delete")
        with times.mu:
            out["bound"] = len(times.bound)
    finally:
        times.stop()
    out["launches_after"] = launches()
    return out


def federation_steps(kubectl: Cli, kubefed: Cli, fed: subprocess.Popen, fed_url: str,
                     member_url: str, rs, workdir: str, launches) -> dict:
    """Phase 16e: ``python -m kubernetes_tpu_torch.federation`` over phase
    16's cluster as its member, through ``kubefed`` and ``kubectl``: a
    federated Deployment of 50 replicas placed on the member appears there
    with the federated spec, its pods bound by the card and Running, its
    status rolled up, and its deletion reaching the member."""
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.federation.types import Cluster  # the kind, registered

    what = "phase 16e"
    out = {"steps": {}, "launches_before": launches()}
    t_step = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        out["steps"][name] = now - t_step[0]
        t_step[0] = now

    def alive() -> None:
        if fed.poll() is not None:
            raise RuntimeError(f"{what}: the federation exited {fed.returncode}")

    def healthy():
        alive()
        try:
            return http_get(fed_url + "/healthz")
        except OSError:
            return None

    wait_for(f"{what} the federation's /healthz", healthy, 60)
    frs = RemoteStore(fed_url, timeout=60.0)
    step("start")
    said = kubefed("join", "member", "--cluster-server", member_url)
    if said != "cluster/member joined\n":
        raise AssertionError(f"{what}: kubefed join said {said!r}")

    def ready() -> bool:  # the cluster controller's probe, over the wire
        alive()
        return Cluster.from_dict(frs.get("Cluster", "", "member")).ready

    def member_row() -> list:
        rows = [ln.split() for ln in kubefed("get-clusters").splitlines()[1:]]
        if rows != [["member", member_url, "True"]]:
            raise AssertionError(f"{what}: kubefed get-clusters lists {rows}")
        return rows

    wait_for(f"{what} member Ready", ready, 60)
    out["clusters"] = member_row()
    step("join")
    manifest = os.path.join(workdir, "fed-web.json")
    with open(manifest, "w") as f:
        json.dump({"kind": "Deployment", "apiVersion": "apps/v1beta1", "metadata": {
            "name": "fed-web", "namespace": "default",
            "annotations": {"federation.kubernetes.io/clusters": json.dumps(["member"])}},
            "spec": {"replicas": 50, "selector": {"matchLabels": {"app": "fed-web"}},
                     "template": {"metadata": {"labels": {"app": "fed-web"}}, "spec": {
                         "containers": [{"name": "web", "image": "app:v1"}]}}}}, f)
    kubectl("create", "-f", manifest)
    want = frs.get("Deployment", "default", "fed-web")["spec"]

    def in_member():
        alive()
        try:
            return rs.get("Deployment", "default", "fed-web")
        except KeyError:
            return None

    got = wait_for(f"{what} fed-web in the member", in_member, 60)
    if got["spec"] != want:
        raise AssertionError(f"{what}: the member's fed-web spec {got['spec']} != the "
                             f"federation's {want}")
    step("fan_out")
    pods = wait_for(f"{what} 50 fed-web pods Running",
                    lambda: all_running(rs, "app", "fed-web", 50), 180)
    out["nodes"] = len({p["spec"]["nodeName"] for p in pods})
    step("running")

    def rolled_up():
        alive()
        st = frs.get("Deployment", "default", "fed-web").get("status") or {}
        return st if st.get("readyReplicas") == 50 else None

    out["status"] = wait_for(f"{what} the federation's readyReplicas 50", rolled_up, 60)
    out["clusters"] = member_row()
    step("rollup")
    kubectl("delete", "deployment", "fed-web")

    def gone():
        alive()
        return in_member() is None and not labelled(rs, "app", "fed-web")

    wait_for(f"{what} fed-web gone from the member", gone, 120)
    step("delete")
    said = kubefed("unjoin", "member")
    if said != "cluster/member unjoined\n":
        raise AssertionError(f"{what}: kubefed unjoin said {said!r}")
    out["launches_after"] = launches()
    fed.send_signal(signal.SIGTERM)
    out["exit"] = fed.wait(timeout=60)
    step("stop")
    return out


def lifecycle(workdir: str, per_fleet: int = 500, replicas: int = 25,
              init_args: tuple = ()) -> dict:
    """Phase 16 in ``workdir``: 16a ``cluster init`` at its defaults but the
    ports (``init_args`` adds flags: ``--device cpu`` for a dry run), a join
    with a wrong token and two with the printed one; 16b two fleet
    processes of ``per_fleet`` hollow nodes and kube-proxies, the cloud
    controller manager, 10 Deployments x ``replicas`` with a Service each,
    and the exact checks; 16d kubectl and 16e a federation on the cluster
    (``kubectl_steps``, ``federation_steps``); 16c ``cluster down``."""
    from kubernetes_tpu_torch import cluster as cl
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.selectors import LabelSelector
    from kubernetes_tpu_torch.api.types import Deployment, Service, ServicePort
    from kubernetes_tpu_torch.client.clientset import Clientset
    from kubernetes_tpu_torch.client.remote import RemoteStore
    from kubernetes_tpu_torch.dns.server import lookup
    from kubernetes_tpu_torch.proxy.hollow import digest
    from kubernetes_tpu_torch.workload import make_nodes, overcommitted_nodes

    env = {**os.environ, "PYTHONPATH": ROOT}
    port, dns_port, sched_port = free_port(), free_udp_port(), free_port()
    url = f"http://127.0.0.1:{port}"
    state_path = os.path.join(workdir, cl.STATE_FILE)
    logs = os.path.join(workdir, cl.CLUSTER_DIR, "logs")
    apps = [f"app-{i}" for i in range(10)]
    n_nodes = 2 * per_fleet + 2

    def run_cluster(*args: str, timeout: float = 400) -> subprocess.CompletedProcess:
        return subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cluster", *args],
                              cwd=workdir, env=env, capture_output=True, text=True,
                              timeout=timeout)

    def spawn(name: str, *args: str) -> subprocess.Popen:
        base = os.path.join(workdir, f"16-{name}")
        return subprocess.Popen([sys.executable, "-m", "kubernetes_tpu_torch", *args], cwd=workdir,
                                env=env, stdout=open(base + ".out", "w"),
                                stderr=open(base + ".err", "w"))

    out = {"steps": {}, "shape": f"{n_nodes} nodes (2 fleets x {per_fleet} with kube-proxies, "
                                 f"2 joined), 10 Deployments x {replicas}"}
    steps = out["steps"]
    procs: dict = {}
    times = None
    t_step = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    try:
        # -- 16a: turn-up ------------------------------------------------------
        init = run_cluster("init", "--port", str(port), "--dns-port", str(dns_port),
                           "--scheduler-healthz-port", str(sched_port), *init_args)
        step("init")
        out["init_s"] = steps["init"]
        if init.returncode != 0:
            raise RuntimeError(f"phase 16a: cluster init exited {init.returncode}: "
                               f"{init.stderr[-2000:]}")
        state = json.load(open(state_path))
        token = state["token"]
        out["init_line"] = init.stdout.splitlines()[0]
        bad = run_cluster("join", "--apiserver", url, "--token",
                          token.split(".")[0] + "." + "0" * 16, "--name", "evil")
        out["bad_join"] = {"rc": bad.returncode, "says": bad.stderr.strip().splitlines()[-1:],
                           "kubelet": "kubelet-evil" in json.load(open(state_path))["pids"]
                           or os.path.exists(os.path.join(logs, "kubelet-evil.log"))}
        for name in ("join-0", "join-1"):
            j = run_cluster("join", "--apiserver", url, "--token", token, "--name", name)
            if j.returncode != 0 or "discovery verified" not in j.stdout:
                raise RuntimeError(f"phase 16a: join {name} exited {j.returncode}: "
                                   f"{j.stderr[-2000:]}")
        step("joins")

        # -- 16b: a cluster of n_nodes under it ----------------------------------
        rs = RemoteStore(url, timeout=120.0)
        cs = Clientset(RemoteStore(url, timeout=120.0))
        health = {}
        for tag in ("pool-a", "pool-b"):
            health[tag] = f"http://127.0.0.1:{free_port()}"
            procs[tag] = spawn(tag, "kubelet", "--apiserver", url, "--count", str(per_fleet),
                               "--name", tag, "--proxy", "--serve-logs", "--healthz-port",
                               health[tag].rsplit(":", 1)[1])
        health["ccm"] = f"http://127.0.0.1:{free_port()}"
        procs["ccm"] = spawn("ccm", "cloud-controller-manager", "--apiserver", url,
                             "--leader-elect", "--healthz-port", health["ccm"].rsplit(":", 1)[1])

        def all_ready_nodes():
            for name, proc in procs.items():
                if proc.poll() is not None:
                    raise RuntimeError(f"phase 16b: {name} exited {proc.returncode}")
            nodes = rs.list("Node")[0]
            return len(nodes) == n_nodes and all(
                any(c.get("type") == "Ready" and c.get("status") == "True"
                    for c in (n.get("status") or {}).get("conditions") or []) for n in nodes)

        wait_for("phase 16b nodes Ready", all_ready_nodes, 300, every=0.5)
        step("register")
        # kubectl label and taint: the fleets' nodes take the zone and disk
        # labels and the taints of 14a's seeded cluster, node for node
        seeded = make_nodes(2 * per_fleet, random.Random(7), "mixed")
        for i, n in enumerate(seeded):
            name = f"pool-{'ab'[i // per_fleet]}-{i % per_fleet:05d}"
            labels = {k: v for k, v in n.meta.labels.items() if k != "kubernetes.io/hostname"}
            rs.patch("Node", "", name, {"metadata": {"labels": labels},
                                        "spec": {"taints": [x.to_dict() for x in n.spec.taints]}})
        out["tainted"] = sum(1 for n in seeded if n.spec.taints)
        step("label")
        pids = {"apiserver": state["pids"]["apiserver"], "scheduler": state["pids"]["scheduler"],
                "controller_manager": state["pids"]["controller-manager"],
                "kube_dns": state["pids"]["kube-dns"], "ccm": procs["ccm"].pid,
                "pool_a": procs["pool-a"].pid, "pool_b": procs["pool-b"].pid}
        cpu0 = {k: cpu_s(p) for k, p in pids.items()}
        metrics0 = request_counts(http_get(url + "/metrics").decode())
        _, rev = rs.list("Pod")
        times = PodTimes(rs, rev)
        t_phase = time.perf_counter()
        for i, (app, tpl) in enumerate(zip(apps, app_templates(len(apps)))):
            cs.services.create(Service(
                meta=ObjectMeta(name=app, namespace="default"), selector={"deployment": app},
                ports=[ServicePort(name="http", port=80, target_port=8080)],
                type="LoadBalancer" if i == 0 else "ClusterIP",
                cluster_ip="None" if i == len(apps) - 1 else ""))
            cs.deployments.create(Deployment(
                meta=ObjectMeta(name=app, namespace="default"), replicas=replicas,
                selector=LabelSelector.from_match_labels({"deployment": app}), template=tpl))

        def rolled_out():
            deps = [dp for dp in cs.deployments.list("default")[0] if dp.meta.name in apps]
            return len(deps) == len(apps) and all(dp.status_ready_replicas == replicas
                                                  for dp in deps)

        wait_for("phase 16b rollout", rolled_out, 300)
        with times.mu:
            keys = list(times.added)
        times.wait(keys, "running", 120, "phase 16b")
        with times.mu:
            created = sorted(times.added[k] for k in keys)
            out["running_pps"] = len(keys) / (max(times.running[k] for k in keys) - created[0])
            out["c2r_ms"] = quantiles_ms([times.running[k] - times.added[k] for k in keys])
            out["c2b_ms"] = quantiles_ms([times.bound[k] - times.added[k] for k in keys])
            out["rejected"] = dict(times.rejected)
        out["pods"] = len(keys)
        step("rollout")
        wait_for("phase 16b Endpoints", lambda: not endpoints_mismatch(rs, apps), 120, every=0.5)
        step("endpoints")

        services = sorted((s for s in cs.services.list("default")[0] if s.meta.name in apps),
                          key=lambda s: s.meta.name)
        pods = rs.list("Pod", "default")[0]
        dns_addr = ("127.0.0.1", dns_port)
        wait_for("phase 16b DNS", lambda: not dns_mismatch(dns_addr, services, pods, lookup)[0],
                 60, every=0.5)
        step("dns")
        out["dns_bad"], secs = dns_mismatch(dns_addr, services, pods, lookup)
        for _ in range(4):
            secs += dns_mismatch(dns_addr, services, pods, lookup)[1]
        out["dns_ms"] = quantiles_ms(secs)
        out["dns_lookups"] = len(secs)

        rows = want_rules(services, pods)
        want = {"hollow_proxy_proxiers": per_fleet, "hollow_proxy_rule_set_digest": digest(rows),
                "hollow_proxy_rule_sets_differing": 0,
                "hollow_proxy_rules": per_fleet * len(rows),
                "hollow_proxy_rule_endpoints": per_fleet * sum(len(r[5]) for r in rows)}
        out["rules_want"] = {"rules": len(rows), "endpoints": sum(len(r[5]) for r in rows)}

        def proxies_hold():
            got = {tag: metric_lines(health[tag], "hollow_") for tag in ("pool-a", "pool-b")}
            ok = all(all(m.get(k) == v for k, v in want.items()) for m in got.values())
            return got if ok else None

        try:
            out["proxy"] = wait_for("phase 16b proxies", proxies_hold, 60, every=0.5)
        except TimeoutError:
            out["proxy"] = {tag: metric_lines(health[tag], "hollow_") for tag in ("pool-a", "pool-b")}
            out["proxy_bad"] = True
        step("proxy")

        def cloud_holds():
            nodes = rs.list("Node")[0]
            cidrs = {n["metadata"]["name"]: n["spec"].get("podCIDR") for n in nodes
                     if (n.get("spec") or {}).get("podCIDR")}
            ready = [n for n in nodes if not (n.get("spec") or {}).get("unschedulable") and any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in (n.get("status") or {}).get("conditions") or [])]
            m = metric_lines(health["ccm"], "cloud_")
            lb = cs.services.get(apps[0], "default").status_load_balancer
            if (len(cidrs) == n_nodes and m.get("cloud_routes") == len(cidrs)
                    and m.get("cloud_load_balancer_nodes") == len(ready) and lb):
                return {"cidrs": cidrs, "ready": sorted(n["metadata"]["name"] for n in ready),
                        "ingress": lb, "metrics": m}
            return None

        out["cloud_want"] = wait_for("phase 16b cloud", cloud_holds, 120, every=0.5)
        step("cloud")
        t_end = time.perf_counter()
        out["wall_s"] = t_end - t_phase
        out["cpu_share"] = {k: (cpu_s(p) - cpu0[k]) / out["wall_s"] for k, p in pids.items()}
        metrics1 = request_counts(http_get(url + "/metrics").decode())
        out["requests"] = {k: v - metrics0.get(k, 0) for k, v in metrics1.items()
                           if v - metrics0.get(k, 0)}
        items = rs.list("Pod")[0]
        out["not_running"] = [p["metadata"]["name"] for p in items
                              if (p.get("status") or {}).get("phase") != "Running"]
        out["over"] = overcommitted_nodes(items, rs.list("Node")[0])
        out["ticks"] = {tag: metric_lines(health[tag], "hollow_") for tag in ("pool-a", "pool-b")}
        times.stop()
        times = None

        # -- 16d: kubectl on this cluster ------------------------------------------
        sched_url = f"http://127.0.0.1:{sched_port}"

        def launches() -> dict:  # the cluster's scheduler's, from its /metrics
            m = metric_lines(sched_url, "scheduler_kernel_launches_total")
            return {k: int(m[f'scheduler_kernel_launches_total{{kernel="{k}"}}'])
                    for k in ("fused_scan", "frontier_refresh")}

        kubectl = Cli("phase 16d", workdir, env, "kubectl", "--server", url)
        out["kubectl"] = kubectl_steps(kubectl, rs, n_nodes, launches)
        out["kubectl"]["walls"] = kubectl.walls
        step("kubectl")

        # -- 16e: a federation with this cluster as its member -----------------------
        fed_url = f"http://127.0.0.1:{free_port()}"
        procs["federation"] = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.federation", "--port",
             fed_url.rsplit(":", 1)[1], "--sync-interval", "0.5"], cwd=workdir, env=env,
            stdout=open(os.path.join(workdir, "16-federation.out"), "w"),
            stderr=open(os.path.join(workdir, "16-federation.err"), "w"))
        fed_kubectl = Cli("phase 16e", workdir, env, "kubectl", "--server", fed_url)
        kubefed = Cli("phase 16e", workdir, env, "kubefed", "--host", fed_url)
        out["federation"] = federation_steps(fed_kubectl, kubefed, procs["federation"], fed_url,
                                             url, rs, workdir, launches)
        out["federation"]["walls"] = fed_kubectl.walls + kubefed.walls
        step("federation")

        # -- 16c: teardown -------------------------------------------------------
        # the balancer over every Ready node again, the drained one uncordoned
        out["cloud_want"] = wait_for("phase 16c cloud", cloud_holds, 120, every=0.5)
        for name in ("ccm", "pool-a", "pool-b"):
            procs[name].send_signal(signal.SIGTERM)
        out["exit"] = {name: procs[name].wait(timeout=120) for name in ("ccm", "pool-a", "pool-b")}
        lines = [json.loads(ln)["cloud_controller_manager_stats"]
                 for ln in open(os.path.join(workdir, "16-ccm.out")).read().splitlines()
                 if ln.startswith('{"cloud_controller_manager_stats"')]
        if len(lines) != 1:
            raise AssertionError(f"phase 16c: {len(lines)} stats lines from the cloud controller "
                                 "manager")
        out["ccm"] = lines[0]
        step("stop")
        down = run_cluster("down")
        step("down")
        out["down_rc"] = down.returncode
        out["left_running"] = [name for name, pid in state["pids"].items() if cl.alive(pid)]
        state_after = json.load(open(state_path)) if os.path.exists(state_path) else None
        out["state_removed"] = state_after is None
        out["join_dirs_left"] = [d for d in state.get("join_dirs", []) if os.path.exists(d)]
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=2):
                out["port_closed"] = False
        except OSError:
            out["port_closed"] = True
        sched = [json.loads(ln)["scheduler_stats"]
                 for ln in open(os.path.join(logs, "scheduler.log")).read().splitlines()
                 if ln.startswith('{"scheduler_stats"')]
        if len(sched) != 1:
            raise AssertionError(f"phase 16c: {len(sched)} stats lines in the scheduler's log")
        out["stats"] = sched[0]
    finally:
        if times is not None:
            times.stop()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if os.path.exists(state_path):
            run_cluster("down")
    return out


def lifecycle_phase(pps_6a: float) -> tuple[int, int]:
    """Phase 16: a cluster as ``cluster init`` and ``join`` turn it up, 1000
    hollow nodes with kube-proxies, the DNS addon and the cloud controller
    manager.  Returns the scheduler's fused and refresh launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        try:
            r = lifecycle(workdir)
        except BaseException:
            for path in sorted(os.listdir(os.path.join(workdir, ".kubernetes-tpu-torch", "logs"))
                               if os.path.isdir(os.path.join(workdir, ".kubernetes-tpu-torch",
                                                             "logs")) else []):
                text = open(os.path.join(workdir, ".kubernetes-tpu-torch", "logs", path)).read()
                print(f"phase 16 {path} tail:\n{text[-3000:]}", file=sys.stderr)
            for name in ("16-pool-a.err", "16-pool-b.err", "16-ccm.err", "16-federation.err"):
                path = os.path.join(workdir, name)
                if os.path.exists(path):
                    print(f"phase 16 {name} tail:\n{open(path).read()[-3000:]}", file=sys.stderr)
            raise
    report_lifecycle(r, pps_6a, time.perf_counter() - t0)
    return r["stats"]["launches"], r["stats"]["refresh_launches"]


def report_lifecycle(r: dict, pps_6a: float, phase_s: float, device: str = "cuda") -> None:
    """Print phase 16's lines and hold its exact checks (the scheduler ran
    on ``device``)."""
    st, ccm = r["stats"], r["ccm"]
    cloud, want = ccm["cloud"], r["cloud_want"]
    (lb,) = cloud["balancers"].values() if len(cloud["balancers"]) == 1 else (None,)
    proxy = {tag: {k: int(m[f"hollow_proxy_{k}"]) for k in (
        "proxiers", "syncs_total", "rules", "rule_endpoints", "rule_sets_differing")}
             for tag, m in r["proxy"].items()}
    ticks = {tag: {"ticks": int(m["hollow_ticks_total"]),
                   "mean_s": round(m["hollow_tick_seconds_total"] / max(m["hollow_ticks_total"], 1),
                                   4),
                   "proxies_mean_s": round(m["hollow_proxy_tick_seconds_total"]
                                           / max(m["hollow_ticks_total"], 1), 4),
                   "max_s": round(m["hollow_tick_seconds_max"], 4)}
             for tag, m in r["ticks"].items()}
    print(f"phase 16 seconds by step {json.dumps({k: round(v, 3) for k, v in r['steps'].items()})}",
          flush=True)
    print(f"phase 16a cluster init at its defaults (the batch backend on {device}) exited 0 in "
          f"{r['init_s']:.3f} s ({r['init_line']}); a wrong token's join exited "
          f"{r['bad_join']['rc']} ({r['bad_join']['says']}), a kubelet started "
          f"{r['bad_join']['kubelet']}; join-0 and join-1 verified their discovery", flush=True)
    print(f"phase 16b {r['shape']}: {r['pods']} pods Running at {r['running_pps']:.1f} pods/s, "
          f"create_to_bind p50_ms {r['c2b_ms'][0]:.1f} p99_ms {r['c2b_ms'][1]:.1f}, "
          f"create_to_running p50_ms {r['c2r_ms'][0]:.1f} p99_ms {r['c2r_ms'][1]:.1f} (6a "
          f"{pps_6a:.1f} pods/s in this call)", flush=True)
    print(f"phase 16b DNS over UDP: {r['dns_lookups']} lookups, p50_ms {r['dns_ms'][0]:.3f} "
          f"p99_ms {r['dns_ms'][1]:.3f}, names differing {r['dns_bad']}", flush=True)
    print(f"phase 16b kube-proxies: want {r['rules_want']['rules']} rules holding "
          f"{r['rules_want']['endpoints']} endpoints a proxier; fleets "
          f"{json.dumps(proxy, sort_keys=True)}; ticks {json.dumps(ticks, sort_keys=True)}",
          flush=True)
    print(f"phase 16b cloud: app-0's ingress {want['ingress']}, its balancer "
          f"{lb['ingress_ip'] if lb else None} on {len(lb['nodes']) if lb else 0} nodes (Ready "
          f"{len(want['ready'])}), routes {len(cloud['routes'])} (podCIDRs "
          f"{len(want['cidrs'])}), cloud calls {cloud['calls']}; controllers "
          f"{json.dumps({k: v['syncs'] for k, v in ccm['controllers'].items()}, sort_keys=True)}",
          flush=True)
    print(f"phase 16 CPU over {r['wall_s']:.3f} s in cores "
          f"{json.dumps({k: round(v, 3) for k, v in r['cpu_share'].items()}, sort_keys=True)}; "
          f"apiserver requests {json.dumps(r['requests'], sort_keys=True)}", flush=True)
    for tag, r_cli, tool in (("16d", r["kubectl"], "python -m kubernetes_tpu_torch kubectl"),
                             ("16e", r["federation"], "python -m kubernetes_tpu_torch.federation "
                              "with kubefed and kubectl on it")):
        walls = quantiles_ms(r_cli["walls"])
        before, after = r_cli["launches_before"], r_cli["launches_after"]
        facts = (f"web's 50 pods on {r_cli['web_nodes']} nodes, Endpoints {r_cli['endpoints']}, "
                 f"pods bound {r_cli['bound']}, drained {r_cli['drain']}" if tag == "16d" else
                 f"fed-web's 50 pods Running on {r_cli['nodes']} nodes of the member, rolled up "
                 f"readyReplicas {r_cli['status'].get('readyReplicas')}, get-clusters "
                 f"{r_cli['clusters']}, the federation exited {r_cli['exit']} on SIGTERM")
        print(f"phase {tag} {tool} (one process a command): {len(r_cli['walls'])} invocations, "
              f"wall p50_ms {walls[0]:.1f} p99_ms {walls[1]:.1f}; seconds by step "
              f"{json.dumps({k: round(v, 3) for k, v in r_cli['steps'].items()})}; {facts}; "
              f"launches under cluster before {json.dumps(before, sort_keys=True)} after "
              f"{json.dumps(after, sort_keys=True)}", flush=True)
    print(f"phase 16c cluster down exited {r['down_rc']}: processes left running "
          f"{r['left_running']}, apiserver port closed {r['port_closed']}, state file removed "
          f"{r['state_removed']}; the scheduler's log: device {st['device']}, launches fused_scan "
          f"{st['launches']} frontier_refresh {st['refresh_launches']}, bound {st['bound']}",
          flush=True)
    print(f"phase 16 took {phase_s:.1f} s", flush=True)
    failures = {
        "bad join": None if r["bad_join"]["rc"] != 0 and not r["bad_join"]["kubelet"]
        else r["bad_join"],
        "rejections": len(r["rejected"]), "not Running": r["not_running"][:3],
        "over capacity": r["over"][:3], "DNS": r["dns_bad"][:3],
        "proxies": r.get("proxy_bad"),
        "balancer": None if lb and lb["nodes"] == want["ready"]
        and [lb["ingress_ip"]] == want["ingress"] else (lb or {}).get("ingress_ip"),
        "routes": None if cloud["routes"] == want["cidrs"] else len(cloud["routes"]),
        "exits": {k: v for k, v in r["exit"].items() if v} or None,
        "down": r["down_rc"] or None, "left running": r["left_running"],
        "port open": not r["port_closed"], "state file": not r["state_removed"],
        "join dirs": r["join_dirs_left"],
        "device": None if st["device"] == device else st["device"],
        "fused launches": None if st["launches"] > 0 else st["launches"],
        # the pods that kubectl and the federation made were bound by the card
        "16d launches": None if device != "cuda" or r["kubectl"]["launches_after"]["fused_scan"]
        > r["kubectl"]["launches_before"]["fused_scan"] else r["kubectl"]["launches_after"],
        "16e launches": None if device != "cuda" or r["federation"]["launches_after"][
            "fused_scan"] > r["federation"]["launches_before"]["fused_scan"]
        else r["federation"]["launches_after"],
        "federation exit": r["federation"]["exit"] or None,
    }
    failed = {k: v for k, v in failures.items() if v}
    if failed:
        raise AssertionError(f"phase 16: {failed}")


# -- phase 17: the node-axis mesh on the card ---------------------------------

MESH_REPLACES = "kubernetes_tpu/ops/batch_kernel.py:905"


def mesh_of(n: int):
    """A mesh of ``n`` shards, all on the card (the port's shards share one
    device)."""
    from kubernetes_tpu_torch.parallel import make_mesh

    return make_mesh(n, devices=["cuda"] * n)


def mesh_ring(s, st, n: int, reps: int, mesh=None) -> tuple:
    """The mesh kernel's plan for ``s`` in ``n`` shards (on ``mesh``, default
    ``mesh_of(n)``: one launch on the card) and ``reps`` prepared launches
    of the whole segment, each on its own packing and control words (the
    kernel updates the state planes in place)."""
    import torch

    from kubernetes_tpu_torch.ops import fused_scan, mesh_scan
    from kubernetes_tpu_torch.parallel import place_state, place_static

    mesh = mesh or mesh_of(n)
    statics, states = place_static(s, mesh), place_state(st, mesh)
    pl = mesh_scan.plan(statics, mesh.groups)
    ring = []
    for _ in range(reps):
        ctl = torch.zeros(fused_scan.CTL_WORDS, dtype=torch.int32, device=statics[0].device)
        ctl[fused_scan.CTL_RR] = st.round_robin
        bufs = mesh_scan.pack(statics, states, pl, mesh.groups, ctl)
        ring.append(lambda b=bufs, c=ctl: mesh_scan.launch(b, pl, 0, s.p_real, c))
    return pl, ring, mesh_scan.clusters(pl)


def mesh_bound(s, st, pl) -> tuple[float, str, dict]:
    """Least time for the sharded scan, whatever implements it: row 1's
    (``bound``: the packed inputs read once, the outputs written once, the
    pods' integer operations) plus what any sharded design must exchange a
    pod, each shard's statistics (7 int64 and an int64 a zone), best
    (int64), tie count (int32) and tie words (a bit a column of the shard),
    written once and read once by each of the other shards."""
    _, _, detail = bound(s, st)
    msg = 8 * (7 + int(s.num_zones)) + 8 + 4 + 4 * -(-pl.n_local // 32)
    exchange = pl.shards * pl.shards * msg * s.p_real
    nbytes = detail["bytes"] + exchange
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = detail["ops"] / ALU_OPS_PER_S * 1e3
    out = {"bytes": nbytes, "exchange_bytes": exchange, "ops": detail["ops"]}
    return (t_bytes, "bytes", out) if t_bytes >= t_ops else (t_ops, "operations", out)


def sharded_cell(what: str, s, st, want, rr_want: int, n: int, card: str) -> dict:
    """``schedule_batch_sharded`` of a segment in ``n`` shards on the card,
    its launches counted around it, held pod for pod and in rr against the
    fused scan's ``want``; then its device time over two prepared launches
    (``device_ms``) and its bound.  Raises on a difference."""
    import torch

    from kubernetes_tpu_torch.ops import mesh_scan
    from kubernetes_tpu_torch.parallel import schedule_batch_sharded

    torch.cuda.synchronize()
    mesh_scan.launches = 0
    got, rr = schedule_batch_sharded(s, st, mesh_of(n))
    launches = mesh_scan.launches
    err = int(abs(got.astype("int64") - want.astype("int64")).max())
    if err or rr != rr_want or launches != 1:
        raise AssertionError(f"phase 17a {what} in {n} shards != fused_scan.cu: max index diff "
                             f"{err}, rr {rr} vs {rr_want}, launches {launches}")
    pl, ring, resident = mesh_ring(s, st, n, 2)
    ms = device_ms(ring)[0]
    b_ms, b_by, detail = mesh_bound(s, st, pl)
    print(f"phase 17a {what} ({s.n_pad} nodes x {s.p_real} pods) in {n} shards on one card "
          f"through schedule_batch_sharded: == fused_scan.cu pod for pod (all {s.p_real}) and "
          f"in rr {rr}; plan {pl.shards} clusters x {pl.cs} blocks (cs) of {pl.threads} threads, "
          f"{pl.cols} columns a block, {pl.cpt} a thread (cpt), planes in shared memory "
          f"{list(pl.shared)}, in global memory {list(pl.global_)}, zones_at {pl.zones_at} "
          f"({resident} clusters of it resident at most); device_ms "
          f"{ms:.3f} = {ms * 1e3 / s.p_real:.2f} us a pod; bound {b_ms:.4f} ms by {b_by} "
          f"({detail['bytes']} bytes, {detail['exchange_bytes']} of them the exchanges, "
          f"{detail['ops']} ops); card {card}", flush=True)
    return {"ms": ms, "us_per_pod": ms * 1e3 / s.p_real, "bound_ms": b_ms, "bound_by": b_by,
            "nodes": int(s.n_pad), "pods": int(s.p_real), "shards": n, "cs": pl.cs,
            "cpt": pl.cpt, "grid": pl.grid, "zones_at": pl.zones_at, "launches": launches,
            "max_abs_err": err}


def first_pods(s, k: int):
    """Segment ``s`` cut to its first ``k`` pods (its per-pod tables; a
    prefix of the sequential scan is a segment of its own)."""
    import dataclasses

    return dataclasses.replace(s, **{f: getattr(s, f)[:k].contiguous() for f in (
        "group_of_pod", "pod_vol_ids", "pod_vol_valid", "pod_vol_ro_ok", "pod_vol_kind",
        "pod_vol_count_only")})


def plain_shards(s, st, n: int) -> tuple:
    """The plain sharded step (``scan_ref.scan_shards``) on the card in
    ``n`` shards: chosen (numpy), rr and its ms."""
    from kubernetes_tpu_torch.ops import scan_ref
    from kubernetes_tpu_torch.parallel import place_state, place_static

    statics, states = place_static(s, mesh_of(n)), place_state(st, mesh_of(n))
    (want, finals), ms = timed_on_card(lambda: scan_ref.scan_shards(statics, states))
    return want.cpu().numpy(), finals[0].round_robin, ms


def mesh_plain_cell(what: str, s, st, n: int, check=None, layout=None,
                    plain: tuple = None) -> dict:
    """The mesh kernel against its plain version (``scan_ref.scan_shards``)
    on the card, on the same shards (``plain``: its ``plain_shards``
    result, made before); ``check(chosen)`` adds a condition,
    ``layout(plan)`` one on the plan's placement.  Returns the plain ms
    (CUDA events around it) and the kernel's device ms."""
    from kubernetes_tpu_torch.ops import mesh_scan
    from kubernetes_tpu_torch.parallel import place_state, place_static

    statics, states = place_static(s, mesh_of(n)), place_state(st, mesh_of(n))
    got, rr = mesh_scan.schedule(statics, states)
    want, rr_want, plain_ms = plain if plain is not None else plain_shards(s, st, n)
    err = int(abs(got.astype("int64") - want.astype("int64")).max()) if len(want) else 0
    pl, ring, _ = mesh_ring(s, st, n, 2)
    if err or rr != rr_want or (check is not None and not check(got)) \
            or (layout is not None and not layout(pl)):
        raise AssertionError(f"phase 17b {what}: mesh_scan.cu != scan_ref.scan_shards in {n} "
                             f"shards: max index diff {err}, rr {rr} vs {rr_want}, plan {pl}")
    ms = device_ms(ring)[0]
    print(f"phase 17b {what} in {n} shards: mesh_scan.cu == scan_ref.scan_shards (the plain "
          f"sharded step) on the card, bound {int((want >= 0).sum())}/{len(want)}, rr {rr}; "
          f"plan cs {pl.cs}, cpt {pl.cpt}, {len(pl.global_)} planes in global memory, zones_at "
          f"{pl.zones_at}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "nodes": int(s.n_pad), "pods": int(s.p_real),
            "shards": n, "max_abs_err": err}


def tie_fixture() -> tuple:
    """17b's tie fixture: 40 identical nodes with staggered pod caps (every
    score ties, columns die one after another) and 300 pods, tensorized
    and seeded for the frontier loop (host arrays)."""
    from kubernetes_tpu_torch.models.snapshot import Tensorizer, frontier_seed
    from kubernetes_tpu_torch.scheduler.nodeinfo import NodeInfo
    from kubernetes_tpu_torch.scheduler.priorities import PriorityContext
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    m = {}
    for i in range(40):
        node = make_node(f"node-{i:03d}", cpu="64", memory="64Gi", pods=2 + i // 2,
                         labels={"kubernetes.io/hostname": f"node-{i:03d}"})
        m[node.meta.name] = NodeInfo(node)
    pods = [make_pod(f"p-{i:03d}", cpu="100m", memory="128Mi", labels={"app": "web"})
            for i in range(300)]
    pctx = PriorityContext(m)
    tz = Tensorizer()
    static = tz.build_static(pods, m, pctx)
    init = tz.initial_state(static, m, pctx, pods)
    frontier_seed(static, init)
    return static, init


def mesh_tie_loops() -> tuple[int, int]:
    """17b's tie fixture through ``FrontierRun(mesh=)`` in 2, 4 and 8
    shards, on the card (a mesh launch a chunk, a refresh a shard) and on
    the CPU (the plain sharded step): bindings, rr and every loop stat
    equal, at least one compaction.  Returns the card's mesh and refresh
    launches."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import pad_segment_to_multiple
    from kubernetes_tpu_torch.ops import frontier_refresh, mesh_scan
    from kubernetes_tpu_torch.ops.frontier import FrontierRun
    from kubernetes_tpu_torch.parallel import make_mesh

    static, init = tie_fixture()
    launches = refreshes = 0
    for n in (2, 4, 8):
        ps, pi = pad_segment_to_multiple(static, init, n)
        runs = {}
        for dev in ("cpu", "cuda"):
            mesh_scan.launches = frontier_refresh.launches = 0
            run = FrontierRun(*from_reference(vars(ps), vars(pi), dev), chunk_len=16,
                              min_width=8, mesh=make_mesh(n, devices=[dev] * n))
            runs[dev] = run.finalize(), run.stats
        launches += mesh_scan.launches
        refreshes += frontier_refresh.launches
        (c_cpu, rr_cpu), st_cpu = runs["cpu"]
        (c_gpu, rr_gpu), st_gpu = runs["cuda"]
        if (c_gpu != c_cpu).any() or rr_gpu != rr_cpu or st_gpu != st_cpu \
                or st_gpu["compactions"] < 1:
            raise AssertionError(f"phase 17b the tie fixture in {n} shards: card != plain "
                                 f"(rr {rr_gpu} vs {rr_cpu}), stats {st_gpu} vs {st_cpu}")
        print(f"phase 17b tie fixture 40 x 300 (staggered caps, every score tied) in {n} "
              f"shards, FrontierRun(mesh=) on the card == on the CPU: rr {rr_gpu}, widths "
              f"{st_gpu['widths']}, compactions {st_gpu['compactions']}, host_syncs "
              f"{st_gpu['host_syncs']}, shard alive fractions at the loop exits "
              f"{st_gpu['shard_alive_frac']}", flush=True)
    return launches, refreshes


MESH_CHURN = {"n_nodes": 5000, "total_pods": 4000, "waves": 4, "seed": 0}


def mesh_churn(pool) -> dict:
    """Phase 17c's run: ``BatchBackend(frontier_mesh=True, mesh_devices=4)``
    under the scheduler's churn at 5000 nodes (5a's generator), 4 waves of
    1000 pods, every kernel's launch count read around it.  Every
    segment must run in mesh mode on 4 shards, within compactions + 2 host
    syncs, with the per-shard upload fractions and the three mesh gauges
    set.  Its per-wave oracle replay is submitted to ``pool`` (a process
    of its own, which outlives the phases after); ``mesh_churn_parity``
    checks it."""
    from kubernetes_tpu_torch.ops import frontier_refresh, fused_scan, mesh_scan
    from kubernetes_tpu_torch.workload import oracle_replay_waves, run_churn

    c = MESH_CHURN
    fused_scan.launches = frontier_refresh.launches = mesh_scan.launches = 0
    with frontier_runs() as runs:
        r = run_churn(c["n_nodes"], c["total_pods"], c["waves"], "mixed", seed=c["seed"],
                      device="cuda", backend_kw=dict(frontier_mesh=True, mesh_devices=4))
    budget = sync_budget(runs)
    launches = {"mesh_scan": mesh_scan.launches, "frontier_refresh": frontier_refresh.launches,
                "fused_scan": fused_scan.launches}
    st = r["backend"]
    for w, ph in enumerate(r["phase_timers"]):
        segs = [{k: seg[k] for k in ("mode", "n_shards", "widths", "compactions",
                                     "host_syncs")} for seg in ph["frontier"]]
        print(f"phase 17c wave {w}: bound {ph['bound']} kernel_ms {ph['kernel_ms']:.3f} "
              f"segments {segs} per-shard {json.dumps(ph['mesh'], sort_keys=True)}", flush=True)
        bad = [seg for seg in ph["frontier"]
               if seg["mode"] != "mesh" or seg["n_shards"] != 4
               or seg["host_syncs"] > seg["compactions"] + 2]
        if not ph["frontier"] or bad or not (ph["mesh"] or {}).get("shard_upload_fractions"):
            raise AssertionError(f"phase 17c wave {w}: not every segment ran on the 4-shard "
                                 f"mesh within its sync budget: {ph['frontier']} {ph['mesh']}")
    gauges = r["mesh_gauges"]
    print(f"phase 17c churn {c['n_nodes']}x{c['total_pods']} mixed in {c['waves']} waves on "
          f"BatchBackend(frontier_mesh=True, mesh_devices=4): bound {r['bound']} unbound "
          f"{r['unbound']} wall_s {r['wall_s']:.3f} pods_per_s {r['pods_per_sec']:.1f} "
          f"launches {json.dumps(launches)} kernel_ms {st['kernel_ms']:.3f} host_syncs "
          f"{st['host_syncs']} (static budget {budget} over {len(runs)} frontier runs, "
          f"{sum(x['loop_runs'] for x in runs)} loop runs) compactions "
          f"{st['frontier_compactions']}; gauges "
          f"{json.dumps(gauges, sort_keys=True)}; the oracle replay runs on in a process of "
          f"its own", flush=True)
    if (launches["mesh_scan"] < c["waves"] or launches["frontier_refresh"] < 4 * c["waves"]
            or st["oracle_pods"] != 0 or st["kernel_pods"] != r["drained"]
            or gauges["scheduler_mesh_shards"] != 4
            or r["bound"] + r["unbound"] != r["pods"]
            or not runs or st["host_syncs"] > budget):
        raise AssertionError(f"phase 17c: launches {launches}, stats {st}, gauges {gauges}")
    oracle = pool.submit(oracle_replay_waves, r["drain_batches"], r["assignments"],
                         c["n_nodes"], c["total_pods"], "mixed", c["seed"])
    return {"launches": launches, "oracle": oracle, "pods": r["pods"],
            "round_robin": r["round_robin"], "drain_rr": r["drain_rr"]}


def mesh_churn_parity(r: dict) -> None:
    """17c's bindings against the per-pod oracle's replay, wave by wave,
    and its counter as each drained batch started and at the end."""
    t = time.perf_counter()
    o = r["oracle"].result()
    print(f"phase 17c vs the per-wave oracle replay: {o['mode']}, checked {o['checked']}, "
          f"mismatches {o['mismatches']}, rr {r['round_robin']} vs {o['round_robin']}, rr at "
          f"each batch's start equal {o['round_robin_before'] == r['drain_rr']} (waited "
          f"{time.perf_counter() - t:.1f} s for it)", flush=True)
    if (o["mode"] != "exact per-wave replay" or o["checked"] != r["pods"] or o["mismatches"]
            or o["round_robin"] != r["round_robin"]
            or o["round_robin_before"] != r["drain_rr"]):
        raise AssertionError(f"phase 17c: the mesh churn != the per-wave oracle replay: {o}")


def mesh_phase(main: tuple, wide: tuple, churn: dict, card: str) -> dict:
    """Phase 17: (a) the main segment (phase 4's, with the fused scan's
    result) through ``schedule_batch_sharded`` in 2 and 4 shards and the
    20 000 x 500 segment in 4, each equal to the fused scan; (b) the mesh
    kernel against its plain version at 1000 x 256 in 4 shards, on an
    uneven width padded, and on the tie fixture's loops in 2, 4 and 8
    shards; (c) the check of 17c's run against its oracle.  Returns the
    kernel table's entry for ``mesh_scan`` and the refresh's launches."""
    s_main, st_main, whole, rr_whole = main
    cells = {f"main_{n}": sharded_cell("main segment", s_main, st_main, whole, rr_whole, n, card)
             for n in (2, 4)}
    s_w, st_w, chosen_w, rr_w = wide
    cells["wide_4"] = sharded_cell("mixed 20000x500", s_w, st_w, chosen_w, rr_w, 4, card)
    # the plain sharded step (~14 ms a pod on the card) of these two ran
    # while the kernels built
    s, st, ahead = PRE.pop("mesh_1000x256")
    cells["mixed_1000x256_4"] = plain = mesh_plain_cell("mixed 1000x256", s, st, 4,
                                                         plain=ahead)
    s, st, ahead = PRE.pop("mesh_uneven")
    if s.n_pad != 1004:
        raise AssertionError(f"phase 17b: the uneven segment padded to {s.n_pad}, not 1004")
    cells["uneven_1003x128_4"] = mesh_plain_cell(
        "uneven 1003x128 (padded to 1004)", s, st, 4, check=lambda c: not (c >= 1003).any(),
        plain=ahead)
    # planes the planner leaves partly in global memory: the 20 000 x 500
    # segment (20 096 columns) in 2 shards, its first 16 pods; and a zone
    # count past what shared memory holds (the plain step takes ~0.3 s a
    # pod at 5000 zones: 4 pods)
    cells["planes_global_20096x16_2"] = mesh_plain_cell(
        "mixed 20096x16 (20000x500's first 16 pods; planes partly in global memory)",
        first_pods(s_w, 16), st_w, 2, layout=lambda pl: bool(pl.global_) and bool(pl.shared))
    m, pods, pctx = cluster(5000, 4, "mixed", seed=4, zones=5000)
    _, s, st = segment(m, pods, pctx, "cuda", shards=4)
    cells["zones_5000_5120x4_4"] = mesh_plain_cell(
        "mixed 5120x4 in 5000 zones (zone totals in global memory)", s, st, 4,
        layout=lambda pl: pl.zones_at == "global")
    tie_launches, tie_refresh = mesh_tie_loops()
    mesh_churn_parity(churn)
    sharded = sum(c["launches"] for c in cells.values() if "launches" in c)
    main4 = cells["main_4"]
    return {
        "name": "mesh_scan", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/mesh_scan.cu", "replaces": MESH_REPLACES,
        "launches": sharded + churn["launches"]["mesh_scan"],
        "launches_by_path": {"sharded": sharded, "churn_mesh": churn["launches"]["mesh_scan"]},
        "cells": cells, "tie_loop_launches": tie_launches,
        "max_abs_err": max(c["max_abs_err"] for c in cells.values()),
        "ms": main4["ms"], "us_per_pod": main4["us_per_pod"],
        # the plain sharded step's time at 17b's 1000 x 256 in 4 shards, the
        # kernel's there beside it
        "plain_ms": plain["plain_ms"], "plain_pods": plain["pods"], "plain_kernel_ms": plain["ms"],
        "bound_ms": main4["bound_ms"], "bound_by": main4["bound_by"],
        "library_ms": None,
    }, churn["launches"]["frontier_refresh"], tie_refresh


def grouped_segment(what: str, s, st, want, rr_want: int, mesh, card: str) -> dict:
    """17d (a): ``s`` through ``schedule_batch_sharded`` on ``mesh`` (shards
    in several launches), its launches counted around it, equal pod for
    pod and in rr to ``want`` (the fused scan's) and to the single launch
    of as many shards; then both timed in turns, three pairs of
    ``device_ms`` over two prepared launches each, with each launch's
    registers and spills."""
    import torch

    from kubernetes_tpu_torch.ops import mesh_scan
    from kubernetes_tpu_torch.parallel import schedule_batch_sharded

    n = mesh.size
    torch.cuda.synchronize()
    mesh_scan.launches = mesh_scan.launches_grouped = 0
    got, rr = schedule_batch_sharded(s, st, mesh)
    launches, grouped = mesh_scan.launches, mesh_scan.launches_grouped
    single, rr_single = schedule_batch_sharded(s, st, mesh_of(n))
    err = int(max(abs(got.astype("int64") - want.astype("int64")).max(),
                  abs(got.astype("int64") - single.astype("int64")).max()))
    if err or rr != rr_want or rr_single != rr_want or launches != len(mesh.groups) \
            or grouped != launches:
        raise AssertionError(f"phase 17d {what} in {mesh.groups}: != the single launch or "
                             f"fused_scan.cu: max index diff {err}, rr {rr} / {rr_single} vs "
                             f"{rr_want}, launches {launches} (grouped {grouped})")
    rings = {"single": mesh_ring(s, st, n, 2), "grouped": mesh_ring(s, st, n, 2, mesh)}
    ms = {"single": [], "grouped": []}
    for k in ("single", "grouped", "grouped", "single", "single", "grouped"):  # in turns
        ms[k].append(device_ms(rings[k][1])[0])
    pl = rings["grouped"][0]
    attrs = mesh_scan.attrs(pl)
    ratio = sum(ms["grouped"]) / sum(ms["single"])
    print(f"phase 17d {what} ({s.n_pad} nodes x {s.p_real} pods) in {n} shards as launches "
          f"{[list(g) for g in mesh.groups]} on {[str(d) for d in mesh.devices]}: == the single "
          f"launch of {n} and == fused_scan.cu pod for pod (all {s.p_real}) and in rr {rr}; "
          f"{launches} launches, each {pl.shards // len(mesh.groups)} clusters x {pl.cs} "
          f"blocks of {pl.threads} threads (cpt {pl.cpt}), registers {attrs['regs']} a thread, "
          f"local memory (spills) {attrs['local_bytes']} bytes, static shared "
          f"{attrs['static_smem']} bytes (each launch runs this one kernel); in turns device_ms "
          f"grouped {ms['grouped']} single {ms['single']}: ratio of the means grouped/single "
          f"{ratio:.4f}, {sum(ms['grouped']) / 3 * 1e3 / s.p_real:.3f} vs "
          f"{sum(ms['single']) / 3 * 1e3 / s.p_real:.3f} us a pod; card {card}", flush=True)
    return {"ms": sum(ms["grouped"]) / 3, "ms_turns": ms["grouped"],
            "single_ms_turns": ms["single"], "ratio": ratio, "launches": launches,
            "groups": [list(g) for g in mesh.groups], "max_abs_err": err, **attrs}


def grouped_ties(card: str) -> int:
    """17d (b): the tie fixture in 2 and 4 launches of one shard each (on
    the card), the whole segment against ``scan_ref.scan_shards`` on the
    same shards.  Returns the launches."""
    from kubernetes_tpu_torch.models.carry import from_reference
    from kubernetes_tpu_torch.models.snapshot import pad_segment_to_multiple
    from kubernetes_tpu_torch.ops import mesh_scan, scan_ref
    from kubernetes_tpu_torch.parallel import make_mesh, place_state, place_static

    static, init = tie_fixture()
    launches = 0
    for n in (2, 4):
        ps, pi = pad_segment_to_multiple(static, init, n)
        s, st = from_reference(vars(ps), vars(pi), "cuda")
        mesh = make_mesh(n, devices=["cuda"] * n, launches=n)
        statics, states = place_static(s, mesh), place_state(st, mesh)
        mesh_scan.launches = 0
        got, rr = mesh_scan.schedule(statics, states, mesh.groups)
        launches += mesh_scan.launches
        want, finals = scan_ref.scan_shards(statics, states)
        want = want.cpu().numpy()
        if (got != want).any() or rr != finals[0].round_robin or mesh_scan.launches != n:
            raise AssertionError(f"phase 17d the tie fixture in {n} launches: mesh_scan.cu != "
                                 f"scan_ref.scan_shards (rr {rr} vs {finals[0].round_robin})")
        print(f"phase 17d tie fixture 40 x 300 in {n} launches of one shard on the card: "
              f"mesh_scan.cu == scan_ref.scan_shards, bound {int((got >= 0).sum())}/{len(got)}, "
              f"rr {rr}, {mesh_scan.launches} launches", flush=True)
    return launches


def grouped_pool_loop(pool: tuple, mesh, card: str) -> dict:
    """17d (c): ``FrontierRun(mesh=)`` on phase 10's pool (1024 nodes, 6000
    pods, default frontier settings) on ``mesh`` (shards in several
    launches) and on the single launch of as many shards: bindings,
    counter, widths and compactions equal, at least one compaction, each
    run within the static host-sync budget.  The grouped run's launches
    are counted around it."""
    import torch

    from kubernetes_tpu_torch.ops import frontier_refresh, mesh_scan
    from kubernetes_tpu_torch.ops.frontier import FrontierRun

    s, st = pool
    out = {}
    for name, m in (("single", mesh_of(mesh.size)), ("grouped", mesh)):
        torch.cuda.synchronize()
        mesh_scan.launches = mesh_scan.launches_grouped = frontier_refresh.launches = 0
        with frontier_runs() as runs:
            run = FrontierRun(s, st, mesh=m)
            chosen, rr = run.finalize()
        out[name] = {"chosen": chosen, "rr": rr, "stats": dict(run.stats),
                     "budget": sync_budget(runs), "kernel_ms": run.kernel_ms,
                     "launches": mesh_scan.launches, "grouped": mesh_scan.launches_grouped,
                     "refreshes": frontier_refresh.launches}
    a, b = out["single"], out["grouped"]
    keys = ("widths", "compactions", "chunks", "host_syncs", "loop_runs")
    if ((a["chosen"] != b["chosen"]).any() or a["rr"] != b["rr"]
            or any(a["stats"][k] != b["stats"][k] for k in keys)
            or b["stats"]["compactions"] < 1 or b["stats"]["host_syncs"] > b["budget"]
            or b["grouped"] != b["launches"] or b["launches"] != len(mesh.groups) * a["launches"]):
        raise AssertionError(f"phase 17d the pool loop on {mesh.groups}: != the single "
                             f"launch's loop: {({k: b['stats'][k] for k in keys})} vs "
                             f"{({k: a['stats'][k] for k in keys})}, rr {b['rr']} vs {a['rr']}, "
                             f"launches {b['launches']}/{a['launches']}, budget {b['budget']}")
    print(f"phase 17d FrontierRun(mesh=) on phase 10's pool ({s.n_pad} nodes x {s.p_real} "
          f"pods) in {mesh.size} shards as launches {[list(g) for g in mesh.groups]} on "
          f"{[str(d) for d in mesh.devices]}: == the single launch's loop, bound "
          f"{int((b['chosen'] >= 0).sum())}/{s.p_real}, rr {b['rr']}, widths "
          f"{b['stats']['widths']}, compactions {b['stats']['compactions']}, host_syncs "
          f"{b['stats']['host_syncs']} (static budget {b['budget']}); kernel_ms grouped "
          f"{b['kernel_ms']:.3f} single {a['kernel_ms']:.3f}; launches mesh {b['launches']} "
          f"(grouped {b['grouped']}) refresh {b['refreshes']}; card {card}", flush=True)
    return {"launches": b["launches"], "refreshes": b["refreshes"], "kernel_ms": b["kernel_ms"],
            "single_kernel_ms": a["kernel_ms"]}


def grouped_phase(main: tuple, card: str) -> dict:
    """Phase 17d: the mesh in several launches.  (a) phase 4's main segment
    in 4 shards as 2 launches of 2 on the card, (b) the tie fixture in 2
    and 4 launches, (c) the pool loop in 2 launches; (d) with two cards or
    more, (a) and (c) again with a launch a card.  Returns the cells and
    the launches by path."""
    import torch

    from kubernetes_tpu_torch.parallel import make_mesh

    s_main, st_main, whole, rr_whole = main
    m, pods, pctx = pool_cluster()
    pool = segment(m, pods, pctx, "cuda", frontier=True, shards=4)[1:3]
    two = make_mesh(4, devices=["cuda"] * 4, launches=2)
    cells = {"main_4_in_2": grouped_segment("main segment", s_main, st_main, whole, rr_whole,
                                            two, card)}
    ties = grouped_ties(card)
    loops = {"pool_4_in_2": grouped_pool_loop(pool, two, card)}
    cards = torch.cuda.device_count()
    if cards >= 2:
        spread = make_mesh(4)
        cells["main_4_cards"] = grouped_segment("main segment", s_main, st_main, whole,
                                                rr_whole, spread, card)
        loops["pool_4_cards"] = grouped_pool_loop(pool, spread, card)
    else:
        print(f"phase 17d: this run had one card ({torch.cuda.get_device_name(0)}), so the "
              "several-card placement ran as two launches on one card (streams of their own, "
              "mailboxes across launches at system scope); peer access between cards and "
              "NVLink's latency were not exercised", flush=True)
    return {"cells": cells, "loops": loops, "tie_launches": ties,
            "launches": (sum(c["launches"] for c in cells.values())
                         + sum(c["launches"] for c in loops.values()) + ties),
            "refreshes": sum(c["refreshes"] for c in loops.values())}


# made while the kernels build (``plain_ahead``): segments on the card and
# their plain versions' results, by key
PRE: dict = {}


def plain_ahead() -> None:
    """While nvcc builds the kernels, which the plain versions do not
    need: phase 3's two 1000-node segments, phase 4's main segment (with
    its cluster) and its three others, phase 10's pool (with its cluster)
    and 17b's first two mesh segments, carried to the card, and the plain
    version of each (of the main segment its first window; the mesh
    segments' in 4 shards), timed there by CUDA events while nvcc runs on
    other cores."""
    for workload in ("mixed", "plain"):
        _, s, st = segment(*cluster(1000, SHAPE_PODS, workload, seed=1), "cuda")
        PRE[("phase 3", workload)] = (s, st, plain_scan(s, st))
    m, pods, pctx = cluster(5000, 20000, "mixed", seed=0)
    static, s, st, full = segment(m, pods, pctx, "cuda", full_width=True)
    PRE["main"] = (m, pods, pctx, static, s, st, plain_range(s, st, 0, MAIN_WINDOW), full,
                   plain_range(*full, 0, MAIN_WINDOW))
    for n_nodes, n_pods, seed in OTHER_SEGMENTS:
        _, s, st = segment(*cluster(n_nodes, n_pods, "mixed", seed=seed), "cuda")
        PRE[("segment", n_nodes)] = (s, st, plain_scan(s, st))
    m, pods, pctx = pool_cluster()
    static, s, st = segment(m, pods, pctx, "cuda")
    PRE["pool"] = (m, pods, pctx, static, s, st, plain_scan(s, st))
    _, s, st = segment(*cluster(1000, 256, "mixed", seed=1), "cuda")
    PRE["mesh_1000x256"] = (s, st, plain_shards(s, st, 4))
    _, s, st = segment(*cluster(1003, 128, "mixed", seed=2), "cuda", pad_multiple=1, shards=4)
    PRE["mesh_uneven"] = (s, st, plain_shards(s, st, 4))


def use_bytecode_cache() -> None:
    """Compile each module once for the whole run: this interpreter and
    every process it starts write and read bytecode under the checkout's
    ``_pycache/``.  An environment that forbids bytecode
    (``PYTHONDONTWRITEBYTECODE``) otherwise has each new process compile
    torch from source, seconds of every daemon's start, and the run starts
    some 40 such processes."""
    cache = os.path.join(ROOT, "_pycache")
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    use_bytecode_cache()
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.ops import _build, frontier_refresh, fused_scan, mesh_scan
    from kubernetes_tpu_torch.ops.backend import BatchBackend
    from kubernetes_tpu_torch.scheduler.generic_scheduler import GenericScheduler

    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]
    spared: set = set()  # 17c's oracle worker, which outlives the phases after it

    def lap(name: str) -> None:  # the seconds since the last lap, by phase
        left = stop_own_processes(keep=spared)
        if left:
            print(f"phase {name} left running (stopped): {json.dumps(left)}", flush=True)
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
        print(f"phase {name} lap {laps[name]} s, {now - t_start:.1f} s into the run", flush=True)

    card = card_line()
    print(f"phase 1 card: {card}", flush=True)

    t0 = time.perf_counter()
    built = {}

    def build(name: str) -> None:
        # prints ptxas registers and spills
        if name == K_NAME:
            fused_scan.build(SUPERSTEP_K, verbose=True)
        else:
            _build.build(name, verbose=True)
        built[name] = time.perf_counter() - t0

    kernels = ("fused_scan", "frontier_refresh", "mesh_scan", K_NAME)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc a build, started together
        building = pool.map(build, kernels)
        plain_ahead()
        ahead_s = time.perf_counter() - t0
        list(building)
    fused_scan.load()
    fused_scan.load(SUPERSTEP_K)
    frontier_refresh.load()
    mesh_scan.load()
    print(f"phase 2 build: " + ", ".join(f"{k} {built[k]:.1f}s" for k in kernels)
          + f", all {time.perf_counter() - t0:.1f}s; beside it the segments and plain "
          f"versions of phases 3, 4, 10 and 17b ahead of their kernels {ahead_s:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    helpers = native.helpers()
    print(f"phase 2 host helpers: matcher {helpers['matcher']}, fastcopy {helpers['fastcopy']} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    # -- phase 3: kernel vs plain on the card; oracle vs backend ----------
    for workload in ("mixed", "plain"):
        s, st, plain = PRE.pop(("phase 3", workload))
        r = compare(s, st, plain)
        print(f"phase 3 {workload} 1000x{SHAPE_PODS}: kernel == scan_ref, bound {r['bound']}/"
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

    lap("1-3")
    # -- phase 4: the main path at full width ------------------------------
    m, pods, pctx, main_static, s_main, st_main, head, full_main, head_full = PRE.pop("main")
    r_sel = None if main_static.r_sel is None else [int(r) for r in main_static.r_sel]
    r_dev = int(s_main.node_alloc.shape[1])
    print(f"phase 4 main segment r_sel {r_sel}, the kernel launched with R = {r_dev} "
          f"(host arrays {main_static.node_alloc.shape[1]} wide)", flush=True)
    if r_sel != [0, 1] or r_dev != 2:
        raise AssertionError(f"phase 4: r_sel {r_sel}, R {r_dev}; want [0, 1] and 2")
    runs = []
    for frontier in (False, True, True, False):  # in turns
        runs.append(batch_run(m, pods, pctx, frontier))
    main = next(r for r in runs if r["frontier"])  # the default route: the main path
    launches, refresh_launches = main["launches"], main["refresh_launches"]
    walls = {f: [r["wall"] for r in runs if r["frontier"] == f] for f in (True, False)}
    print(f"phase 4 frontier on/off in turns: walls on {walls[True]} off {walls[False]}, "
          f"ratio of the means on/off {sum(walls[True]) / sum(walls[False]):.4f}; card {card}",
          flush=True)

    # the main path's segment: the four BatchBackend runs against one whole
    # launch, and that launch against the plain version on two windows
    from kubernetes_tpu_torch.ops import fused_scan

    whole, rr_whole = fused_scan.schedule(s_main, st_main)
    names = [main_static.node_names[j] if j >= 0 else None for j in whole]
    for r in runs:
        if names != r["assignments"] or r["rr"] != rr_whole:
            raise AssertionError(f"BatchBackend (frontier {r['frontier']}) bindings != one "
                                 "launch of the fused scan on the main-path segment")
    r_main = compare_windows(s_main, st_main, whole, rr_whole, head=head)
    # the sliced kernel's first window against the plain scan at full width
    # (every resource slot, from the same host arrays)
    full_diff = int((whole[:MAIN_WINDOW] != head_full[0]).sum())
    if full_diff or head_full[1] != head[1]:
        raise AssertionError(f"phase 4: the kernel at R = {r_dev} != scan_ref at full width on "
                             f"the first {MAIN_WINDOW} pods: {full_diff} differ, rr {head[1]} "
                             f"vs {head_full[1]}")
    print(f"phase 4 main segment: one kernel launch == BatchBackend with the frontier on and "
          f"off (all {s_main.p_real} pods, rr {rr_whole}); kernel == scan_ref on its first "
          f"{MAIN_WINDOW} pods from the initial state and on its last {MAIN_WINDOW} from the "
          f"kernel's state before them; its first {MAIN_WINDOW} at R = {r_dev} == scan_ref at "
          f"full width (R = 4, rr {head_full[1]}, {head_full[2]:.1f} ms)", flush=True)
    print(plan_line("main segment", s_main, st_main), flush=True)
    other_errs, refresh_wide, wide, k_cell = other_segments()
    errs = [r_main["max_abs_err"], *other_errs, *shape_errs]

    ms = time_kernel(s_main, st_main)
    # the resource-axis cut, in turns on this card: R = 2 (the main path's)
    # and every slot (R = 4) of the same host arrays
    by_r = {r_dev: [], 4: []}
    for r in (r_dev, 4, 4, r_dev):
        by_r[r].append(time_kernel(*((s_main, st_main) if r == r_dev else full_main)))
    print(f"phase 4 the main segment's kernel at R = {r_dev} and R = 4 in turns: {by_r[r_dev]} / "
          f"{by_r[4]} ms, ratio of the means {sum(by_r[r_dev]) / sum(by_r[4]):.4f}", flush=True)
    plain_ms = r_main["plain_ms"]
    bound_ms, bound_by, detail = bound(s_main, st_main)
    chunk_ms = time_chunk(s_main, st_main)
    print(f"phase 4 times on the main segment ({s_main.n_pad} nodes x {s_main.p_real} pods, "
          f"R = {r_dev}): kernel {ms:.3f} ms; on the two windows of {r_main['pods']} pods kernel "
          f"{r_main['kernel_ms']:.3f} ms, plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({detail['bytes']} bytes, {detail['ops']} ops); one 512-pod chunk "
          f"launch (write-back on) {chunk_ms:.3f} ms, x {-(-s_main.p_real // 512)} chunks "
          f"{chunk_ms * -(-s_main.p_real // 512):.3f} ms (device times: launches behind a "
          f"device-side sleep)", flush=True)
    refresh_main = refresh_cell("4 main segment", s_main, st_main)
    loop_cell(*segment(m, pods, pctx, "cuda", frontier=True)[1:], card)
    node_cache_cell(main_static)
    k_main = superstep_phase(m, pods, pctx, s_main, st_main, whole, rr_whole, names)
    lap("4")

    churn_launches, churn_refresh = churn_phase()
    eager_launches, eager_refresh = churn_parity(lazy_ingest=False)
    lap("5")
    daemon_launches, pps_6a, idle_6a, daemon_refresh = daemon_phase()
    lap("6")
    # 17c's run on the card now; its per-pod oracle replay (minutes of one
    # core at 5000 nodes) runs on beside phases 7-16 and is checked in 17
    mesh_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    spared.add(mesh_pool.submit(os.getpid).result())
    churn_mesh = mesh_churn(mesh_pool)
    lap("17c")
    preemption_launches, _ = preemption_phase()
    lap("7")
    policy_launches = policy_phase()
    policy_daemon_phase()
    lap("8")
    traced_launches = traced_daemon_phase(pps_6a, idle_6a)
    fault_launches = faults_phase()
    overload_launches, _ = overload_phase()
    lap("9")
    (pool_launches, pool_refresh, pool_errs, pool_refresh_errs, refresh_pool, host_loops,
     k_pool) = pool_phase()
    host_loop_launches = sum(h["launches"] for h in host_loops.values())
    host_loop_refresh = sum(h["refresh_launches"] for h in host_loops.values())
    lap("10")
    admitted_launches, admitted_refresh = admitted_phase(pps_6a)
    lap("11")
    auth_launches, auth_refresh = auth_phase(pps_6a)
    lap("12")
    # the sequential oracles of 13a and 14b run in processes of their own;
    # 13a's runs on beside phase 14
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as oracle_pool:
        drain_launches, drain_refresh, (kubelet_launches, kubelet_refresh) = drain_phase(
            pps_6a, oracle_pool, lambda: kubelet_phase(pps_6a, oracle_pool))
    lap("13-14")
    controller_launches, controller_refresh = controller_phase(pps_6a)
    lap("15")
    cluster_launches, cluster_refresh = lifecycle_phase(pps_6a)
    lap("16")
    mesh_entry, mesh_refresh, tie_refresh = mesh_phase(
        (s_main, st_main, whole, rr_whole), wide, churn_mesh, card)
    mesh_pool.shutdown()
    spared.clear()
    lap("17")
    grouped = grouped_phase((s_main, st_main, whole, rr_whole), card)
    mesh_entry["launches"] += grouped["launches"]
    mesh_entry["launches_by_path"].update(
        grouped_one_card=sum(c["launches"] for k, c in grouped["cells"].items() if "cards" not in k)
        + grouped["loops"]["pool_4_in_2"]["launches"] + grouped["tie_launches"],
        grouped_cards=sum(c["launches"] for k, c in grouped["cells"].items() if "cards" in k)
        + grouped["loops"].get("pool_4_cards", {}).get("launches", 0))
    mesh_entry.update(grouped_cells=grouped["cells"], grouped_loops=grouped["loops"],
                      grouped_ratio=grouped["cells"]["main_4_in_2"]["ratio"],
                      grouped_ms=grouped["cells"]["main_4_in_2"]["ms"])
    mesh_entry["max_abs_err"] = max(mesh_entry["max_abs_err"],
                                    *(c["max_abs_err"] for c in grouped["cells"].values()))
    lap("17d")

    entry = {
        "name": "fused_scan", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": REPLACES,
        "launches": (launches + churn_launches + eager_launches + daemon_launches
                     + preemption_launches + policy_launches + traced_launches
                     + fault_launches + overload_launches + pool_launches
                     + host_loop_launches
                     + admitted_launches + auth_launches + drain_launches
                     + kubelet_launches + controller_launches + cluster_launches),
        "launches_by_path": {"batch": launches, "churn": churn_launches,
                             "churn_eager": eager_launches, "daemon": daemon_launches,
                             "preemption": preemption_launches, "policy": policy_launches,
                             "traced_daemon": traced_launches, "faults": fault_launches,
                             "overload": overload_launches, "pool": pool_launches,
                             "pool_host_loop": host_loop_launches,
                             "apiserver_defaults": admitted_launches, "auth": auth_launches,
                             "drain": drain_launches, "kubelet": kubelet_launches,
                             "controllers": controller_launches, "cluster": cluster_launches},
        # the repaired shapes' segments (phase 3): many zones, a wide port row
        "cells": shape_cells,
        "max_abs_err": max(errs + pool_errs),
        "ms": ms, "us_per_pod": ms * 1e3 / s_main.p_real, "chunk_ms": chunk_ms,
        # the main segment's resource axis (r_sel) and its kernel at each R in turns
        "r": r_dev, "ms_by_r": {str(r): v for r, v in by_r.items()},
        # the plain version on the main segment's two windows (plain_pods),
        # the kernel's device time there windows_ms
        "plain_ms": plain_ms, "plain_pods": r_main["pods"], "windows_ms": r_main["kernel_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    refresh_cells = {"pool_1024": refresh_pool, "main_5120": refresh_main,
                     "wide_20224": refresh_wide, "ports_600": refresh_ports}
    refresh_entry = {
        "name": "frontier_refresh", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/frontier_refresh.cu",
        "replaces": "kubernetes_tpu/ops/batch_kernel.py:782",
        "launches": (refresh_launches + churn_refresh + eager_refresh + daemon_refresh
                     + pool_refresh + host_loop_refresh + admitted_refresh + auth_refresh
                     + drain_refresh
                     + kubelet_refresh + controller_refresh + cluster_refresh + mesh_refresh
                     + grouped["refreshes"]),
        "launches_by_path": {"batch": refresh_launches, "churn": churn_refresh,
                             "churn_eager": eager_refresh, "daemon": daemon_refresh,
                             "pool": pool_refresh, "pool_host_loop": host_loop_refresh,
                             "apiserver_defaults": admitted_refresh, "auth": auth_refresh,
                             "drain": drain_refresh, "kubelet": kubelet_refresh,
                             "controllers": controller_refresh, "cluster": cluster_refresh,
                             # a refresh a shard a chunk under 17c's 4-shard mesh
                             "churn_mesh": mesh_refresh,
                             # 17d's pool loops, each launch's shards refreshed on its stream
                             "mesh_grouped": grouped["refreshes"]},
        # the per-shard refreshes of 17b's tie loops (held against the CPU)
        "tie_loop_launches": tie_refresh,
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
    # the fused scan's super-step build (PallasSuperSteps): the same function
    # and work as the K = 1 kernel, hence its bound
    k_entry = {
        "name": K_NAME, "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": K_REPLACES,
        "launches": k_main["batch"] + k_pool["launches"],
        "launches_by_path": {"batch": k_main["batch"], "pool": k_pool["launches"]},
        "max_abs_err": max(k_main["max_abs_err"], k_cell["max_abs_err"], k_pool["mismatches"]),
        "ms": k_main["ms"], "ms_turns": k_main["ms_turns"], "k1_ms_turns": k_main["k1_ms_turns"],
        "ratio_to_k1": k_main["ratio"], "regs": k_main["regs"],
        "local_bytes": k_main["local_bytes"], "build_s": built[K_NAME],
        # the plain version and both builds on the 500-pod segment (inert tail)
        "plain_ms": k_cell["plain_ms"], "plain_pods": k_cell["pods"],
        "cell_ms": k_cell["ms"], "cell_k1_ms": k_cell["k1_ms"],
        "pool_kernel_ms": k_pool["kernel_ms"], "pool_k1_kernel_ms": k_pool["k1_kernel_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    print(f"phase seconds {json.dumps(laps)}", flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [entry, refresh_entry, mesh_entry, k_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _stop_on_signal(signum, _frame) -> None:
    """Stop every process of the run, then end it through the phases'
    own clean-up with a non-zero code."""
    stopped = stop_own_processes(grace_s=5.0)
    print(f"chip_smoke: signal {signum}: stopped {len(stopped)} processes of the run",
          file=sys.stderr, flush=True)
    raise SystemExit(128 + signum)


def _past_limit() -> None:
    print(f"chip_smoke: still running after {SELF_LIMIT_S:.0f} s; stopping", file=sys.stderr,
          flush=True)
    signal.pthread_kill(threading.main_thread().ident, signal.SIGTERM)


if __name__ == "__main__":
    os.environ[RUN_TAG] = f"{os.getpid()}-{time.time_ns()}"
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _stop_on_signal)
    limit = threading.Timer(SELF_LIMIT_S, _past_limit)
    limit.daemon = True
    limit.start()
    try:
        rc = main()
    except BaseException as e:  # a failed check, or a signal's SystemExit
        if not isinstance(e, SystemExit):
            traceback.print_exc()
        rc = e.code if isinstance(e, SystemExit) and isinstance(e.code, int) else 1
    finally:
        limit.cancel()
        left = stop_own_processes()
        if left:
            print(f"chip_smoke: left running at its end (stopped): {json.dumps(left)}",
                  file=sys.stderr, flush=True)
    if rc:
        # a failed or stopped run ends now: a thread of a phase cut short
        # would otherwise hold the interpreter's exit past the run's limit
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    sys.exit(rc)
