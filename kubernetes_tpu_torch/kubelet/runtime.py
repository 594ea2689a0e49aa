"""Fake container runtime + prober + pressure eviction for the hollow node.

Capability of three reference kubelet subsystems, driven by the hollow
kubelet's tick (no containers underneath — a scriptable fake runtime
plays the part of dockershim, like kubemark's fake Docker client):

- **Prober** (``pkg/kubelet/prober/``, 905 LoC): per-container liveness
  and readiness workers honoring ``initialDelaySeconds`` /
  ``periodSeconds`` / ``failureThreshold`` / ``successThreshold``.
  Liveness failure past the threshold restarts the container
  (restart_count += 1); readiness results drive the container's
  ``ready`` bit and the pod's Ready condition — which the endpoint
  controller consumes, so an unready pod leaves its Service.
- **Restart policy** (``kuberuntime_manager.go SyncPod``): a container
  exit restarts under Always (and OnFailure when exit_code != 0);
  otherwise the pod goes Succeeded/Failed.
- **Eviction manager** (``pkg/kubelet/eviction/eviction_manager.go:213
  synchronize``): observed memory/disk signals against thresholds; when
  over, pods are ranked — BestEffort first, then Burstable, Guaranteed
  last (the QoS order of ``eviction/helpers.go``), higher usage first
  within a class — and evicted (phase Failed, reason Evicted) until the
  signal clears; the node reports Memory/DiskPressure conditions, which
  the scheduler's CheckNodeMemoryPressure / CheckNodeDiskPressure
  predicates then act on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api import types as api

QOS_GUARANTEED = "Guaranteed"
QOS_BURSTABLE = "Burstable"
QOS_BEST_EFFORT = "BestEffort"

_QOS_EVICTION_ORDER = {QOS_BEST_EFFORT: 0, QOS_BURSTABLE: 1, QOS_GUARANTEED: 2}


def pod_qos_class(pod: api.Pod) -> str:
    """Reference ``pkg/api/v1/helper/qos.GetPodQOS``."""
    requests: dict[str, str] = {}
    limits_all = True
    any_request = False
    for c in pod.spec.containers:
        r, l = c.resources.requests, c.resources.limits
        if r:
            any_request = True
        for k in ("cpu", "memory"):
            rq, lq = r.get(k), l.get(k)
            if lq is None or (rq is not None and str(rq) != str(lq)):
                limits_all = False
    if not any_request and not any(c.resources.limits for c in pod.spec.containers):
        return QOS_BEST_EFFORT
    if limits_all and all(
        c.resources.requests.keys() == c.resources.limits.keys() or not c.resources.requests
        for c in pod.spec.containers
    ) and all(c.resources.limits for c in pod.spec.containers):
        return QOS_GUARANTEED
    return QOS_BURSTABLE


@dataclass
class _ProbeState:
    consecutive_failures: int = 0
    consecutive_successes: int = 0
    last_run: float = -1e18
    result: bool = True  # last settled verdict


@dataclass
class _ContainerState:
    status: api.ContainerStatus = None
    liveness: _ProbeState = field(default_factory=_ProbeState)
    readiness: _ProbeState = field(default_factory=_ProbeState)
    started_at: float = 0.0


class FakeRuntime:
    """Scriptable container world: tests flip probe outcomes and inject
    exits; the prober/eviction logic reacts exactly as the real kubelet
    would against CRI."""

    def __init__(self):
        # (pod_key, container) -> scripted outcome
        self.probe_results: dict[tuple[str, str, str], bool] = {}
        self.exits: dict[tuple[str, str], int] = {}  # -> exit code
        # per-pod observed usage signals (the cadvisor stand-in)
        self.pod_memory_usage: dict[str, int] = {}  # bytes
        # (pod_key, container) -> log lines (the container stdout stand-in)
        self._logs: dict[tuple[str, str], list[str]] = {}
        # (pod_key, container) -> exec handler (the CRI ExecSync stand-in)
        self._exec_handlers: dict = {}
        # (pod_key, container) -> {path: bytes} — the container filesystem
        # stand-in backing ``kubectl cp`` (the reference streams tar over
        # exec; the capability is per-container file read/write)
        self._files: dict[tuple[str, str], dict[str, bytes]] = {}
        # real-container delegates (set by the kubelet when containers are
        # real processes, kubelet/containers.py): scripted handlers/files
        # still take precedence so tests keep their override seam
        self.exec_delegate = None  # fn(pod_key, container, command) -> (out, rc)
        self.log_delegate = None  # fn(pod_key, container) -> list[str] | None
        self.file_read_delegate = None  # fn(pod_key, container, path) -> bytes|None
        self.file_write_delegate = None  # fn(pod_key, container, path, data) -> bool

    def write_file(self, pod_key: str, container: str, path: str, data: bytes) -> None:
        if self.file_write_delegate is not None:
            if self.file_write_delegate(pod_key, container, path, bytes(data)):
                return
        self._files.setdefault((pod_key, container), {})[path] = bytes(data)

    def read_file(self, pod_key: str, container: str, path: str):
        """Bytes, or None if absent."""
        data = self._files.get((pod_key, container), {}).get(path)
        if data is None and self.file_read_delegate is not None:
            data = self.file_read_delegate(pod_key, container, path)
        return data

    def append_log(self, pod_key: str, container: str, line: str) -> None:
        self._logs.setdefault((pod_key, container), []).append(line)

    def read_logs(self, pod_key: str, container: str):
        """Lines, or None if the container never existed here.  Real
        containers contribute their process stdout/stderr after the
        kubelet's lifecycle lines."""
        lines = self._logs.get((pod_key, container))
        if self.log_delegate is not None:
            real = self.log_delegate(pod_key, container)
            if real is not None:
                lines = (lines or []) + real
        return lines

    def drop_logs(self, pod_key: str) -> None:
        for k in [k for k in self._logs if k[0] == pod_key]:
            del self._logs[k]

    def set_exec_handler(self, pod_key: str, container: str, fn) -> None:
        """fn(command: list[str]) -> (stdout: str, exit_code: int)."""
        self._exec_handlers[(pod_key, container)] = fn

    def exec(self, pod_key: str, container: str, command: list[str]):
        """Run a command "in" the container (CRI ExecSync).  Scripted
        handlers override; real containers (delegate) run the command as
        an actual child process; the fake echoes."""
        fn = self._exec_handlers.get((pod_key, container))
        if fn is not None:
            return fn(command)
        if self.exec_delegate is not None:
            return self.exec_delegate(pod_key, container, command)
        return (" ".join(command), 0)

    def probe(self, pod_key: str, container: str, kind: str) -> bool:
        return self.probe_results.get((pod_key, container, kind), True)

    def set_probe(self, pod_key: str, container: str, kind: str, ok: bool) -> None:
        self.probe_results[(pod_key, container, kind)] = ok

    def inject_exit(self, pod_key: str, container: str, exit_code: int) -> None:
        self.exits[(pod_key, container)] = exit_code

    def take_exit(self, pod_key: str, container: str) -> Optional[int]:
        return self.exits.pop((pod_key, container), None)


class PodRuntimeManager:
    """Per-kubelet container/probe state machine (one per HollowKubelet).

    With ``containers`` (a :class:`~kubernetes_tpu_torch.kubelet.containers.
    ProcessContainerManager`) and optionally ``volume_host``, containers
    are REAL child processes: start forks them, sync polls their pids
    (an out-of-band ``kill -9`` is a container death), restart spawns a
    fresh process, and exec probes run through CRI ExecSync
    (``prober/prober.go:80``)."""

    def __init__(self, runtime: FakeRuntime, clock: Callable[[], float],
                 containers=None, volume_host=None):
        self.runtime = runtime
        self.clock = clock
        self.containers = containers
        self.volume_host = volume_host
        self._pods: dict[str, dict[str, _ContainerState]] = {}

    def _spawn(self, pod: api.Pod, c: api.Container) -> str:
        """Start the real child for container ``c``; returns its
        "pid://<n>" id.  Volumes are materialized and projected into the
        rootfs FIRST — the entrypoint may read them immediately."""
        key = pod.meta.key
        import os as _os

        rootfs = self.containers.rootfs(key, c.name)
        _os.makedirs(rootfs, exist_ok=True)
        if self.volume_host is not None:
            self.volume_host.sync_pod(pod)
            self.volume_host.project_into_rootfs(pod, c, rootfs)
        pid = self.containers.start(key, c.name,
                                    command=c.command or None, env=c.env)
        return f"pid://{pid}"

    def ensure_running(self, pod: api.Pod) -> None:
        key = pod.meta.key
        if key in self._pods:
            return
        now = self.clock()
        self._pods[key] = {}
        for c in pod.spec.containers:
            cid = ""
            if self.containers is not None:
                cid = self._spawn(pod, c)
            self._pods[key][c.name] = _ContainerState(
                status=api.ContainerStatus(name=c.name, state="running",
                                           ready=True, container_id=cid),
                started_at=now,
            )
            self.runtime.append_log(key, c.name, f"container {c.name} started")

    def forget(self, pod_key: str) -> None:
        self._pods.pop(pod_key, None)
        # a recreated pod under the same key must not inherit old logs,
        # and a churning fleet must not grow buffers without bound
        self.runtime.drop_logs(pod_key)
        if self.containers is not None:
            self.containers.remove_pod(pod_key)
        if self.volume_host is not None:
            self.volume_host.teardown_pod(pod_key)

    def known(self) -> set[str]:
        return set(self._pods)

    # -- one prober + runtime pass for one pod; returns the pod-level
    # outcome: ("running", statuses, all_ready) | ("succeeded"|"failed", ...)
    def sync_pod(self, pod: api.Pod):
        key = pod.meta.key
        states = self._pods.get(key)
        if states is None:
            self.ensure_running(pod)
            states = self._pods[key]
        now = self.clock()
        terminal: Optional[str] = None

        if self.volume_host is not None:
            # mount reconciler pass (reconciler.go:165): configMap/secret
            # updates re-materialize while the pod runs — the atomic
            # symlink flip makes the new content visible in-place
            self.volume_host.sync_pod(pod)
        for c in pod.spec.containers:
            st = states.get(c.name)
            if st is None:
                cid = self._spawn(pod, c) if self.containers is not None else ""
                st = states[c.name] = _ContainerState(
                    status=api.ContainerStatus(name=c.name, state="running",
                                               ready=True, container_id=cid),
                    started_at=now,
                )
            # scripted exit (the PLEG event); under the real runtime the
            # kernel is the truth — a process that exited or was killed
            # out-of-band (kill -9) surfaces here via waitpid
            exit_code = self.runtime.take_exit(key, c.name)
            if (exit_code is None and self.containers is not None
                    and st.status.state == "running"
                    and not self.containers.alive(key, c.name)):
                exit_code = self.containers.exit_code(key, c.name)
                if exit_code is None:
                    exit_code = 137  # unknown death: report like SIGKILL
            if exit_code is not None:
                restart = pod.spec.restart_policy == "Always" or (
                    pod.spec.restart_policy == "OnFailure" and exit_code != 0
                )
                if restart:
                    self._restart(st, now, reason="Error" if exit_code else "Completed", pod_key=key, cname=c.name, spec=c)
                else:
                    st.status.state = "terminated"
                    st.status.ready = False
                    st.status.exit_code = exit_code
                    st.status.reason = "Error" if exit_code else "Completed"
                    terminal = "failed" if exit_code else "succeeded"
                continue
            if st.status.state != "running":
                continue
            # liveness: failureThreshold consecutive failures -> restart
            if c.liveness_probe is not None:
                res = self._run_probe(st, st.liveness, c.liveness_probe, key, c.name, "liveness", now)
                if res is False and st.liveness.consecutive_failures >= c.liveness_probe.failure_threshold:
                    self._restart(st, now, reason="Unhealthy", pod_key=key, cname=c.name, spec=c)
            # readiness: drives the ready bit through both thresholds
            if c.readiness_probe is not None:
                self._run_probe(st, st.readiness, c.readiness_probe, key, c.name, "readiness", now)
                st.status.ready = st.readiness.result and st.status.state == "running"
            else:
                st.status.ready = st.status.state == "running"

        statuses = [states[c.name].status for c in pod.spec.containers if c.name in states]
        all_ready = bool(statuses) and all(s.ready for s in statuses)
        if terminal is not None:
            return terminal, statuses, False
        return "running", statuses, all_ready

    def _run_probe(self, cst: _ContainerState, pst: _ProbeState, probe: api.Probe,
                   pod_key: str, cname: str, kind: str, now: float) -> Optional[bool]:
        if now - cst.started_at < probe.initial_delay_seconds:
            return None
        if now - pst.last_run < probe.period_seconds:
            return None
        pst.last_run = now
        scripted = self.runtime.probe_results.get((pod_key, cname, kind))
        if scripted is not None:
            ok = scripted  # tests' override seam always wins
        elif self.containers is not None and probe.exec_command:
            # real exec probe: run the command via ExecSync and judge by
            # exit code (prober/prober.go:80 runProbe).  The wait is
            # bounded by the probe's own timeoutSeconds (reference
            # default 1s) — probes run inline in the serial sync tick, so
            # a wedged command costs at most that bound per period
            try:
                _, rc = self.containers.exec_sync(
                    pod_key, cname, probe.exec_command,
                    timeout=max(0.1, float(probe.timeout_seconds)))
                ok = rc == 0
            except ValueError:  # container not running
                ok = False
        else:
            ok = self.runtime.probe(pod_key, cname, kind)
        if ok:
            pst.consecutive_successes += 1
            pst.consecutive_failures = 0
            if pst.consecutive_successes >= probe.success_threshold:
                pst.result = True
        else:
            pst.consecutive_failures += 1
            pst.consecutive_successes = 0
            if pst.consecutive_failures >= probe.failure_threshold:
                pst.result = False
        return ok

    def _restart(self, st: _ContainerState, now: float, reason: str,
                 pod_key: str, cname: str,
                 spec: Optional[api.Container] = None) -> None:
        if self.containers is not None:
            # reap the dead (or unhealthy) process and fork a FRESH one —
            # the restarted container has a genuinely new pid
            self.containers.remove(pod_key, cname)
            pid = self.containers.start(
                pod_key, cname,
                command=(spec.command or None) if spec is not None else None,
                env=spec.env if spec is not None else None)
            st.status.container_id = f"pid://{pid}"
        st.status.restart_count += 1
        st.status.state = "running"
        st.status.ready = True
        st.status.reason = reason
        st.started_at = now
        st.liveness = _ProbeState()
        st.readiness = _ProbeState()
        self.runtime.append_log(
            pod_key, cname,
            f"container {cname} restarted ({reason}), restart #{st.status.restart_count}",
        )


def rank_for_eviction(pods: list[api.Pod], usage: dict[str, int]) -> list[api.Pod]:
    """QoS class first (BestEffort evicted first), then usage descending
    (``eviction/helpers.go`` rankMemoryPressure)."""
    return sorted(
        pods,
        key=lambda p: (
            _QOS_EVICTION_ORDER.get(pod_qos_class(p), 1),
            -usage.get(p.meta.key, 0),
        ),
    )


class ProcessSandboxManager:
    """Real pod sandboxes: one ``ktpu-pause`` process per pod.

    The reference's RunPodSandbox starts the pause container before any
    workload container (``kuberuntime_sandbox.go``); pause holds the
    sandbox's namespaces and reaps re-parented zombies
    (``build/pause/pause.c``).  This manager does the same with the
    compiled ``csrc/pause.c`` — giving the hollow node a REAL process
    backbone when enabled, so sandbox lifecycle (create/exists/remove,
    TERM teardown) is exercised against the actual kernel instead of a
    dict.  Falls back to inert (no processes) when no C toolchain built
    the binary."""

    def __init__(self):
        import atexit
        import subprocess

        from ..native import pause_binary

        self._subprocess = subprocess
        self._bin = pause_binary()
        self._procs: dict[str, object] = {}
        if self._bin is not None:
            # pause sleeps forever: without this, an interpreter exit with
            # running sandboxes leaves one orphan OS process per pod
            atexit.register(self.remove_all)

    @property
    def enabled(self) -> bool:
        return self._bin is not None

    def create(self, pod_key: str) -> Optional[int]:
        """Idempotent RunPodSandbox: returns the sandbox pid (None when
        disabled)."""
        if self._bin is None:
            return None
        proc = self._procs.get(pod_key)
        if proc is not None and proc.poll() is None:
            return proc.pid
        proc = self._subprocess.Popen(
            [self._bin],
            stdout=self._subprocess.DEVNULL,
            stderr=self._subprocess.DEVNULL,
        )
        self._procs[pod_key] = proc
        return proc.pid

    def exists(self, pod_key: str) -> bool:
        proc = self._procs.get(pod_key)
        return proc is not None and proc.poll() is None

    def known(self) -> set:
        """Keys with a sandbox (live or pending reap) — the public view
        the kubelet's GC pass diffs against."""
        return set(self._procs)

    def remove(self, pod_key: str, timeout: float = 5.0) -> None:
        """StopPodSandbox + RemovePodSandbox: TERM, wait, KILL on
        overrun."""
        proc = self._procs.pop(pod_key, None)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except self._subprocess.TimeoutExpired:
            proc.kill()
            try:
                # KILL is eventually fatal; a process stuck in D-state
                # past this wait must not abort the caller's sweep and
                # orphan every sandbox after it
                proc.wait(timeout=timeout)
            except self._subprocess.TimeoutExpired:
                pass

    def remove_all(self) -> None:
        for key in list(self._procs):
            self.remove(key)
