"""Real containers: one child process per container, under the pod's
pause sandbox — with on-disk checkpoints for kubelet restart recovery.

Capability of the reference's runtime manager + dockershim slice that is
feasible on one unprivileged machine (``pkg/kubelet/kuberuntime/
kuberuntime_manager.go:530 SyncPod`` computing container actions;
``pkg/kubelet/dockershim`` running them):

- **create/start** — each container is a REAL forked child
  (``/bin/sh -c <command>``) with the container's env, its own rootfs
  directory (where volume mounts materialize, see ``volumehost.py``),
  and stdout/stderr appended to a per-container log file;
- **stop** — TERM, bounded wait, KILL (the runtime's graceful-stop
  contract);
- **exec_sync** — runs a command in the container's context (rootfs cwd
  + env), the CRI ``ExecSync`` the prober and ``kubectl exec`` ride
  (``prober/prober.go:80`` judges by exit code);
- **poll** — observed state from the kernel (``waitpid``), so an
  out-of-band ``kill -9`` surfaces as a container death the next sync,
  exactly like the PLEG discovering a dead container in a relist.

There is no namespace/cgroup isolation here (unprivileged box); what IS
real: pids, the process tree, exit codes, signals, the filesystem, and
exec.  The pod's pause process (``csrc/pause.c``) still anchors the
sandbox; containers are tracked per sandbox and die with it.

**Checkpoints** (reference ``pkg/kubelet/dockershim/checkpoint_store.go``
/ ``docker_checkpoint.go``, exercised by
``e2e_node/dockershim_checkpoint_test.go``): every started container
writes ``checkpoint.json`` (pid + /proc start time + command/env) next
to its rootfs.  A manager constructed over the SAME root adopts the
still-live processes — a restarted kubelet resumes managing running
containers instead of orphaning them.  Adopted entries carry no Popen
handle (the new process cannot waitpid another's child), so liveness is
judged by /proc with the start-time pinned against pid reuse, and an
adopted death reports 137 (unknown), like a runtime that lost the wait
status.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import signal
import subprocess
import tempfile
import threading
from typing import Optional


def _proc_stat(pid: int) -> tuple[Optional[str], Optional[str]]:
    """(state, starttime) from /proc/<pid>/stat — the birth stamp guards
    against pid reuse; the state char distinguishes a live process from a
    zombie (an unreaped dead child still has a /proc entry)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
            return fields[0], fields[19]
    except (OSError, IndexError):
        return None, None


def _proc_starttime(pid: int) -> Optional[str]:
    return _proc_stat(pid)[1]

# default entrypoint: a quiet long sleep (the "image default" — pause-like)
_DEFAULT_COMMAND = ["/bin/sh", "-c", "exec sleep 1000000"]

# ONE module-level atexit hook over a strong set of managers:
# per-instance atexit.register pinned every manager (fleets, test
# suites) alive until interpreter exit even after remove_all.  The set
# must hold strong refs — a weak set would let a manager dropped
# WITHOUT remove_all be collected mid-run, orphaning its children
# forever; here it stays pinned until exit cleanup kills them, and
# remove_all() unpins the well-behaved ones.
_LIVE_MANAGERS: "set[ProcessContainerManager]" = set()


def _atexit_cleanup_all() -> None:
    for mgr in list(_LIVE_MANAGERS):
        mgr._atexit_cleanup()


atexit.register(_atexit_cleanup_all)


class ProcessContainerManager:
    """Real child processes playing the container role (one per
    (pod, container)); rootfs dirs under a private temp root."""

    def __init__(self, root: Optional[str] = None):
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="ktpu-containers-")
        self._mu = threading.Lock()
        # (pod_key, name) -> {"proc": Popen|None, "pid": int,
        #   "starttime": str|None, "rootfs": str, "env": dict,
        #   "log": str, "command": list}
        # proc is None for ADOPTED containers (checkpoint recovery): the
        # restarted manager watches them through /proc instead of waitpid
        self._ctrs: dict[tuple[str, str], dict] = {}
        self.stats = {"adopted": 0}
        _LIVE_MANAGERS.add(self)

    def _atexit_cleanup(self) -> None:
        """Ephemeral roots tear everything down; a PERSISTENT root leaves
        live containers and their checkpoints in place — that is the
        whole point of checkpoint recovery (a graceful kubelet exit must
        not kill the workloads a restart would re-adopt)."""
        if self._own_root:
            self.remove_all()

    # -- paths ---------------------------------------------------------------
    def pod_dir(self, pod_key: str) -> str:
        return os.path.join(self.root, pod_key.replace("/", "_"))

    def rootfs(self, pod_key: str, name: str) -> str:
        return os.path.join(self.pod_dir(pod_key), "containers", name, "rootfs")

    def log_path(self, pod_key: str, name: str) -> str:
        return os.path.join(self.pod_dir(pod_key), "containers", name, "log")

    def checkpoint_path(self, pod_key: str, name: str) -> str:
        return os.path.join(self.pod_dir(pod_key), "containers", name,
                            "checkpoint.json")

    # -- lifecycle -----------------------------------------------------------
    def start(self, pod_key: str, name: str, command: Optional[list[str]] = None,
              env: Optional[dict] = None) -> int:
        """CreateContainer + StartContainer: fork the real child; returns
        its pid.  A container already alive under this identity is left
        running (idempotent sync)."""
        _LIVE_MANAGERS.add(self)  # a manager reused after remove_all()
        # must regain exit cleanup for its new children
        with self._mu:
            cur = self._ctrs.get((pod_key, name))
            if cur is not None and self._alive_locked(cur):
                return cur["pid"]
            rootfs = self.rootfs(pod_key, name)
            os.makedirs(rootfs, exist_ok=True)
            log = self.log_path(pod_key, name)
            cmd = list(command) if command else list(_DEFAULT_COMMAND)
            full_env = dict(os.environ)
            full_env.update(env or {})
            full_env["KTPU_POD"] = pod_key
            full_env["KTPU_CONTAINER"] = name
            full_env["KTPU_ROOTFS"] = rootfs
            logf = open(log, "ab", buffering=0)
            try:
                try:
                    # the spawn must stay inside the idempotency check's
                    # lock hold: releasing between _alive_locked and Popen
                    # would let two concurrent sync sweeps double-start it
                    # blocking-ok — atomic check-then-spawn under _mu IS the idempotency contract
                    proc = subprocess.Popen(
                        cmd, cwd=rootfs, env=full_env,
                        stdout=logf, stderr=logf,
                        stdin=subprocess.DEVNULL,
                        start_new_session=True,  # own pgid: stop() signals the tree
                    )
                except OSError as e:
                    # an unrunnable entrypoint must not abort the caller's
                    # sync sweep (reference: CreateContainerError feeding
                    # CrashLoopBackOff).  A real child that exits 127
                    # keeps every downstream path uniform: the death is
                    # kernel-observed, restart policy cycles it, the
                    # error is in the log.
                    logf.write(f"spawn failed: {e}\n".encode())
                    # blocking-ok — same lock-hold contract as the spawn above
                    proc = subprocess.Popen(
                        ["/bin/sh", "-c", "exit 127"], cwd=rootfs,
                        env=full_env, stdout=logf, stderr=logf,
                        stdin=subprocess.DEVNULL, start_new_session=True,
                    )
            finally:
                logf.close()  # the child holds its own fd now
            entry = {
                "proc": proc, "pid": proc.pid,
                "starttime": _proc_starttime(proc.pid),
                "rootfs": rootfs, "env": dict(env or {}),
                "log": log, "command": cmd,
            }
            self._ctrs[(pod_key, name)] = entry
            # checkpoint for restart recovery (dockershim checkpoint_store)
            try:
                with open(self.checkpoint_path(pod_key, name), "w") as f:
                    json.dump({"pod": pod_key, "name": name,
                               "pid": entry["pid"],
                               "starttime": entry["starttime"],
                               "command": cmd, "env": dict(env or {})}, f)
            except OSError:
                pass  # a missing checkpoint only degrades restart adoption
            return proc.pid

    @staticmethod
    def _alive_locked(c: dict) -> bool:
        if c["proc"] is not None:
            return c["proc"].poll() is None
        # adopted: /proc liveness with the start time pinned (pid reuse)
        # and zombies excluded (dead-but-unreaped is DEAD to the runtime)
        state, starttime = _proc_stat(c["pid"])
        return (c["starttime"] is not None
                and starttime == c["starttime"]
                and state not in ("Z", "X", None))

    def pid(self, pod_key: str, name: str) -> Optional[int]:
        with self._mu:
            c = self._ctrs.get((pod_key, name))
            return None if c is None else c["pid"]

    def alive(self, pod_key: str, name: str) -> bool:
        with self._mu:
            c = self._ctrs.get((pod_key, name))
            return c is not None and self._alive_locked(c)

    def exit_code(self, pod_key: str, name: str) -> Optional[int]:
        """None while running (or unknown — adopted containers have no
        waitable status, like a runtime that lost the wait); the real
        wait status once dead.  A kill by signal N reports 128+N like a
        shell would."""
        with self._mu:
            c = self._ctrs.get((pod_key, name))
            if c is None or c["proc"] is None:
                return None
            rc = c["proc"].poll()
            if rc is None:
                return None
            return 128 - rc if rc < 0 else rc

    # -- restart recovery ----------------------------------------------------
    def adopt_checkpoints(self) -> int:
        """Scan the root for checkpoints of still-live processes and take
        them over (dockershim checkpoint recovery: a restarted kubelet
        resumes managing running containers).  Stale checkpoints (dead or
        reused pids) are deleted.  Returns how many were adopted."""
        adopted = 0
        try:
            pod_dirs = os.listdir(self.root)
        except OSError:
            return 0
        for pd in pod_dirs:
            cdir = os.path.join(self.root, pd, "containers")
            if not os.path.isdir(cdir):
                continue
            for cname in os.listdir(cdir):
                cp = os.path.join(cdir, cname, "checkpoint.json")
                try:
                    with open(cp) as f:
                        doc = json.load(f)
                    key = (doc.get("pod", ""), doc.get("name", ""))
                    pid = int(doc.get("pid", 0))
                    starttime = doc.get("starttime")
                except (OSError, ValueError, TypeError, AttributeError):
                    # a corrupt checkpoint degrades adoption for that
                    # container only — it must never stop the kubelet
                    try:
                        os.unlink(cp)
                    except OSError:
                        pass
                    continue
                state, cur_start = _proc_stat(pid) if pid > 0 else (None, None)
                live = (pid > 0 and starttime is not None
                        and cur_start == starttime
                        and state not in ("Z", "X", None))
                with self._mu:
                    if not live or key in self._ctrs:
                        if not live:
                            try:
                                os.unlink(cp)
                            except OSError:
                                pass
                        continue
                    self._ctrs[key] = {
                        "proc": None, "pid": pid, "starttime": starttime,
                        "rootfs": os.path.join(cdir, cname, "rootfs"),
                        "env": dict(doc.get("env") or {}),
                        "log": os.path.join(cdir, cname, "log"),
                        "command": list(doc.get("command") or []),
                    }
                    self.stats["adopted"] += 1
                    adopted += 1
        return adopted

    def stop(self, pod_key: str, name: str, timeout: float = 5.0) -> None:
        import time as _time

        with self._mu:
            c = self._ctrs.get((pod_key, name))
            live = c is not None and self._alive_locked(c)
        if c is None or not live:
            return
        proc, pid = c["proc"], c["pid"]

        def _wait(t: float) -> bool:
            if proc is not None:
                try:
                    proc.wait(timeout=t)
                    return True
                except subprocess.TimeoutExpired:
                    return False
            deadline = _time.monotonic() + t  # adopted: poll /proc
            while _time.monotonic() < deadline:
                state, starttime = _proc_stat(pid)
                # starttime change = gone/reused; Z/X = dead-but-unreaped
                # (a zombie must not stall the sweep for the full timeout)
                if starttime != c["starttime"] or state in ("Z", "X", None):
                    return True
                _time.sleep(0.02)
            return False

        try:  # signal the whole process group (shell + children)
            os.killpg(pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                return
        if not _wait(timeout):
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    return
            _wait(timeout)  # D-state straggler; never block the sweep

    def remove(self, pod_key: str, name: str) -> None:
        self.stop(pod_key, name)
        with self._mu:
            self._ctrs.pop((pod_key, name), None)
        try:
            os.unlink(self.checkpoint_path(pod_key, name))
        except OSError:
            pass

    def remove_pod(self, pod_key: str) -> None:
        with self._mu:
            names = [n for (k, n) in self._ctrs if k == pod_key]
        for n in names:
            self.remove(pod_key, n)
        shutil.rmtree(self.pod_dir(pod_key), ignore_errors=True)

    def remove_all(self) -> None:
        with self._mu:
            keys = list(self._ctrs)
        for k, n in keys:
            self.remove(k, n)
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)
        _LIVE_MANAGERS.discard(self)

    def known_pods(self) -> set[str]:
        with self._mu:
            return {k for (k, _) in self._ctrs}

    # -- exec ---------------------------------------------------------------
    def exec_sync(self, pod_key: str, name: str, command: list[str],
                  timeout: float = 10.0) -> tuple[str, int]:
        """CRI ExecSync: run ``command`` in the container's context
        (rootfs cwd, container env).  Like the reference, exec into a
        dead container is an error (ValueError -> the server's 4xx)."""
        with self._mu:
            c = self._ctrs.get((pod_key, name))
            if c is None or not self._alive_locked(c):
                raise ValueError(f"container {pod_key}/{name} is not running")
            rootfs, env = c["rootfs"], dict(c["env"])
        full_env = dict(os.environ)
        full_env.update(env)
        full_env["KTPU_POD"] = pod_key
        full_env["KTPU_CONTAINER"] = name
        full_env["KTPU_ROOTFS"] = rootfs
        try:
            res = subprocess.run(
                command, cwd=rootfs, env=full_env, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                timeout=timeout,
            )
        except subprocess.TimeoutExpired:
            return ("exec timed out", 124)
        except (FileNotFoundError, PermissionError) as e:
            return (str(e), 126)
        return (res.stdout.decode(errors="replace"), res.returncode)

    # -- observed usage (the cadvisor slice: /proc is the source) ------------
    def usage(self, pod_key: str) -> dict:
        """Kernel-observed usage summed over the pod's live container
        processes: RSS bytes (``/proc/<pid>/status`` VmRSS) and
        cumulative CPU milliseconds (``/proc/<pid>/stat`` utime+stime).
        The stats-summary endpoint serves this; a metrics client turns
        the cumulative CPU into a rate by sampling twice."""
        with self._mu:
            pids = [c["pid"] for (k, _), c in self._ctrs.items()
                    if k == pod_key and self._alive_locked(c)]
        rss = 0
        cpu_ms = 0.0
        tick = os.sysconf("SC_CLK_TCK") or 100
        for pid in pids:
            try:
                with open(f"/proc/{pid}/status") as f:
                    for line in f:
                        if line.startswith("VmRSS:"):
                            rss += int(line.split()[1]) * 1024
                            break
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                    # utime=field 14, stime=15 (1-indexed); after ')' the
                    # split starts at field 3
                    cpu_ms += (int(fields[11]) + int(fields[12])) / tick * 1000.0
            except (OSError, IndexError, ValueError):
                continue  # raced a death; skip
        return {"memoryBytes": rss, "cpuMillis": cpu_ms}

    def read_log(self, pod_key: str, name: str) -> Optional[list[str]]:
        path = self.log_path(pod_key, name)
        try:
            with open(path, "rb") as f:
                text = f.read().decode(errors="replace")
        except FileNotFoundError:
            return None
        return text.splitlines()
