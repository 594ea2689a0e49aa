"""Hollow kubelet: the node agent with a fake runtime.

Capability of the reference's kubemark HollowKubelet
(``pkg/kubemark/hollow_kubelet.go:48`` — real kubelet wiring over a fake
Docker client; SURVEY.md §4.5): register the node, heartbeat its Ready
condition, watch for pods bound to it, "start" them after a configurable
latency, and report pod/node status back — everything the control plane
observes from a node, with no containers underneath.  A fleet of these is
how 5k-node control-plane behavior is tested on one machine.

Scale shape: the fleet shares ONE pod informer with a by-node index (the
apiserver-side fieldSelector ``spec.nodeName=X`` the real kubelet uses),
so a tick is O(own pods), not O(cluster pods).

Tick-driven with an injected clock (the kubelet's syncLoop ticks,
``kubelet.go:1709``, collapsed into an explicit ``tick()``)."""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

logger = logging.getLogger("kubernetes_tpu_torch.kubelet")

from ..api import types as api
from ..api.meta import ObjectMeta
from ..client.clientset import Clientset
from ..utils.features import DEFAULT_FEATURE_GATES
from ..client.informer import PodNodeIndex, SharedInformer
from ..store.store import AlreadyExistsError, ConflictError, NotFoundError
from .cm import AdmissionRejected


class HollowKubelet:
    def __init__(
        self,
        clientset: Clientset,
        node_name: str,
        pod_index: Optional[PodNodeIndex] = None,
        cpu: str = "8",
        memory: str = "16Gi",
        pods: int = 110,
        labels: Optional[dict] = None,
        pod_start_latency: float = 0.5,
        heartbeat_interval: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        runtime: "FakeRuntime" = None,
        memory_pressure_fraction: float = 0.95,
        serve: bool = False,
        mount_latency: float = 0.0,
        real_sandboxes: bool = False,
        real_containers: bool = False,
        container_root: Optional[str] = None,
        static_pod_dir: Optional[str] = None,
        manifest_url: Optional[str] = None,
        system_reserved_cpu: str = "0",
        system_reserved_memory: str = "0",
        kube_reserved_cpu: str = "0",
        kube_reserved_memory: str = "0",
    ):
        from .runtime import FakeRuntime, PodRuntimeManager

        self.clientset = clientset
        self.node_name = node_name
        self.pod_index = pod_index
        self.cpu = cpu
        self.memory = memory
        self.pods = pods
        self.labels = labels or {}
        self.pod_start_latency = pod_start_latency
        self.heartbeat_interval = heartbeat_interval
        self._clock = clock
        self._last_heartbeat = -1e18
        # the Node as this kubelet's last heartbeat wrote it (None: unknown)
        self._node: Optional[api.Node] = None
        self._starting: dict[str, float] = {}  # pod key -> bind-seen time
        # probe / restart / eviction machinery (pkg/kubelet prober +
        # eviction manager over a scriptable fake runtime)
        self.runtime = runtime or FakeRuntime()
        # optional REAL per-pod sandbox processes (csrc/pause.c, the
        # reference's pause container): a pause process runs exactly
        # while the pod is Running; teardown on termination or removal
        self.sandboxes = None
        if real_sandboxes or real_containers:
            from .runtime import ProcessSandboxManager

            mgr = ProcessSandboxManager()
            self.sandboxes = mgr if mgr.enabled else None
        # optional REAL containers: forked child processes with on-disk
        # volumes (kubelet/containers.py + volumehost.py) — exec, logs
        # and cp then operate on actual processes/files
        self.containers = None
        self.volume_host = None
        if real_containers:
            from .containers import ProcessContainerManager
            from .volumehost import VolumeHost

            self.containers = ProcessContainerManager(root=container_root)
            if container_root is not None:
                # restart recovery: adopt still-live containers from the
                # previous kubelet process's checkpoints (dockershim
                # checkpoint_store) instead of orphaning them
                self.containers.adopt_checkpoints()
            self.volume_host = VolumeHost(
                fetch_configmap=self._fetch_configmap,
                fetch_secret=self._fetch_secret,
            )
            self.runtime.exec_delegate = self.containers.exec_sync
            self.runtime.log_delegate = self.containers.read_log
            self.runtime.file_read_delegate = self._read_rootfs_file
            self.runtime.file_write_delegate = self._write_rootfs_file
        self.pod_manager = PodRuntimeManager(
            self.runtime, clock,
            containers=self.containers, volume_host=self.volume_host)
        # static pods (pkg/kubelet/config file source + mirror pods):
        # manifests in this directory run on the node WITHOUT a scheduler
        # — how kubeadm self-hosts the control plane.  The kubelet
        # mirrors them into the API for visibility; the FILE is the
        # source of truth (API deletion of a mirror is undone next tick).
        self.static_pod_dir = static_pod_dir
        # the http pod source (config/http.go): one URL serving a single
        # pod manifest, merged with the file source through the same
        # static-pod machinery; polled at its own cadence (the
        # reference's --http-check-frequency), never per tick
        self.manifest_url = manifest_url
        self.http_check_frequency = 20.0
        self._last_url_fetch = -1e18
        self._last_url_body: Optional[bytes] = None
        self._static_seen: dict[str, tuple[str, str]] = {}  # source -> (content hash, pod key)
        from .cm import ContainerManager, ImageManager
        from .pleg import PLEG

        # resource accounting: the cgroup-analogue tree + node admission
        # (pkg/kubelet/cm) and image GC (pkg/kubelet/images)
        self.cm = ContainerManager(
            cpu, memory, pods,
            system_reserved_cpu=system_reserved_cpu,
            system_reserved_memory=system_reserved_memory,
            kube_reserved_cpu=kube_reserved_cpu,
            kube_reserved_memory=kube_reserved_memory,
        )
        self.images = ImageManager(clock=clock)
        self.image_gc_period = 30.0
        self._last_image_gc = -1e18
        # relist-based lifecycle events (pleg/generic.go:181): out-of-band
        # runtime changes surface within one relist period
        self.pleg = PLEG(self.pod_manager, self.sandboxes, clock=clock)
        # pod networking through the plugin seam (pkg/kubelet/network):
        # constructed lazily at first setup so the node's ALLOCATED
        # podCIDR (written by the IPAM controller after registration) is
        # respected
        self.network = None
        from .volumemanager import VolumeManager

        self.volume_manager = VolumeManager(clock, mount_latency=mount_latency)
        self._last_in_use: list[str] = []
        self.memory_pressure_fraction = memory_pressure_fraction
        self._memory_capacity = api.Quantity(memory).value()
        # the node's read API (pkg/kubelet/server): logs/pods/healthz
        self.server = None
        if serve:
            from .server import KubeletServer
            from ..auth.authn import kubelet_exec_token

            self.server = KubeletServer(self, exec_token=kubelet_exec_token(node_name))
            self.server.start()

    # -- real-container plumbing -------------------------------------------
    def _fetch_configmap(self, ns: str, name: str):
        try:
            return self.clientset.client_for("ConfigMap").get(name, ns).data
        except Exception as e:  # noqa: BLE001 — missing source: keep last payload
            logger.debug("%s: configmap %s/%s unavailable (%s); keeping "
                         "last payload", self.node_name, ns, name,
                         type(e).__name__)
            return None

    def _fetch_secret(self, ns: str, name: str):
        try:
            return self.clientset.client_for("Secret").get(name, ns).data
        except Exception as e:  # noqa: BLE001 — missing source: keep last payload
            logger.debug("%s: secret %s/%s unavailable (%s); keeping last "
                         "payload", self.node_name, ns, name,
                         type(e).__name__)
            return None

    def _rootfs_path(self, pod_key: str, container: str, path: str):
        """Resolve a cp path inside the container's real rootfs; None for
        escapes (.. traversal must not reach the host)."""
        import os

        rootfs = self.containers.rootfs(pod_key, container)
        full = os.path.normpath(os.path.join(rootfs, path.lstrip("/")))
        # separator-anchored: "../rootfs-evil/x" normalizes to a SIBLING
        # whose name merely starts with "rootfs" and must not pass
        if full != rootfs and not full.startswith(rootfs + os.sep):
            return None
        return full

    def _read_rootfs_file(self, pod_key: str, container: str, path: str):
        full = self._rootfs_path(pod_key, container, path)
        if full is None:
            return None
        try:
            with open(full, "rb") as f:
                return f.read()
        except OSError:
            return None

    def _write_rootfs_file(self, pod_key: str, container: str, path: str,
                           data: bytes) -> bool:
        import os

        full = self._rootfs_path(pod_key, container, path)
        if full is None:
            return False
        try:
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)
            return True
        except OSError:
            return False

    # -- stats (pkg/kubelet/server/stats/summary.go) -----------------------
    def stats_summary(self) -> dict:
        """The kubelet stats-summary document the metrics pipeline
        scrapes (HPA metrics client, ``kubectl top``).  Real containers
        report kernel-observed RSS + cumulative CPU from /proc; hollow
        pods report the scripted cadvisor signal."""
        scripted = self.runtime.pod_memory_usage
        pods = []
        for p in self._my_pods():
            key = p.meta.key
            entry = {
                "podRef": {"namespace": p.meta.namespace, "name": p.meta.name},
                "memory": {"usageBytes": scripted.get(key, 0)},
            }
            if self.containers is not None:
                u = self.containers.usage(key)
                if u["memoryBytes"] or u["cpuMillis"]:
                    entry["memory"] = {"usageBytes": u["memoryBytes"]}
                    entry["cpu"] = {"cumulativeCpuMillis": u["cpuMillis"]}
            pods.append(entry)
        return {"node": {"nodeName": self.node_name}, "pods": pods}

    # -- registration (kubelet_node_status.go registerWithApiserver) -------
    def register(self) -> None:
        labels = dict(self.labels)
        labels.setdefault(api.HOSTNAME_LABEL, self.node_name)
        kubelet_url = self.server.url if self.server is not None else ""
        node = api.Node(
            meta=ObjectMeta(name=self.node_name, namespace="", labels=labels),
            status=api.NodeStatus(
                capacity={
                    api.CPU: api.Quantity(self.cpu),
                    api.MEMORY: api.Quantity(self.memory),
                    api.PODS: api.Quantity(self.pods),
                },
                # allocatable = capacity − system-reserved − kube-reserved
                # (container_manager_linux.go GetNodeAllocatable) — what
                # the scheduler budgets against
                allocatable={
                    api.CPU: api.Quantity(f"{self.cm.allocatable_cpu}m"),
                    api.MEMORY: api.Quantity(str(self.cm.allocatable_memory)),
                    api.PODS: api.Quantity(self.pods),
                },
                conditions=[
                    api.NodeCondition(
                        type=api.NODE_READY, status="True", heartbeat_time=self._clock()
                    )
                ],
                kubelet_url=kubelet_url,
            ),
        )
        try:
            self.clientset.nodes.create(node)
        except AlreadyExistsError:
            self._heartbeat(force=True)

    def _my_pods(self) -> list[api.Pod]:
        if self.pod_index is not None:
            return self.pod_index.pods_on(self.node_name)
        store = self.clientset.store
        if getattr(store, "base_url", None) is not None:
            # remote node: server-side fieldSelector (the real kubelet's
            # spec.nodeName= list) — never pull the whole cluster per node
            items, _ = store.list("Pod", None,
                                  field_selector=f"spec.nodeName={self.node_name}")
            return [api.Pod.from_dict(d) for d in items]
        return [
            p for p in self.clientset.pods.list()[0] if p.spec.node_name == self.node_name
        ]

    # -- static pods (pkg/kubelet/config file source + mirror pods) --------
    def _sync_static_pods(self, existing_keys: set) -> bool:
        """Manifests from ``static_pod_dir`` and/or ``manifest_url`` run
        on this node without a scheduler (how kubeadm self-hosts the
        control plane): each one becomes a pod named ``<name>-<node>``
        bound here and MIRRORED into the API
        (``kubernetes.io/config.mirror``) for visibility.  The source is
        the truth — edits recreate the pod (change detection by CONTENT
        hash, never mtime: the reference hashes the manifest, and mtime
        granularity would miss same-second rewrites), removal stops it,
        and a deleted mirror is re-created.  ``existing_keys`` is this
        tick's node pod listing, so steady state costs no extra API
        reads.  Returns True when anything changed (the caller refetches
        its pod list)."""
        import hashlib
        import logging

        log = logging.getLogger("kubernetes_tpu_torch.kubelet")
        present: dict[str, tuple[str, str]] = {}  # source -> (content hash, key)
        changed = False
        # sources: every manifest file in the dir, plus the manifest URL
        # (config/file.go + config/http.go merged into one update stream)
        sources: list[tuple[str, Optional[bytes]]] = []
        if self.static_pod_dir is not None:
            dir_sources = self._static_dir_sources()
            if dir_sources is None:
                # a transiently unreadable DIR must not read as "every
                # manifest removed": carry all previously-seen file
                # sources unchanged (same contract as a per-file race)
                sources.extend(
                    (p, None) for p in self._static_seen
                    if p != self.manifest_url)
            else:
                sources.extend(dir_sources)
        if self.manifest_url:
            # poll at http_check_frequency, not per tick: a slow or
            # blackholed URL must not stall probes/restarts every cycle
            now = self._clock()
            if now - self._last_url_fetch >= self.http_check_frequency:
                self._last_url_fetch = now
                import urllib.request

                try:
                    with urllib.request.urlopen(self.manifest_url,
                                                timeout=5) as r:
                        self._last_url_body = r.read()
                except Exception:  # noqa: BLE001 — an unreachable URL
                    # keeps the last incarnation, like an unreadable file
                    self._last_url_body = None
            sources.append((self.manifest_url, self._last_url_body))
        for path, raw in sources:
            prev = self._static_seen.get(path)
            if raw is None:
                if prev is not None:
                    present[path] = prev
                continue
            digest = hashlib.sha256(raw).hexdigest()
            if prev is not None and prev[0] == digest:
                if prev[1] in existing_keys:
                    present[path] = prev
                    continue
                # mirror deleted out from under us: the FILE outranks the
                # API — forget the runtime incarnation and recreate
                self.pod_manager.forget(prev[1])
                prev = None
            pod = self._parse_static_manifest(
                raw, "http" if path == self.manifest_url else "file",
                origin=path)
            if pod is None:
                if prev is not None:
                    present[path] = prev
                continue
            key = pod.meta.key
            if prev is not None and prev[1] != key:
                self._delete_mirror(prev[1])  # renamed in the file
                changed = True
            if prev is not None and prev[1] == key:
                # changed manifest: recreate with the new spec
                self._delete_mirror(key)
                self.pod_manager.forget(key)
            try:
                self.clientset.pods.create(pod)
                changed = True
            except AlreadyExistsError:
                # NEVER steal a non-mirror pod: a user pod that happens to
                # share the name keeps running and the manifest is skipped
                # (real mirror-pod handling verifies the annotation too)
                if not self._is_our_mirror(key):
                    log.warning(
                        "static pod %s collides with an existing non-static "
                        "pod; manifest %s skipped", key, path)
                    continue
                self._delete_mirror(key)
                self.pod_manager.forget(key)
                try:
                    self.clientset.pods.create(pod)
                    changed = True
                except AlreadyExistsError:
                    pass
            present[path] = (digest, key)
        for path, (_, key) in self._static_seen.items():
            if path not in present and key:
                self._delete_mirror(key)  # manifest removed
                changed = True
        self._static_seen = present
        return changed

    def _parse_static_manifest(self, raw: bytes, source: str,
                               origin: str = ""):
        """Manifest bytes -> the static pod with the reference identity
        (``<name>-<nodename>``, bound here, mirror annotations); None on
        a bad manifest (warned with the parse error — during self-hosted
        bootstrap these manifests ARE the control plane)."""
        import logging

        import yaml as _yaml

        try:
            pod = api.Pod.from_dict(_yaml.safe_load(raw.decode()))
            if not pod.meta.name:
                raise ValueError("manifest has no metadata.name")
        except Exception as e:  # noqa: BLE001 — a bad manifest must not
            # take down the sync loop
            logging.getLogger("kubernetes_tpu_torch.kubelet").warning(
                "static pod manifest %s unreadable: %s", origin or source, e)
            return None
        pod.meta.name = f"{pod.meta.name}-{self.node_name}"
        pod.spec.node_name = self.node_name
        pod.meta.annotations["kubernetes.io/config.mirror"] = "true"
        pod.meta.annotations["kubernetes.io/config.source"] = source
        return pod

    def _static_dir_sources(self) -> list:
        """The file half of the static-pod source walk: every manifest
        file as ``(path, bytes | None)`` — None marks a transiently
        unreadable file (callers must carry the prior incarnation, never
        treat it as removed).  An unreadable DIR yields None so callers
        can apply the same carry-over rule to every known file source."""
        import os

        try:
            entries = sorted(os.listdir(self.static_pod_dir))
        except OSError:
            return None
        sources = []
        for fname in entries:
            if not fname.endswith((".yaml", ".yml", ".json")):
                continue
            path = os.path.join(self.static_pod_dir, fname)
            try:
                with open(path, "rb") as f:
                    sources.append((path, f.read()))
            except OSError:
                # a write-rename race or transient permission error must
                # not read as "manifest removed"
                sources.append((path, None))
        return sources

    def standalone_static_tick(self) -> int:
        """Static pods WITHOUT an apiserver: the kubeadm bootstrap state,
        where the control-plane kubelet must run its manifest dir (the
        apiserver's own pod included) before any API exists (reference
        kubelet standalone mode, ``config/file.go`` with no api source).
        Containers start through the same runtime manager the API path
        uses, so when the API comes up the mirror-pod flow ADOPTS the
        already-running processes instead of restarting them.  Returns
        how many manifests are being enforced."""
        if self.static_pod_dir is None:
            return 0
        n = 0
        for path, raw in (self._static_dir_sources() or []):
            if raw is None:
                continue
            pod = self._parse_static_manifest(raw, "file", origin=path)
            if pod is None:
                continue
            # sync_pod starts the containers and restarts dead ones per
            # restartPolicy — the standalone crash-loop that keeps the
            # apiserver container retrying until it binds its port
            self.pod_manager.sync_pod(pod)
            n += 1
        return n

    def _is_our_mirror(self, pod_key: str) -> bool:
        ns, name = pod_key.split("/", 1)
        try:
            cur = self.clientset.pods.get(name, ns)
        except NotFoundError:
            return False
        return (cur.meta.annotations.get("kubernetes.io/config.mirror") == "true"
                and cur.spec.node_name == self.node_name)

    def _delete_mirror(self, pod_key: str) -> None:
        ns, name = pod_key.split("/", 1)
        try:
            self.clientset.pods.delete(name, ns)
        except NotFoundError:
            pass

    # -- the sync tick -----------------------------------------------------
    def tick(self) -> dict:
        """One syncLoop iteration: heartbeat if due, admit newly-bound pods,
        transition starting pods to Running after the start latency, run
        probes/restarts, then the eviction manager pass."""
        now = self._clock()
        out = {"started": 0, "observed": 0, "restarts": 0, "evicted": 0}
        self._maybe_apply_dynamic_config()
        self._heartbeat()

        mine = self._my_pods()
        if self.static_pod_dir is not None or self.manifest_url:
            if self._sync_static_pods({p.meta.key for p in mine}):
                mine = self._my_pods()  # mirrors changed: refresh the view
        live = {p.meta.key for p in mine}
        # volume manager pass (reconciler.go:165): pods with PVC-backed
        # volumes may only start once attach + mount complete
        pvc_to_pv = self._pvc_to_pv(mine)
        if pvc_to_pv is not None or self.volume_manager.has_state():
            # the second arm: departed pods must still UNMOUNT (and clear
            # volumesInUse) even when no remaining pod needs volumes
            attached = self._attached_volumes()
            self.volume_manager.sync(mine, attached, pvc_to_pv or {})
            self._report_volumes_in_use()
        running: list[api.Pod] = []
        started_keys: set[str] = set()
        for pod in mine:
            if pod.status.phase == api.RUNNING:
                running.append(pod)
                continue
            if pod.status.phase != api.PENDING:
                continue
            key = pod.meta.key
            if key not in self._starting:
                # node-side admission over allocatable (the kubelet's
                # canAdmitPod backstop): a pod that does not fit is
                # REJECTED here regardless of the scheduler's view.
                # add_pod (not bare admit) so the requests RESERVE
                # immediately — N pods admitted in one tick must each see
                # the previous ones' debits, or they all pass
                try:
                    self.cm.add_pod(pod)
                except AdmissionRejected as e:
                    self._reject_pod(pod, e)
                    out["rejected"] = out.get("rejected", 0) + 1
                    continue
                self._starting[key] = now
                out["observed"] += 1
            elif now - self._starting[key] >= self.pod_start_latency:
                if pvc_to_pv is not None and not self.volume_manager.pod_volumes_ready(
                    pod, pvc_to_pv
                ):
                    continue  # WaitForAttachAndMount: stay Pending
                if self._set_running(pod, now):
                    out["started"] += 1
                    started_keys.add(key)
                    self.images.ensure_pulled(pod)
                del self._starting[key]
        self._starting = {k: t for k, t in self._starting.items() if k in live}

        out["restarts"], still_running = self._sync_running(running)
        for gone in self.pod_manager.known() - live:
            self.pod_manager.forget(gone)
        # resource-ledger hygiene: pods that left the runtime release
        # their cgroup + image references (admitted-but-starting pods
        # keep their reservation — that's the point of admitting early)
        running_now = {p.meta.key for p in still_running} | started_keys
        for gone in self.cm.known() - running_now - set(self._starting):
            self.cm.remove_pod(gone)
            self.images.release(gone)
        # CNI DEL: release address leases for departed pods so the range
        # recycles (a churning node must not exhaust its /24)
        if self.network is not None:
            for gone in self.network.leased() - running_now:
                self.network.teardown_pod(gone)
        # pods observed ALREADY running (kubelet restart recovery) join
        # the ledger without re-admission — and their existing addresses
        # are adopted into the network plugin so a fresh process cannot
        # lease a running pod's IP to a newcomer
        for pod in still_running:
            if pod.meta.key not in self.cm.known():
                self.cm.add_pod(pod, force=True)
                self.images.ensure_pulled(pod)
            if (pod.status.pod_ip and not pod.spec.host_network
                    and self._network().pod_ip(pod.meta.key) is None):
                self.network.adopt(pod.meta.key, pod.status.pod_ip)
        # PLEG relist: out-of-band sandbox deaths surface as events; a
        # Running pod whose pause process was killed behind our back gets
        # its sandbox restarted (kuberuntime SyncPod recreates the
        # sandbox when the runtime lost it)
        out["pleg_events"] = 0
        out["sandbox_restarts"] = 0
        for ev in self.pleg.relist():
            out["pleg_events"] += 1
            if ev.type == "SandboxDied" and ev.pod_key in running_now:
                if self.sandboxes is not None:
                    self.sandboxes.remove(ev.pod_key)  # reap the corpse
                    self.sandboxes.create(ev.pod_key)
                    out["sandbox_restarts"] += 1
        evicted_keys = self._eviction_pass(still_running)
        out["evicted"] = len(evicted_keys)
        for key in evicted_keys:
            self.cm.remove_pod(key)
            self.images.release(key)
            if self.network is not None:
                self.network.teardown_pod(key)
        # image GC at its own cadence; failure to reach the low target
        # raises the disk-pressure signal
        if now - self._last_image_gc >= self.image_gc_period:
            self._last_image_gc = now
            gc = self.images.garbage_collect()
            self._set_disk_pressure_condition(gc["over"])
        if self.sandboxes is not None:
            # sandboxes exist exactly while the pod is Running (incl. pods
            # started THIS tick, excl. pods evicted this tick): a pod that
            # went Succeeded/Failed/Evicted leaves the set and its pause
            # process is stopped NOW, not at object deletion (the
            # reference stops the sandbox on pod termination)
            running_keys = ({p.meta.key for p in still_running}
                            | started_keys) - evicted_keys
            for key in running_keys:
                self.sandboxes.create(key)
            for gone in self.sandboxes.known() - running_keys:
                self.sandboxes.remove(gone)
        return out

    def _sync_running(self, running: list[api.Pod]) -> tuple[int, list[api.Pod]]:
        """Prober + restart-policy pass; pushes status only on change.
        Returns pods still running — a pod that went terminal this tick
        must not be re-ranked by the eviction pass."""
        restarts = 0
        still_running: list[api.Pod] = []
        for pod in running:
            outcome, statuses, all_ready = self.pod_manager.sync_pod(pod)
            prev = pod.status
            new_restarts = sum(s.restart_count for s in statuses) - sum(
                s.restart_count for s in prev.container_statuses
            )
            restarts += max(0, new_restarts)
            phase = {
                "running": api.RUNNING,
                "succeeded": api.SUCCEEDED,
                "failed": api.FAILED,
            }[outcome]
            if outcome == "running":
                still_running.append(pod)
            else:
                self.pod_manager.forget(pod.meta.key)
            prev_ready = any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in prev.conditions
            )
            changed = (
                phase != prev.phase
                or all_ready != prev_ready
                or [s.to_dict() for s in statuses]
                != [s.to_dict() for s in prev.container_statuses]
            )
            if not changed:
                continue
            update = api.Pod.from_dict(pod.to_dict())
            update.status.phase = phase
            update.status.container_statuses = statuses
            conds = [c for c in update.status.conditions if c.get("type") != "Ready"]
            conds.append({"type": "Ready", "status": "True" if all_ready else "False"})
            update.status.conditions = conds
            try:
                self.clientset.pods.update_status(update)
            except (NotFoundError, ConflictError):
                continue
        return restarts, still_running

    # tunables a ConfigMap may override (reference KubeletConfiguration
    # fields this hollow node actually consumes)
    _DYNAMIC_FIELDS = {
        "podStartLatency": ("pod_start_latency", float),
        "heartbeatInterval": ("heartbeat_interval", float),
        "memoryPressureFraction": ("memory_pressure_fraction", float),
    }

    def _maybe_apply_dynamic_config(self) -> None:
        """Dynamic kubelet config (reference ``kubelet/kubeletconfig``,
        gated by DynamicKubeletConfig): a ConfigMap named
        ``kubelet-config-<node>`` in kube-system overrides the node's
        tunables live; deleting it (or a field going invalid) rolls back
        to the boot values.  Polled at heartbeat cadence, never per tick
        — a 5k-node fleet must not turn the gate into 5k GETs/s."""
        if not DEFAULT_FEATURE_GATES.enabled("DynamicKubeletConfig"):
            return
        if not hasattr(self, "_boot_config"):
            self._boot_config = {attr: getattr(self, attr)
                                 for attr, _ in self._DYNAMIC_FIELDS.values()}
            self._config_rv = None
            self._last_config_check = None
        now = self._clock()
        # throttle on the BOOT heartbeat interval: a ConfigMap that raises
        # heartbeatInterval must not lock out its own rollback
        if (self._last_config_check is not None
                and now - self._last_config_check
                < self._boot_config["heartbeat_interval"]):
            return
        self._last_config_check = now
        try:
            cm = self.clientset.client_for("ConfigMap").get(
                f"kubelet-config-{self.node_name}", "kube-system")
        except NotFoundError:
            if self._config_rv is not None:
                # roll back ONLY when an override was actually applied —
                # never clobber harness-set attributes in the normal
                # no-ConfigMap fleet state
                for attr, value in self._boot_config.items():
                    setattr(self, attr, value)
                self._config_rv = None
            return
        rv = cm.meta.resource_version
        if rv == self._config_rv:
            return
        for key, (attr, cast) in self._DYNAMIC_FIELDS.items():
            raw = cm.data.get(key)
            if raw is None:
                setattr(self, attr, self._boot_config[attr])
                continue
            try:
                setattr(self, attr, cast(raw))
            except (TypeError, ValueError):
                # an invalid value must not keep a STALE prior override
                setattr(self, attr, self._boot_config[attr])
        self._config_rv = rv

    def _eviction_pass(self, running: list[api.Pod]) -> set:
        """eviction_manager.go:213 synchronize — memory signal vs the
        threshold; rank by QoS then usage; evict until under.  Returns the
        victims' keys so the caller's sandbox reconcile drops their pause
        processes the same tick.

        The signal is ACCOUNTED, not scripted: the cadvisor-feed sample
        (runtime.pod_memory_usage) is charged into each pod's cgroup and
        the decision reads the kubepods rollup (pkg/kubelet/cm)."""
        from .runtime import rank_for_eviction

        usage = self.runtime.pod_memory_usage
        self.cm.charge_usage(usage)
        used = self.cm.node_usage()
        threshold = self._memory_capacity * self.memory_pressure_fraction
        under_pressure = used > threshold
        self._set_pressure_condition(under_pressure)
        evicted: set = set()
        if not under_pressure:
            return evicted
        for victim in rank_for_eviction(running, usage):
            if used <= threshold:
                break
            update = api.Pod.from_dict(victim.to_dict())
            update.status.phase = api.FAILED
            update.status.reason = "Evicted"
            try:
                self.clientset.pods.update_status(update)
            except (NotFoundError, ConflictError):
                continue
            used -= usage.get(victim.meta.key, 0)
            self.pod_manager.forget(victim.meta.key)
            evicted.add(victim.meta.key)
        return evicted

    def _pvc_to_pv(self, mine: list[api.Pod]):
        """ns/claim -> bound PV name, or None when no pod needs volumes
        (skips the PVC list entirely — the common case)."""
        if not any(v.pvc_name for p in mine for v in p.spec.volumes):
            return None
        out = {}
        for pvc in self.clientset.persistentvolumeclaims.list(None)[0]:
            if pvc.volume_name:
                out[pvc.meta.key] = pvc.volume_name
        return out

    def _attached_volumes(self) -> set:
        try:
            node = self.clientset.nodes.get(self.node_name)
        except NotFoundError:
            return set()
        return set(node.status.volumes_attached)

    def _report_volumes_in_use(self) -> None:
        in_use = self.volume_manager.volumes_in_use()
        if in_use == self._last_in_use:
            return

        def _mutate(cur: api.Node) -> api.Node:
            cur.status.volumes_in_use = list(in_use)
            return cur

        try:
            self.clientset.nodes.guaranteed_update(self.node_name, _mutate, "")
            self._last_in_use = in_use
        except NotFoundError:
            pass

    def _reject_pod(self, pod: api.Pod, err) -> None:
        """kubelet admission failure: phase Failed, reason OutOf<res>
        (the reference's lifecycle.PodAdmitResult rejection path)."""
        update = api.Pod.from_dict(pod.to_dict())
        update.status.phase = api.FAILED
        update.status.reason = f"OutOf{err.resource}"
        try:
            self.clientset.pods.update_status(update)
        except (NotFoundError, ConflictError):
            pass

    def _set_disk_pressure_condition(self, pressure: bool) -> None:
        if pressure == getattr(self, "_last_disk_pressure", False):
            return
        want = "True" if pressure else "False"

        def _mutate(cur: api.Node) -> api.Node:
            c = cur.status.condition(api.NODE_DISK_PRESSURE)
            if c is None:
                if not pressure:
                    return cur
                c = api.NodeCondition(type=api.NODE_DISK_PRESSURE)
                cur.status.conditions.append(c)
            c.status = want
            return cur

        try:
            self.clientset.nodes.guaranteed_update(self.node_name, _mutate, "")
            self._last_disk_pressure = pressure
        except NotFoundError:
            pass

    def _set_pressure_condition(self, pressure: bool) -> None:
        # this kubelet exclusively owns its node's pressure condition, so
        # the last pushed value is authoritative — no read needed
        if pressure == getattr(self, "_last_pressure", False):
            return
        want = "True" if pressure else "False"

        def _mutate(cur: api.Node) -> api.Node:
            c = cur.status.condition(api.NODE_MEMORY_PRESSURE)
            if c is None:
                if not pressure:
                    return cur
                c = api.NodeCondition(type=api.NODE_MEMORY_PRESSURE)
                cur.status.conditions.append(c)
            c.status = want
            return cur

        try:
            self.clientset.nodes.guaranteed_update(self.node_name, _mutate, "")
            self._last_pressure = pressure
        except NotFoundError:
            pass

    def _set_running(self, pod: api.Pod, now: float) -> bool:
        # pod may be a shared informer-cache object (PodNodeIndex path):
        # never mutate it — build the status update on a private copy
        update = api.Pod.from_dict(pod.to_dict())
        update.status.phase = api.RUNNING
        update.status.host_ip = self.node_name
        if not update.status.pod_ip:
            # the CNI ADD step of pod startup (pkg/kubelet/network): the
            # plugin leases an address the moment the sandbox runs;
            # failure keeps the pod Pending, like a failed CNI ADD
            if pod.spec.host_network:
                update.status.pod_ip = self.node_name
            else:
                from .network import NetworkSetupError

                try:
                    update.status.pod_ip = self._network().setup_pod(pod.meta.key)
                except NetworkSetupError:
                    return False
        try:
            self.clientset.pods.update_status(update)
            return True
        except (NotFoundError, ConflictError):
            if not pod.spec.host_network and self.network is not None:
                self.network.teardown_pod(pod.meta.key)  # lease back
            return False

    def _network(self):
        """The network plugin, built on first use so the node's ALLOCATED
        podCIDR (IPAM controller) wins over the hash fallback.  While the
        plugin is still on the fallback base AND has leased nothing, each
        call re-checks the node — a CIDR that lands after the first probe
        (IPAM races pod starts) still takes effect before any address
        goes out under the hash base."""
        from .network import KubenetPlugin

        needs_probe = (self.network is None
                       or (not self.network.has_cidr
                           and not self.network.leased()))
        if needs_probe:
            cidr = ""
            try:
                cidr = self.clientset.nodes.get(self.node_name).spec.pod_cidr
            except Exception as e:  # noqa: BLE001 - fall through to the hash base
                logger.debug("%s: podCIDR probe failed (%s); using hash "
                             "fallback base", self.node_name,
                             type(e).__name__)
            if self.network is None or (cidr and "/" in cidr):
                self.network = KubenetPlugin(self.node_name, cidr)
        return self.network

    def _heartbeat(self, force: bool = False) -> None:
        now = self._clock()
        if not force and now - self._last_heartbeat < self.heartbeat_interval:
            return
        self._last_heartbeat = now

        def _mutate(cur: api.Node) -> api.Node:
            c = cur.status.condition(api.NODE_READY)
            if c is None:
                c = api.NodeCondition(type=api.NODE_READY)
                cur.status.conditions.append(c)
            c.status = "True"
            c.heartbeat_time = now
            c.heartbeat_revision = cur.meta.resource_version
            # a restarted kubelet binds a fresh port: the endpoint must
            # follow the heartbeat, not only initial registration
            if self.server is not None:
                cur.status.kubelet_url = self.server.url
            # and volumesInUse is always THIS process's truth — a restart
            # clears stale mounts so the AD controller can detach
            cur.status.volumes_in_use = self.volume_manager.volumes_in_use()
            return cur

        # one CAS write on the node as the last heartbeat left it; the GET
        # and write of guaranteed_update only once another writer changed
        # it (a conflict).  The JAX kubelet GETs before every heartbeat,
        # which at 5000 nodes is half of the apiserver's requests.
        if self._node is not None:
            try:
                self._node = self.clientset.nodes.update(_mutate(self._node))
                return
            except ConflictError:
                pass
            except NotFoundError:
                self._node = None
                self.register()
                return
        try:
            self._node = self.clientset.nodes.guaranteed_update(self.node_name, _mutate, "")
        except NotFoundError:
            self._node = None
            self.register()


class HollowFleet:
    """N hollow kubelets against one control plane (start-kubemark.sh),
    sharing one pod informer + by-node index."""

    def __init__(
        self,
        clientset: Clientset,
        n: int,
        clock: Callable[[], float] = time.monotonic,
        **kubelet_kw,
    ):
        self.informer = SharedInformer(clientset.pods)
        self.index = PodNodeIndex(self.informer)
        self.kubelets = [
            HollowKubelet(
                clientset, f"hollow-{i:05d}", pod_index=self.index, clock=clock, **kubelet_kw
            )
            for i in range(n)
        ]

    def register_all(self) -> None:
        for k in self.kubelets:
            k.register()
        self.informer.start_manual()

    def heartbeat_overdue(self) -> int:
        """Heartbeat now every kubelet whose last heartbeat is twice its
        interval old or older; returns how many did."""
        n = 0
        for k in self.kubelets:
            if k._clock() - k._last_heartbeat >= 2 * k.heartbeat_interval:
                k._heartbeat(force=True)
                n += 1
        return n

    def tick_all(self, stop: Callable[[], bool] = lambda: False,
                 counters: Optional[dict] = None) -> dict:
        """One informer pump, then every kubelet's ``tick()``; returns the
        ticks' summed ``started``/``observed``/``restarts``/``evicted``,
        and sums every counter of every tick into ``counters`` when given.
        After every 50 kubelets the overdue ones heartbeat first
        (``heartbeat_overdue``): the reference kubelet's status loop runs
        on its own timer, not behind its pod sync, so a node of a large
        fleet does not wait a whole tick for its heartbeat (the JAX fleet
        has no such pass).  Stops between two kubelets once ``stop()``."""
        self.informer.pump()
        total = {"started": 0, "observed": 0, "restarts": 0, "evicted": 0}
        counters = {} if counters is None else counters
        for i, k in enumerate(self.kubelets):
            if stop():
                break
            if i and i % 50 == 0:
                self.heartbeat_overdue()
            for key, v in k.tick().items():
                counters[key] = counters.get(key, 0) + v
                if key in total:
                    total[key] += v
        return total


class HollowWatcher:
    """Kubemark-shaped hollow WATCHER (the serving-tier analogue of
    :class:`HollowKubelet`): a real watch stream feeding a minimal
    informer cache (key → resourceVersion) with no controller
    underneath.  Thread-cheap by construction — no thread, no typed
    decode, no handler fan-out; the fleet's caller pumps it cooperatively
    — so 10k+ of them fit in one process, which is how many-client
    fan-out behavior is tested on one machine (the kubemark trick,
    applied to watch traffic instead of nodes).

    Works over any watch with ``get(timeout)``/``stop()`` and the
    event/frame duck types: the in-process ``Store.watch`` queue or a
    ``RemoteWatch`` HTTP stream.  Applies the same revision fence as
    ``SharedInformer`` (stale deliveries skipped), so its final cache is
    exactly the state-equivalence surface the fleet bench gates on."""

    __slots__ = ("id", "watch", "cache", "applied_rev", "deliveries",
                 "event_units", "gaps", "tracker")

    def __init__(self, client_id: str, watch, tracker=None):
        from ..utils.fanout import WatchFanoutTracker  # noqa: F401 (typing aid)

        self.id = client_id
        self.watch = watch
        # bounded: one int per live object key (the hollow informer cache)
        self.cache: dict = {}
        self.applied_rev = 0
        self.deliveries = 0   # queue items consumed (a frame counts 1)
        self.event_units = 0  # events represented (a frame counts len())
        self.gaps = 0
        self.tracker = tracker
        if tracker is not None:
            tracker.register(client_id)

    def pump(self, budget: Optional[int] = None) -> int:
        """Drain up to ``budget`` queued deliveries (None = everything
        waiting) and report the applied revision to the tracker once per
        pump, not per item — the fan-out hot path stays two dict ops."""
        from ..store.frames import FRAME
        from ..store.store import DELETED, WATCH_GAP

        n = 0
        while budget is None or n < budget:
            item = self.watch.get(timeout=0)
            if item is None:
                break
            t = item.type
            if t == FRAME:
                fence = self.applied_rev
                for i in range(len(item.keys)):
                    rev = item.revisions[i]
                    if rev <= fence:
                        continue  # straggler inside a superseded frame
                    if item.types[i] == DELETED:
                        self.cache.pop(item.keys[i], None)
                    else:
                        self.cache[item.keys[i]] = rev
                if item.revision > self.applied_rev:
                    self.applied_rev = item.revision
                self.event_units += len(item.keys)
            elif t == WATCH_GAP:
                # continuity lost (410 analogue): a hollow watcher has no
                # lister to rebuild from — count it; the fleet bench
                # treats any gapped client as dropped-state
                self.gaps += 1
            else:
                if item.revision <= self.applied_rev:
                    n += 1
                    continue  # revision fence, as SharedInformer applies it
                if t == DELETED:
                    self.cache.pop(item.key, None)
                else:
                    self.cache[item.key] = item.revision
                self.applied_rev = item.revision
                self.event_units += 1
            self.deliveries += 1
            n += 1
        if n and self.tracker is not None:
            self.tracker.report(self.id, self.applied_rev)
        return n

    def stop(self) -> None:
        self.watch.stop()
        if self.tracker is not None:
            self.tracker.unregister(self.id)


class HollowWatcherFleet:
    """N hollow watchers on one watch source — the many-client axis of
    the serving-tier bench.  ``source`` is anything with
    ``watch(kind, frames=...)`` (a ``Store`` or a ``RemoteStore``); the
    caller drives ``pump_all`` from however many threads it wants (the
    watchers are partitionable by slice — no shared mutable state
    between them beyond the tracker's locked dict)."""

    def __init__(self, source, n: int, kind: str = "Pod",
                 frames: bool = True, tracker=None, prefix: str = "hw",
                 from_revision: Optional[int] = None):
        self.tracker = tracker
        self.watchers = [
            HollowWatcher(
                f"{prefix}-{i:05d}",
                source.watch(kind, from_revision=from_revision,
                             frames=frames),
                tracker,
            )
            for i in range(n)
        ]

    def pump_all(self, budget: Optional[int] = None) -> int:
        return sum(w.pump(budget) for w in self.watchers)

    def converged(self, head: int) -> int:
        """How many watchers have applied everything up to ``head``."""
        return sum(1 for w in self.watchers if w.applied_rev >= head)

    def stop_all(self) -> None:
        for w in self.watchers:
            w.stop()
