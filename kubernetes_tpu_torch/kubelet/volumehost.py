"""On-disk pod volumes: emptyDir / hostPath / configMap / secret /
downwardAPI materialized in the filesystem.

Capability of the reference's no-cloud volume plugins
(``pkg/volume/empty_dir/empty_dir.go``, ``host_path/``, ``configmap/``,
``secret/``, ``downwardapi/``) and the piece of the mount reconciler
(``pkg/kubelet/volumemanager/reconciler/reconciler.go:165``) they need:
every sync pass makes the on-disk state match the API state.

ConfigMap/secret/downwardAPI volumes use the reference's **atomic
writer** layout (``pkg/volume/util/atomic_writer.go``): payload files
live in a timestamped ``..<ts>`` directory, a ``..data`` symlink points
at the current one, and user-visible keys are symlinks through
``..data/<key>`` — so an update swaps ONE symlink and a reader never
observes a half-written payload.  A container holding the volume open
sees the new content on the next open, exactly like a real projected
volume update.

Container view: each volume mount becomes a symlink at
``<rootfs>/<mountPath>`` pointing into the pod's volume dir, so exec'd
commands resolve ``<mountPath>/key`` naturally (rootfs-relative absolute
paths — the unprivileged stand-in for a bind mount).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
from typing import Callable, Optional

from ..api import types as api

log = logging.getLogger("kubernetes_tpu_torch.kubelet")


def _valid_payload_key(k: str) -> bool:
    """``atomic_writer.go validatePayload``: a key names ONE file in the
    volume dir — reject empty, ``.``/``..``, anything ``..``-prefixed
    (collides with the atomic writer's internal ``..data``/``..<ts>``
    namespace), and any path separator (this flat layout projects each
    key as a single symlink, so traversal and nesting are both out)."""
    return bool(k) and k not in (".", "..") and not k.startswith("..") \
        and "/" not in k and os.sep not in k and not os.path.isabs(k)


class VolumeHost:
    """Materializes local volumes under ``<root>/<pod>/volumes/<name>``."""

    def __init__(self, root: Optional[str] = None,
                 fetch_configmap: Optional[Callable[[str, str], Optional[dict]]] = None,
                 fetch_secret: Optional[Callable[[str, str], Optional[dict]]] = None):
        self._own_root = root is None
        self.root = root or tempfile.mkdtemp(prefix="ktpu-volumes-")
        # name resolvers: (namespace, name) -> data dict | None
        self.fetch_configmap = fetch_configmap or (lambda ns, n: None)
        self.fetch_secret = fetch_secret or (lambda ns, n: None)
        self._mu = threading.Lock()
        self._ts = 0  # monotonic payload-dir counter (the ..<ts> names)
        self._warned_keys: dict[str, frozenset] = {}  # vol_dir -> last bad set
        self.stats = {"mounts": 0, "updates": 0, "unmounts": 0}

    def pod_volumes_dir(self, pod_key: str) -> str:
        return os.path.join(self.root, pod_key.replace("/", "_"), "volumes")

    def volume_path(self, pod_key: str, volume_name: str) -> str:
        return os.path.join(self.pod_volumes_dir(pod_key), volume_name)

    @staticmethod
    def is_local(vol: api.Volume) -> bool:
        return bool(vol.empty_dir or vol.host_path or vol.config_map_name
                    or vol.secret_name or vol.downward_api)

    # -- the reconciler pass -------------------------------------------------
    def sync_pod(self, pod: api.Pod) -> int:
        """Make every local volume of ``pod`` present and current on
        disk; returns how many payloads were (re)written.  Idempotent:
        unchanged payloads are left untouched (symlink flip only when
        content differs)."""
        changed = 0
        for vol in pod.spec.volumes:
            if not self.is_local(vol):
                continue
            path = self.volume_path(pod.meta.key, vol.name)
            if vol.empty_dir:
                if not os.path.isdir(path):
                    os.makedirs(path, exist_ok=True)
                    self.stats["mounts"] += 1
                continue
            if vol.host_path:
                # hostPath: a symlink to the host location (the bind-mount
                # analogue); dangling allowed like type: "" in the reference
                if not os.path.islink(path):
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    os.symlink(vol.host_path, path)
                    self.stats["mounts"] += 1
                continue
            payload = self._payload_for(pod, vol)
            if payload is None:
                continue  # source object missing: keep the last payload
            if self._atomic_write(path, payload):
                changed += 1
        return changed

    def _payload_for(self, pod: api.Pod, vol: api.Volume) -> Optional[dict[str, bytes]]:
        ns = pod.meta.namespace
        if vol.config_map_name:
            data = self.fetch_configmap(ns, vol.config_map_name)
            if data is None:
                return None
            return {k: str(v).encode() for k, v in data.items()}
        if vol.secret_name:
            data = self.fetch_secret(ns, vol.secret_name)
            if data is None:
                return None
            out = {}
            for k, v in data.items():
                out[k] = v if isinstance(v, bytes) else str(v).encode()
            return out
        if vol.downward_api:
            out = {}
            for fname, ref in vol.downward_api.items():
                out[fname] = self._downward_value(pod, ref).encode()
            return out
        return None

    @staticmethod
    def _downward_value(pod: api.Pod, ref: str) -> str:
        """``metadata.name`` / ``metadata.namespace`` /
        ``metadata.labels['k']`` / ``metadata.annotations['k']``
        (the downward API fieldRef subset)."""
        if ref == "metadata.name":
            return pod.meta.name
        if ref == "metadata.namespace":
            return pod.meta.namespace
        for prefix, src in (("metadata.labels['", pod.meta.labels),
                            ("metadata.annotations['", pod.meta.annotations)):
            if ref.startswith(prefix) and ref.endswith("']"):
                return str(src.get(ref[len(prefix):-2], ""))
        return ""

    def _atomic_write(self, vol_dir: str, payload: dict[str, bytes]) -> bool:
        """atomic_writer.go: write ``..<ts>``, flip ``..data``, project
        keys as symlinks.  Returns True when content actually changed."""
        bad = frozenset(k for k in payload if not _valid_payload_key(k))
        if bad:
            if self._warned_keys.get(vol_dir) != bad:  # once per key set,
                self._warned_keys[vol_dir] = bad       # not per sync tick
                log.warning("volume %s: skipping invalid payload key(s) %s",
                            vol_dir, sorted(bad))
            payload = {k: v for k, v in payload.items() if k not in bad}
        else:
            # a payload gone clean re-arms the warning for this dir
            self._warned_keys.pop(vol_dir, None)
        with self._mu:
            os.makedirs(vol_dir, exist_ok=True)
            data_link = os.path.join(vol_dir, "..data")
            current = None
            if os.path.islink(data_link):
                current = {}
                cur_dir = os.path.join(vol_dir, os.readlink(data_link))
                try:
                    for k in os.listdir(cur_dir):
                        with open(os.path.join(cur_dir, k), "rb") as f:
                            current[k] = f.read()
                except OSError:
                    current = None
            if current == payload:
                return False
            self._ts += 1
            ts_name = f"..{self._ts:010d}"
            ts_dir = os.path.join(vol_dir, ts_name)
            os.makedirs(ts_dir, exist_ok=True)
            for k, v in payload.items():
                with open(os.path.join(ts_dir, k), "wb") as f:
                    f.write(v)
            # flip: symlink swap via rename is the atomic step
            tmp_link = os.path.join(vol_dir, "..data_tmp")
            if os.path.islink(tmp_link):
                os.unlink(tmp_link)
            os.symlink(ts_name, tmp_link)
            old_target = os.readlink(data_link) if os.path.islink(data_link) else None
            os.replace(tmp_link, data_link)
            # project keys through ..data (stable across updates)
            for k in payload:
                key_link = os.path.join(vol_dir, k)
                if not os.path.islink(key_link):
                    os.symlink(os.path.join("..data", k), key_link)
            for k in list(os.listdir(vol_dir)):
                if k.startswith(".."):
                    continue
                if k not in payload:
                    os.unlink(os.path.join(vol_dir, k))
            if old_target is not None and old_target != ts_name:
                shutil.rmtree(os.path.join(vol_dir, old_target),
                              ignore_errors=True)
                self.stats["updates"] += 1
            else:
                self.stats["mounts"] += 1
            return True

    # -- container projection ------------------------------------------------
    def project_into_rootfs(self, pod: api.Pod, container: api.Container,
                            rootfs: str) -> None:
        """Symlink each volumeMount at ``<rootfs>/<mountPath>`` (the
        unprivileged bind-mount: commands exec'd with cwd=rootfs resolve
        ``mountPath/key`` through the live volume dir)."""
        by_name = {v.name: v for v in pod.spec.volumes}
        for m in container.volume_mounts:
            vol = by_name.get(m.name)
            if vol is None or not self.is_local(vol):
                continue
            target = self.volume_path(pod.meta.key, m.name)
            link = os.path.normpath(
                os.path.join(rootfs, m.mount_path.lstrip("/")))
            # separator-anchored escape guard: mountPath is API-controlled
            # spec data and a ".."-bearing path must never reach the host
            # (same contract as hollow._rootfs_path for kubectl cp)
            if link == rootfs or not link.startswith(rootfs + os.sep):
                continue
            os.makedirs(os.path.dirname(link), exist_ok=True)
            if os.path.islink(link):
                if os.readlink(link) == target:
                    continue
                os.unlink(link)
            elif os.path.isdir(link):
                shutil.rmtree(link, ignore_errors=True)
            os.symlink(target, link)

    def teardown_pod(self, pod_key: str) -> None:
        pod_dir = os.path.dirname(self.pod_volumes_dir(pod_key))
        if os.path.isdir(pod_dir):
            shutil.rmtree(pod_dir, ignore_errors=True)
            self.stats["unmounts"] += 1
        for d in [d for d in self._warned_keys
                  if d.startswith(pod_dir + os.sep)]:
            self._warned_keys.pop(d)

    def teardown_all(self) -> None:
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)
        self._warned_keys.clear()
