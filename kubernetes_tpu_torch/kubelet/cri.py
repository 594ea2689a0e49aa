"""CRI: the Container Runtime Interface seam.

Capability of the reference's CRI layer (``pkg/kubelet/apis/cri/
services.go`` RuntimeService/ImageService, the ``v1alpha1/runtime``
gRPC proto, and ``pkg/kubelet/remote`` — the client the kubelet dials a
runtime daemon with).  Three pieces:

- :class:`RuntimeService` / :class:`ImageService` — the interface the
  kubelet programs containers through, runtime-agnostic.
- :class:`LocalCRI` — in-process implementation over the scriptable
  FakeRuntime + (optionally) real pause sandboxes: the dockershim slot.
- :class:`CRIServer` + :class:`RemoteCRI` — the same interface served
  over HTTP and dialed remotely (the ``remote/`` gRPC analogue), so a
  runtime can live in its own process exactly like dockerd did.
"""

from __future__ import annotations

import json
import threading
from typing import Optional


class RuntimeService:
    """``cri/services.go`` RuntimeService (sandbox + container halves)."""

    def run_pod_sandbox(self, pod_key: str) -> str:
        raise NotImplementedError

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        raise NotImplementedError

    def create_container(self, sandbox_id: str, name: str, image: str,
                         command: Optional[list[str]] = None,
                         env: Optional[dict] = None) -> str:
        raise NotImplementedError

    def start_container(self, container_id: str) -> None:
        raise NotImplementedError

    def stop_container(self, container_id: str) -> None:
        raise NotImplementedError

    def list_containers(self, sandbox_id: Optional[str] = None) -> list[dict]:
        raise NotImplementedError

    def exec_sync(self, container_id: str, command: list[str]) -> tuple[str, int]:
        raise NotImplementedError


class ImageService:
    """``cri/services.go`` ImageService."""

    def pull_image(self, image: str) -> str:
        raise NotImplementedError

    def list_images(self) -> list[str]:
        raise NotImplementedError

    def remove_image(self, image: str) -> None:
        raise NotImplementedError


class LocalCRI(RuntimeService, ImageService):
    """In-process runtime over FakeRuntime state (+ real pause processes
    when a sandbox manager is supplied, + REAL container processes when a
    ProcessContainerManager is supplied) — the dockershim of this stack.

    With ``processes`` set, CreateContainer records the spec,
    StartContainer forks the actual child (fork/exec), StopContainer
    signals it, ExecSync runs a real command in its context, and
    ListContainers reports kernel-observed state + pid."""

    def __init__(self, runtime=None, sandboxes=None, processes=None):
        from .runtime import FakeRuntime

        self.runtime = runtime or FakeRuntime()
        self.sandboxes = sandboxes  # ProcessSandboxManager | None
        self.processes = processes  # ProcessContainerManager | None
        self._mu = threading.Lock()
        self._containers: dict[str, dict] = {}  # id -> {sandbox,name,image,state}
        self._images: set[str] = set()
        self._next = 0

    def _new_id(self, prefix: str) -> str:
        self._next += 1
        return f"{prefix}-{self._next:06d}"

    # -- RuntimeService ----------------------------------------------------
    def run_pod_sandbox(self, pod_key: str) -> str:
        with self._mu:
            if self.sandboxes is not None:
                self.sandboxes.create(pod_key)
            return pod_key  # sandbox id IS the pod key at this depth

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        # signal/wait OUTSIDE the lock: a container trapping SIGTERM can
        # hold the graceful-stop wait for seconds, and every other CRI
        # RPC serializes on _mu
        if self.sandboxes is not None:
            self.sandboxes.remove(sandbox_id)
        if self.processes is not None:
            # containers die with their sandbox (kuberuntime stops
            # workload containers before the sandbox)
            self.processes.remove_pod(sandbox_id)
        with self._mu:
            for cid, c in list(self._containers.items()):
                if c["sandbox"] == sandbox_id:
                    c["state"] = "exited"

    def create_container(self, sandbox_id: str, name: str, image: str,
                         command=None, env=None) -> str:
        with self._mu:
            if image not in self._images:
                raise ValueError(f"image {image!r} not pulled")
            cid = self._new_id("ctr")
            self._containers[cid] = {"sandbox": sandbox_id, "name": name,
                                     "image": image, "state": "created",
                                     "command": list(command or []),
                                     "env": dict(env or {})}
            return cid

    def start_container(self, container_id: str) -> None:
        with self._mu:
            c = self._containers.get(container_id)
            if c is None or c["state"] == "exited":
                raise ValueError(f"cannot start {container_id}")
            if self.processes is not None:
                pid = self.processes.start(
                    c["sandbox"], c["name"],
                    command=c["command"] or None, env=c["env"])
                c["pid"] = pid
            c["state"] = "running"

    def stop_container(self, container_id: str) -> None:
        with self._mu:
            c = self._containers.get(container_id)
            ident = None if c is None else (c["sandbox"], c["name"])
        if ident is not None and self.processes is not None:
            self.processes.stop(*ident)  # TERM/KILL wait outside the lock
        with self._mu:
            c = self._containers.get(container_id)
            if c is not None:
                c["state"] = "exited"

    def list_containers(self, sandbox_id=None) -> list[dict]:
        with self._mu:
            out = []
            for cid, c in self._containers.items():
                if sandbox_id is not None and c["sandbox"] != sandbox_id:
                    continue
                entry = {"id": cid, **c}
                if self.processes is not None and c["state"] == "running":
                    # kernel truth outranks the ledger: a dead process IS
                    # an exited container, however it died.  The exit code
                    # persists in the ledger so pollers that miss the
                    # transition still learn it.
                    if not self.processes.alive(c["sandbox"], c["name"]):
                        c["state"] = "exited"
                        c["exitCode"] = self.processes.exit_code(
                            c["sandbox"], c["name"])
                        entry = {"id": cid, **c}
                out.append(entry)
            return out

    def exec_sync(self, container_id: str, command: list[str]) -> tuple[str, int]:
        with self._mu:
            c = self._containers.get(container_id)
            if c is None or c["state"] != "running":
                raise ValueError(f"container {container_id} not running")
            sandbox, name = c["sandbox"], c["name"]
        if self.processes is not None:
            return self.processes.exec_sync(sandbox, name, command)
        return self.runtime.exec(sandbox, name, command)

    # -- ImageService ------------------------------------------------------
    def pull_image(self, image: str) -> str:
        with self._mu:
            self._images.add(image)
            return image

    def list_images(self) -> list[str]:
        with self._mu:
            return sorted(self._images)

    def remove_image(self, image: str) -> None:
        with self._mu:
            self._images.discard(image)


_METHODS = {
    "RunPodSandbox": ("run_pod_sandbox", ["pod_key"]),
    "StopPodSandbox": ("stop_pod_sandbox", ["sandbox_id"]),
    "CreateContainer": ("create_container", ["sandbox_id", "name", "image",
                                             "command", "env"]),
    "StartContainer": ("start_container", ["container_id"]),
    "StopContainer": ("stop_container", ["container_id"]),
    "ListContainers": ("list_containers", ["sandbox_id"]),
    "ExecSync": ("exec_sync", ["container_id", "command"]),
    "PullImage": ("pull_image", ["image"]),
    "ListImages": ("list_images", []),
    "RemoveImage": ("remove_image", ["image"]),
}


class CRIServer:
    """Serves a RuntimeService+ImageService over HTTP (one POST per RPC —
    the ``v1alpha1/runtime`` gRPC surface's transport analogue)."""

    def __init__(self, cri: LocalCRI, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self
        self.cri = cri

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                method = self.path.strip("/")
                spec = _METHODS.get(method)
                length = int(self.headers.get("Content-Length", 0))
                try:
                    params = json.loads(self.rfile.read(length)) if length else {}
                except ValueError:
                    return self._reply(400, {"error": "bad json"})
                if spec is None:
                    return self._reply(404, {"error": f"no method {method}"})
                fn_name, arg_names = spec
                try:
                    out = getattr(outer.cri, fn_name)(
                        *[params.get(a) for a in arg_names])
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    return self._reply(500, {"error": str(e)})
                return self._reply(200, {"result": out})

            def _reply(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()


class RemoteCRI(RuntimeService, ImageService):
    """Dials a CRIServer (``pkg/kubelet/remote`` RemoteRuntimeService)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _call(self, method: str, **params):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/{method}", data=json.dumps(params).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read()).get("result")
        except urllib.error.HTTPError as e:
            raise ValueError(json.loads(e.read()).get("error", "CRI error"))

    def run_pod_sandbox(self, pod_key):
        return self._call("RunPodSandbox", pod_key=pod_key)

    def stop_pod_sandbox(self, sandbox_id):
        return self._call("StopPodSandbox", sandbox_id=sandbox_id)

    def create_container(self, sandbox_id, name, image, command=None, env=None):
        return self._call("CreateContainer", sandbox_id=sandbox_id,
                          name=name, image=image, command=command, env=env)

    def start_container(self, container_id):
        return self._call("StartContainer", container_id=container_id)

    def stop_container(self, container_id):
        return self._call("StopContainer", container_id=container_id)

    def list_containers(self, sandbox_id=None):
        return self._call("ListContainers", sandbox_id=sandbox_id)

    def exec_sync(self, container_id, command):
        out = self._call("ExecSync", container_id=container_id, command=command)
        return tuple(out)

    def pull_image(self, image):
        return self._call("PullImage", image=image)

    def list_images(self):
        return self._call("ListImages")

    def remove_image(self, image):
        return self._call("RemoveImage", image=image)
