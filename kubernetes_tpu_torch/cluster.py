"""Cluster lifecycle: init / join / up / down (the kubeadm +
local-up-cluster capability, ``cmd/kubeadm`` + ``hack/``).

    python -m kubernetes_tpu_torch.cluster up   --nodes 10        # whole cluster
    python -m kubernetes_tpu_torch.cluster init --port 6443       # control plane
    python -m kubernetes_tpu_torch.cluster join --apiserver URL \
        --token <id>.<secret> --name node-7                       # one hollow node
    python -m kubernetes_tpu_torch.cluster down

``init`` mirrors kubeadm's phases at this control plane's depth: start
the apiserver, create the system namespaces, mint a bootstrap token
Secret, publish the signed ``kube-public/cluster-info`` discovery
document, then start the scheduler and controller manager (leader
elected) and the kube-dns addon. ``join`` performs the token-verified
discovery handshake (fetch cluster-info WITHOUT credentials, verify its
HMAC signature with the shared token — the reference's JWS check) before
starting a kubelet with its hollow kube-proxy.

Where the port differs from the JAX command:

- ``--device cuda|cpu`` (``init``, ``up``; default ``cuda``) is passed to
  the scheduler it starts, which on ``cuda`` exits before it takes its
  lease where there is no card.
- ``init`` returns only once the scheduler is alive and holds its lease,
  and every component it started is still running; otherwise it exits
  non-zero naming the component (a scheduler that found no card must not
  die unseen behind an ``init`` that said the cluster is up).
- Each component writes its output to ``<cluster dir>/logs/<name>.log``
  (``init --cluster-dir``, default ``.kubernetes-tpu-torch``): the scheduler's
  ``{"scheduler_stats": ...}`` line, printed when ``down`` stops it, can be
  read there afterwards.
- ``init --scheduler-healthz-port N`` serves the scheduler's ``/healthz``
  and ``/metrics`` (its kernel launch counters among them) on port N;
  the default, -1, serves none, as the JAX command does.
- Process state lives in ``.kubernetes-tpu-torch-cluster.json``, so that
  ``down`` of one package never stops the other's processes.  ``down``
  stops the apiserver last and waits until each component has exited."""

from __future__ import annotations

import argparse
import json
import os
import secrets as pysecrets
import signal
import subprocess
import sys
import time
import urllib.request

STATE_FILE = ".kubernetes-tpu-torch-cluster.json"
CLUSTER_DIR = ".kubernetes-tpu-torch"
JOIN_DIR_PREFIX = ".kubernetes-tpu-torch-join-"
# how long init waits for the scheduler's lease: on a card it builds or
# loads the fused scan and makes its CUDA context first
START_TIMEOUT_S = 300.0
STOP_TIMEOUT_S = 60.0


def _spawn(logs_dir: str, name: str, mod: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(logs_dir, exist_ok=True)
    with open(os.path.join(logs_dir, f"{name}.log"), "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", mod, *args],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,
        )


def _logs_dir(args) -> str:
    # only init takes --cluster-dir (as the JAX command); join and up use
    # the default
    return os.path.join(os.path.abspath(getattr(args, "cluster_dir", CLUSTER_DIR)), "logs")


def _exited(procs: dict) -> None:
    """Fail naming the first component that has exited."""
    for name, proc in procs.items():
        rc = proc.poll()
        if rc is not None:
            raise SystemExit(f"{name} exited with code {rc} during start-up "
                             f"(its output: logs/{name}.log)")


def _wait_healthy(url: str, procs: dict, timeout: float = 15.0, ca_file: str = None) -> None:
    import ssl

    ctx = None
    if url.startswith("https://"):
        ctx = ssl.create_default_context(cafile=ca_file)
        ctx.check_hostname = False  # IP-addressed; chain still verified
    deadline = time.time() + timeout
    while time.time() < deadline:
        _exited(procs)
        try:
            with urllib.request.urlopen(f"{url}/healthz", timeout=1,
                                        context=ctx) as r:
                if r.status == 200:
                    return
        except Exception:
            time.sleep(0.2)
    raise SystemExit(f"apiserver at {url} did not become healthy")


def _lease_holder(cs, lock_name: str):
    """The identity holding ``lock_name``'s lease now, or None."""
    from .client.leaderelection import LEASE_ANNOTATION
    from .store.store import NotFoundError

    try:
        obj = cs.events.get(lock_name, "kube-system")
    except NotFoundError:
        return None
    rec = json.loads(obj.meta.annotations.get(LEASE_ANNOTATION) or "{}")
    if time.time() > rec.get("renewTime", 0) + rec.get("leaseDurationSeconds", 0):
        return None
    return rec.get("holderIdentity")


def _wait_started(cs, procs: dict, scheduler_identity, timeout: float = START_TIMEOUT_S) -> float:
    """Wait until the scheduler holds its lease (``scheduler_identity``: its
    identity, or a predicate on it) while every process in ``procs`` runs;
    exit naming the component otherwise.  Returns the seconds waited."""
    from .client.remote import RemoteError

    t0 = time.time()
    ok = (scheduler_identity if callable(scheduler_identity)
          else lambda who: who == scheduler_identity)
    while True:
        _exited(procs)
        try:
            if ok(_lease_holder(cs, "kube-scheduler") or ""):
                _exited(procs)
                return time.time() - t0
        except (OSError, RemoteError):
            pass  # the lease unread this round: the deadline decides
        if time.time() - t0 > timeout:
            raise SystemExit(f"scheduler did not take its lease within {timeout:.0f} s "
                             "(its output: logs/scheduler.log)")
        time.sleep(0.2)


def _clientset(url: str):
    from .client import Clientset
    from .client.remote import RemoteStore

    return Clientset(RemoteStore(url))


def _bootstrap_phase(cs, url: str, token_ttl: float,
                     ca_data: str = "") -> str:
    """kubeadm phase: system namespaces + bootstrap token + the signed
    cluster-info discovery document.  ``ca_data`` (PEM) rides in the
    payload so a TLS join can learn the cluster CA through the
    token-verified channel (the reference embeds the CA in the
    cluster-info kubeconfig the same way)."""
    from .api import Namespace, ObjectMeta
    from .api.cluster import Secret
    from .controllers.ipam import BootstrapSignerController
    from .store.store import AlreadyExistsError

    for ns in ("kube-system", "kube-public"):
        try:
            cs.namespaces.create(Namespace(meta=ObjectMeta(name=ns)))
        except AlreadyExistsError:
            pass
    token_id = pysecrets.token_hex(3)
    token_secret = pysecrets.token_hex(8)
    cs.secrets.create(Secret(
        meta=ObjectMeta(name=f"bootstrap-token-{token_id}", namespace="kube-system"),
        type="bootstrap.kubernetes.io/token",
        data={"token-id": token_id, "token-secret": token_secret,
              "expiration": str(time.time() + token_ttl),
              "usage-bootstrap-authentication": "true"},
    ))
    payload = json.dumps({"server": url,
                          "certificate-authority-data": ca_data})
    signer = BootstrapSignerController(cs, cluster_info_payload=payload)
    signer.informers.start_all_manual()
    signer.informers.pump_all()
    while signer.sync_once():
        pass
    return f"{token_id}.{token_secret}"


def _pids(procs: dict) -> dict:
    return {name: proc.pid for name, proc in procs.items()}


def cmd_init(args) -> dict:
    if getattr(args, "self_hosted", False):
        return cmd_init_selfhosted(args)
    logs = _logs_dir(args)
    procs = {}
    procs["apiserver"] = _spawn(
        logs, "apiserver",
        "kubernetes_tpu_torch.apiserver", "--host", "127.0.0.1", "--port", str(args.port)
    )
    # persist immediately: if health-wait fails, `down` can still reap it
    _save({"pids": _pids(procs)})
    url = f"http://127.0.0.1:{args.port}"
    _wait_healthy(url, procs)
    cs = _clientset(url)

    token = _bootstrap_phase(cs, url, args.token_ttl)

    procs["scheduler"] = _spawn(
        logs, "scheduler", "kubernetes_tpu_torch.scheduler", "--apiserver", url,
        "--backend", args.backend, "--device", args.device, "--leader-elect",
        "--healthz-port", str(getattr(args, "scheduler_healthz_port", -1)),
    )
    procs["controller-manager"] = _spawn(
        logs, "controller-manager",
        "kubernetes_tpu_torch.controllers", "--apiserver", url, "--leader-elect",
    )
    if getattr(args, "dns_port", 0):
        # the kube-dns addon (cluster/addons/dns): part of standard
        # turn-up, serving the cluster zone over UDP
        procs["kube-dns"] = _spawn(
            logs, "kube-dns", "kubernetes_tpu_torch.dns", "--apiserver", url,
            "--port", str(args.dns_port),
        )
    _save({"pids": _pids(procs), "logs": logs})
    waited = _wait_started(cs, procs, f"scheduler-{procs['scheduler'].pid}")
    print(f"control plane up at {url} (the scheduler leads {waited:.1f} s after its start, "
          f"on {args.device}; logs in {logs})")
    print(f"join token: {token}")
    print(f"  python -m kubernetes_tpu_torch.cluster join --apiserver {url} "
          f"--token {token} --name node-1")
    return {"url": url, "pids": _pids(procs), "token": token, "logs": logs}


CONTROL_PLANE_NODE = "control-plane"


def _write_control_plane_manifests(cluster_dir: str, port: int,
                                   paths: dict, backend: str, device: str) -> str:
    """kubeadm ``phases/controlplane/manifests.go:45
    CreateInitStaticPodManifestFiles``: one static-pod manifest per
    control-plane component, consumed by the control-plane kubelet's
    file source and run as REAL processes."""
    import yaml

    manifests = os.path.join(cluster_dir, "manifests")
    os.makedirs(manifests, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    inherited = os.environ.get("PYTHONPATH", "")
    env = {"PYTHONPATH": (root + os.pathsep + inherited) if inherited else root}

    def manifest(name: str, argv: list[str]) -> None:
        doc = {
            "kind": "Pod",
            "metadata": {"name": name, "namespace": "kube-system",
                         "labels": {"component": name, "tier": "control-plane"}},
            "spec": {
                "restartPolicy": "Always",
                "containers": [{
                    "name": name,
                    "image": f"ktpu/{name}",
                    "command": [sys.executable, "-m", *argv],
                    "env": env,
                }],
            },
        }
        with open(os.path.join(manifests, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(doc, f)

    manifest("kube-apiserver", [
        "kubernetes_tpu_torch.apiserver", "--host", "127.0.0.1",
        "--port", str(port),
        "--tls-cert-file", paths["apiserver"],
        "--tls-private-key-file", paths["apiserver_key"],
        "--client-ca-file", paths["ca"],
    ])
    manifest("kube-scheduler", [
        "kubernetes_tpu_torch.scheduler",
        "--kubeconfig", paths["kubeconfig_kube-scheduler"],
        "--backend", backend, "--device", device, "--leader-elect",
    ])
    manifest("kube-controller-manager", [
        "kubernetes_tpu_torch.controllers",
        "--kubeconfig", paths["kubeconfig_kube-controller-manager"],
        "--leader-elect",
    ])
    return manifests


def cmd_init_selfhosted(args) -> dict:
    """``init --self-hosted``: certs phase → kubeconfig phase →
    control-plane static-pod manifests → ONE real-container kubelet that
    bootstraps the control plane from its manifest dir (standalone until
    its own apiserver pod answers, then mirrored).  The control plane
    serves TLS with the generated CA; components authenticate with
    client certificates."""
    from .pki import create_cluster_pki, write_kubeconfig

    cluster_dir = os.path.abspath(args.cluster_dir)
    os.makedirs(cluster_dir, exist_ok=True)
    logs = _logs_dir(args)
    url = f"https://127.0.0.1:{args.port}"
    paths = create_cluster_pki(cluster_dir, node_name=CONTROL_PLANE_NODE)
    for component in ("admin", "kube-scheduler", "kube-controller-manager"):
        paths[f"kubeconfig_{component}"] = write_kubeconfig(
            cluster_dir, component, url, paths["ca"],
            client_cert=paths[component], client_key=paths[f"{component}_key"])
    paths["kubeconfig_kubelet"] = write_kubeconfig(
        cluster_dir, "kubelet", url, paths["ca"],
        client_cert=paths["kubelet"], client_key=paths["kubelet_key"])
    manifests = _write_control_plane_manifests(
        cluster_dir, args.port, paths, args.backend, args.device)

    procs = {"control-plane-kubelet": _spawn(
        logs, "control-plane-kubelet",
        "kubernetes_tpu_torch.kubelet",
        "--kubeconfig", paths["kubeconfig_kubelet"],
        "--name", CONTROL_PLANE_NODE,
        "--real-containers", "--static-pod-dir", manifests,
    )}
    _save({"pids": _pids(procs), "logs": logs})
    _wait_healthy(url, procs, timeout=60.0, ca_file=paths["ca"])

    from .client import Clientset
    from .client.remote import RemoteStore

    with open(paths["ca"]) as f:
        ca_data = f.read()
    cs = Clientset(RemoteStore(url, ca_file=paths["ca"],
                               client_cert=paths["admin"],
                               client_key=paths["admin_key"]))
    token = _bootstrap_phase(cs, url, args.token_ttl, ca_data=ca_data)
    if getattr(args, "dns_port", 0):
        # the kube-dns addon rides the admin kubeconfig (TLS + client cert)
        procs["kube-dns"] = _spawn(
            logs, "kube-dns",
            "kubernetes_tpu_torch.dns",
            "--kubeconfig", paths["kubeconfig_admin"],
            "--port", str(args.dns_port),
        )
        _save({"pids": _pids(procs)})
    # the scheduler runs as a static pod: its pid is the kubelet's to know
    _wait_started(cs, procs, lambda who: who.startswith("scheduler-"))
    print(f"self-hosted control plane up at {url}")
    print(f"  pki + kubeconfigs: {cluster_dir}")
    print(f"join token: {token}")
    print(f"  python -m kubernetes_tpu_torch.cluster join --apiserver {url} "
          f"--token {token} --name node-1")
    return {"url": url, "pids": _pids(procs), "token": token,
            "cluster_dir": cluster_dir}


def verify_cluster_info(url: str, token: str) -> str:
    """The join-side discovery handshake: fetch cluster-info anonymously,
    verify the signature for OUR token id with OUR token secret.

    Over https the FETCH is deliberately unverified (the joiner does not
    know the cluster CA yet); trust comes from the HMAC signature shared
    through the token — after which the payload's embedded CA becomes
    the pinned trust root (the reference's token-based TLS bootstrap,
    ``kubeadm join`` discovery)."""
    import ssl

    from .controllers.ipam import sign_cluster_info

    ctx = None
    if url.startswith("https://"):
        ctx = ssl._create_unverified_context()  # noqa: S323 — see docstring
    token_id, _, token_secret = token.partition(".")
    with urllib.request.urlopen(
        f"{url}/api/v1/namespaces/kube-public/configmaps/cluster-info",
        timeout=5, context=ctx
    ) as r:
        info = json.loads(r.read())
    data = info.get("data") or {}
    payload = data.get("kubeconfig", "")
    sig = data.get(f"jws-kubeconfig-{token_id}", "")
    want = sign_cluster_info(payload, token_secret)
    if not sig or sig != want:
        raise SystemExit("cluster-info signature verification FAILED "
                         "(wrong token or tampered discovery document)")
    return payload


def cmd_join(args) -> dict:
    payload = verify_cluster_info(args.apiserver, args.token)
    print(f"discovery verified: {payload!r}")
    logs = _logs_dir(args)
    name = f"kubelet-{args.name}"
    ca_data = ""
    try:
        ca_data = (json.loads(payload) or {}).get(
            "certificate-authority-data", "")
    except (ValueError, AttributeError):
        pass  # pre-TLS payloads are plain text
    if ca_data:
        # TLS cluster: pin the token-verified CA and join with the
        # bootstrap token as the credential.  Credentials live NEXT TO
        # the cluster state file (not a leaked mkdtemp) so `down` reaps
        # them with everything else
        join_dir = os.path.abspath(f"{JOIN_DIR_PREFIX}{args.name}")
        os.makedirs(join_dir, exist_ok=True)
        ca_path = os.path.join(join_dir, "ca.crt")
        with open(ca_path, "w") as f:
            f.write(ca_data)
        from .pki import write_kubeconfig

        kubeconfig = write_kubeconfig(join_dir, f"kubelet-{args.name}",
                                      args.apiserver, ca_path,
                                      token=args.token)
        proc = _spawn(
            logs, name, "kubernetes_tpu_torch.kubelet", "--kubeconfig", kubeconfig,
            "--name", args.name, "--proxy",
        )
        print(f"node {args.name} joining (pid {proc.pid})")
        return {"pids": {name: proc.pid}, "join_dirs": [join_dir], "logs": logs}
    proc = _spawn(
        logs, name, "kubernetes_tpu_torch.kubelet", "--apiserver", args.apiserver,
        "--name", args.name, "--proxy",
    )
    print(f"node {args.name} joining (pid {proc.pid})")
    return {"pids": {name: proc.pid}, "logs": logs}


def _save(state: dict) -> None:
    old = {}
    if os.path.exists(STATE_FILE):
        with open(STATE_FILE) as f:
            old = json.load(f)
    old.setdefault("pids", {}).update(state.get("pids", {}))
    old.setdefault("join_dirs", [])
    old["join_dirs"] = sorted(
        set(old["join_dirs"]) | set(state.get("join_dirs", [])))
    for k, v in state.items():
        if k not in ("pids", "join_dirs"):
            old[k] = v
    with open(STATE_FILE, "w") as f:
        json.dump(old, f, indent=2)


def alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, exited but not yet reaped, does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _stop(procs: dict) -> None:
    """SIGTERM every ``name: pid``, then wait until each has exited (SIGKILL
    what still runs ``STOP_TIMEOUT_S`` later)."""
    for pid in procs.values():
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.time() + STOP_TIMEOUT_S
    while any(alive(pid) for pid in procs.values()) and time.time() < deadline:
        time.sleep(0.1)
    for name, pid in procs.items():
        if alive(pid):
            os.kill(pid, signal.SIGKILL)
            print(f"killed {name} (pid {pid}): still running {STOP_TIMEOUT_S:.0f} s "
                  "after SIGTERM")
        else:
            print(f"stopped {name} (pid {pid})")


def cmd_down(_args) -> None:
    import shutil

    if not os.path.exists(STATE_FILE):
        print("no cluster state found")
        return
    with open(STATE_FILE) as f:
        state = json.load(f)
    # the apiserver last: a component that stops still talks to it (the
    # scheduler releases its lease)
    pids = state.get("pids", {})
    _stop({k: v for k, v in pids.items() if k != "apiserver"})
    _stop({k: v for k, v in pids.items() if k == "apiserver"})
    for d in state.get("join_dirs", []):
        shutil.rmtree(d, ignore_errors=True)  # token-bearing credentials
    os.remove(STATE_FILE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_tpu_torch.cluster")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("init")
    p.add_argument("--port", type=int, default=6443)
    p.add_argument("--backend", choices=["tpu", "batch", "oracle"], default="tpu",
                   help="the scheduler's backend (tpu is the port's batch backend)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the scheduler runs (cuda needs a card)")
    p.add_argument("--token-ttl", type=float, default=24 * 3600)
    p.add_argument("--dns-port", type=int, default=10053,
                   help="0 disables the kube-dns addon")
    p.add_argument("--self-hosted", action="store_true",
                   help="certs + kubeconfig phases, control plane as "
                   "static pods under a real-container kubelet, TLS "
                   "throughout (the kubeadm shape)")
    p.add_argument("--cluster-dir", default=CLUSTER_DIR,
                   help="where the components' logs/ go, and --self-hosted's "
                   "pki/, kubeconfigs and manifests/")
    p.add_argument("--scheduler-healthz-port", type=int, default=-1,
                   help="serve the scheduler's /healthz and /metrics on this port "
                   "(-1: off; not with --self-hosted)")
    p = sub.add_parser("join")
    p.add_argument("--apiserver", required=True)
    p.add_argument("--token", required=True)
    p.add_argument("--name", required=True)
    p = sub.add_parser("up")
    p.add_argument("--port", type=int, default=6443)
    p.add_argument("--backend", choices=["tpu", "batch", "oracle"], default="oracle")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the scheduler runs (cuda needs a card)")
    p.add_argument("--nodes", type=int, default=5)
    p.add_argument("--token-ttl", type=float, default=24 * 3600)
    p.add_argument("--dns-port", type=int, default=10053,
                   help="0 disables the kube-dns addon")
    sub.add_parser("down")
    args = ap.parse_args(argv)
    if args.cmd == "init" and args.self_hosted and args.scheduler_healthz_port >= 0:
        ap.error("--scheduler-healthz-port does not apply to --self-hosted")

    if args.cmd == "init":
        _save(cmd_init(args))
        return 0
    if args.cmd == "join":
        _save(cmd_join(args))
        return 0
    if args.cmd == "up":
        state = cmd_init(args)
        url, token = state["url"], state["token"]
        for i in range(args.nodes):
            verify_cluster_info(url, token)
            name = f"kubelet-{i}"
            state["pids"][name] = _spawn(
                state["logs"], name,
                "kubernetes_tpu_torch.kubelet", "--apiserver", url,
                "--name", f"node-{i:03d}", "--proxy",
            ).pid
        _save(state)
        print(f"{args.nodes} nodes joining")
        return 0
    if args.cmd == "down":
        cmd_down(args)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
