"""hyperkube: one entry point for every component of the port (reference
``cmd/hyperkube``):

    python -m kubernetes_tpu_torch apiserver --port 6443 [--data-dir DIR]
    python -m kubernetes_tpu_torch scheduler --apiserver http://127.0.0.1:6443
    python -m kubernetes_tpu_torch kubelet --apiserver http://127.0.0.1:6443 --count 100
    python -m kubernetes_tpu_torch controller-manager --apiserver http://127.0.0.1:6443
    python -m kubernetes_tpu_torch cloud-controller-manager --apiserver http://127.0.0.1:6443
    python -m kubernetes_tpu_torch kubectl --server http://127.0.0.1:6443 get nodes
    python -m kubernetes_tpu_torch kubefed --host http://127.0.0.1:18500 get-clusters
"""

from __future__ import annotations

import importlib
import sys

COMPONENTS = {
    "apiserver": "kubernetes_tpu_torch.apiserver.__main__",
    "kube-apiserver": "kubernetes_tpu_torch.apiserver.__main__",
    "scheduler": "kubernetes_tpu_torch.scheduler.__main__",
    "kube-scheduler": "kubernetes_tpu_torch.scheduler.__main__",
    "kubelet": "kubernetes_tpu_torch.kubelet.__main__",
    "controller-manager": "kubernetes_tpu_torch.controllers.__main__",
    "kube-controller-manager": "kubernetes_tpu_torch.controllers.__main__",
    "cloud-controller-manager": "kubernetes_tpu_torch.cloud.__main__",
    "kubectl": "kubernetes_tpu_torch.cli.kubectl",
    "kubefed": "kubernetes_tpu_torch.federation.kubefed",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("usage: python -m kubernetes_tpu_torch COMPONENT [args...]\n"
                         "components: " + ", ".join(sorted(COMPONENTS)) + "\n")
        return 0 if argv else 2
    mod_name = COMPONENTS.get(argv[0])
    if mod_name is None:
        sys.stderr.write(f"unknown component {argv[0]!r}; one of {sorted(COMPONENTS)}\n")
        return 2
    return importlib.import_module(mod_name).main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
