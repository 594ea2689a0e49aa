"""hyperkube: one entry point for every component of the port (reference
``cmd/hyperkube``):

    python -m kubernetes_tpu_torch apiserver --port 6443 [--data-dir DIR]
    python -m kubernetes_tpu_torch scheduler --apiserver http://127.0.0.1:6443
"""

from __future__ import annotations

import importlib
import sys

COMPONENTS = {
    "apiserver": "kubernetes_tpu_torch.apiserver.__main__",
    "kube-apiserver": "kubernetes_tpu_torch.apiserver.__main__",
    "scheduler": "kubernetes_tpu_torch.scheduler.__main__",
    "kube-scheduler": "kubernetes_tpu_torch.scheduler.__main__",
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
