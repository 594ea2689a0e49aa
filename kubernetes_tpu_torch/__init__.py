"""PyTorch/CUDA port of kubernetes_tpu: the batch scheduling path, the
serving scheduler and its daemons.

The package keeps its own copies of the host modules it needs (API kinds,
the CPU oracle, the tensorizer, the store, informers, the HTTP apiserver
core and its wire client) and runs the sequential-greedy segment scan as
a hand-written CUDA kernel (``ops/csrc/fused_scan.cu``).  Entry points run
on CUDA unless the caller passes ``device="cpu"`` (``--device cpu``).
"""

__version__ = "0.1.0"
