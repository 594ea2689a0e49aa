"""PyTorch/CUDA port of the kubernetes_tpu batch scheduling path.

The package keeps its own copies of the host modules it needs (API kinds,
the CPU oracle, the tensorizer) and runs the sequential-greedy segment
scan as a hand-written CUDA kernel (``ops/csrc/fused_scan.cu``).  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
