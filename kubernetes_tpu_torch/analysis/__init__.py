"""ktpu-analyze for the port: project-native static analysis.

Seven AST/call-graph passes, the reference package's with the same
names, codes, baseline format and CLI, guard the silent-failure classes
this codebase is most exposed to:

- ``trace_safety`` (TS1xx): host Python leaking into code that runs
  under torch's tracers (``torch.compile``, ``torch.jit``, CUDA-graph
  capture, ``torch.func``) — Python branching on traced values, host
  escapes inside traced bodies, and nondeterministic set iteration
  feeding tensor builders.
- ``parity`` (PC2xx): every predicate/priority registered in the host
  oracle must carry a ``# kernel: implements <Name>`` marker at its
  kernel implementation site or a ``# kernel: host-fallback — <why>``
  marker at its oracle definition.
- ``races`` (RL3xx): unlocked cross-thread writes and lock-order cycles.
- ``metrics`` (MN4xx), ``tracecov`` (TC5xx) and ``concurrency`` (CH7xx):
  metric names, span coverage, and blocking/leak/growth hazards.
- ``device_contracts`` (DC6xx): raw device pointers of dead tensors
  handed to the ctypes launches, the host-sync budget of the wave path,
  the kernel build identity, and clone-on-write snapshot writes.

Run ``python -m kubernetes_tpu_torch.analysis`` (exits nonzero on
unbaselined findings); suppressions live in ``analysis/baseline.json``
and each requires a justification string.
"""

from .core import (  # noqa: F401
    Finding,
    Report,
    load_baseline,
    repo_root,
    run_analysis,
)
