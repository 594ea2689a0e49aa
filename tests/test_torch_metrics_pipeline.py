"""Twins of ``tests/test_metrics_pipeline.py`` on the port: the kubelet's
stats summary over real container processes, the apiserver's node proxy,
the metrics client's CPU rates and the HPA scaling on them.

Each case runs the JAX test through both packages (``tests/torch_twin``):
both pass its assertions and leave equal stores.  A container's pid and
its measured usage differ between two runs, so the containers' ids are
masked (and ``kubectl top pods``, which prints the measured memory, is
held by the test's own assertions, not by an equal output)."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_metrics_pipeline"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path, extra_volatile=["containerID"])
