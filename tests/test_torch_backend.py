"""The slice as a whole: ``BatchBackend(device="cpu").schedule_batch``
against the JAX package's ``TPUBatchBackend(kernel_impl="xla")`` and the
JAX oracle, on clusters each package builds from the same seed.
Tolerance: exact equality of every binding and of the final round-robin
counter."""

import pytest
import torch

from kubernetes_tpu.ops.backend import TPUBatchBackend
from kubernetes_tpu_torch.ops import backend as port_backend
from kubernetes_tpu_torch.ops.backend import BatchBackend
from tests import torch_port_cases as cases


def _jax_backend(case, **kw):
    M = cases.mods(cases.JAX)
    m, pods, pctx = cases.CASES[case](cases.JAX, **kw)
    oracle = M.gs.GenericScheduler()
    want = cases.oracle_batch(cases.JAX, pods, m, pctx, oracle)
    algo = M.gs.GenericScheduler()
    got = TPUBatchBackend(algorithm=algo, kernel_impl="xla").schedule_batch(pods, m, pctx)
    assert got == want and algo._round_robin == oracle._round_robin
    return got, algo._round_robin


def _port_backend(case, **kw):
    M = cases.mods(cases.PORT)
    m, pods, pctx = cases.CASES[case](cases.PORT, **kw)
    algo = M.gs.GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu")
    got = backend.schedule_batch(pods, m, pctx)
    return got, algo._round_robin, backend, pods


@pytest.mark.parametrize("case,kw", [
    ("mixed", {}),
    ("mixed", {"seed": 11, "n_nodes": 16, "n_pods": 80}),
    ("ties", {}),
    ("few_feasible", {}),
])
def test_backend_matches_reference_backend_and_oracle(case, kw):
    want, rr_want = _jax_backend(case, **kw)
    got, rr_got, backend, pods = _port_backend(case, **kw)
    assert got == want
    assert rr_got == rr_want
    assert backend.stats["kernel_pods"] == len(pods)
    assert backend.stats["oracle_pods"] == 0
    assert backend.stats["segments"] >= 1


def test_backend_segments_carry_round_robin():
    """A small segment cap cuts the batch into several segments; the
    round-robin counter carried between them keeps parity."""
    M = cases.mods(cases.PORT)
    m, pods, pctx = cases.ties(cases.PORT)
    algo = M.gs.GenericScheduler()
    backend = BatchBackend(algorithm=algo, device="cpu", max_segment_pods=8)
    got = backend.schedule_batch(pods, m, pctx)
    want, rr_want = _jax_backend("ties")
    assert got == want and algo._round_robin == rr_want
    assert backend.stats["segments"] == 5


def test_backend_does_not_mutate_snapshot_and_streams_segments():
    M = cases.mods(cases.PORT)
    m, pods, pctx = cases.mixed(cases.PORT)
    before = {n: (len(i.pods), i.generation) for n, i in m.items()}
    seen = []
    backend = BatchBackend(device="cpu", max_segment_pods=16)
    got = backend.schedule_batch(pods, m, pctx, on_segment=seen.extend)
    assert {n: (len(i.pods), i.generation) for n, i in m.items()} == before
    assert [p for p, *_ in seen] == pods
    assert [node for _, node, *_ in seen] == got


def test_oracle_singletons_for_pods_with_too_many_disks():
    """A pod with more distinct disks than a slot row holds runs on the
    oracle; the rest of the batch stays on the scan."""
    M = cases.mods(cases.PORT)
    m, pods, pctx = cases.plain(cases.PORT)
    vols = [M.api.Volume(name=f"v{k}", disk_id=f"x{k}", disk_kind="gce-pd") for k in range(9)]
    pods.insert(5, M.tu.make_pod("many-disks", cpu="100m", volumes=vols))
    backend = BatchBackend(device="cpu")
    got = backend.schedule_batch(pods, m, pctx)
    oracle = M.gs.GenericScheduler()
    assert got == cases.oracle_batch(cases.PORT, pods, m, pctx, oracle)
    assert backend.stats["oracle_pods"] == 1
    assert backend.stats["kernel_pods"] == len(pods) - 1


def test_backend_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_backend.resolve_device(None)
    assert BatchBackend(device="cpu").device.type == "cpu"


def test_backend_named_cuda_device_needs_a_card(monkeypatch):
    """A CUDA device named outright raises when the backend is built, as
    the default does: a host without a card must not get a backend that
    fails only at its first launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchBackend(device=device)
