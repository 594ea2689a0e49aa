"""Seeded device-contract violations for the port's DC6xx pass: the torch
mirror of ``tests/analysis_fixtures/fixture_device_contracts.py``.

This file is PARSED by tests, never imported.  One function or class for
each of the reference fixture's, with the same names and the same
bad/clean pairs; each hazard is its torch counterpart: a pointer of a
temporary handed to a launch in place of a donated buffer read after
dispatch, an unannotated ``.cpu()``-class sync, and a shape flowing into
the kernel library's build in place of an un-bucketed compile key.
tests/test_torch_analysis.py asserts the (code, symbol) pairs; the *_ok
shapes pin the exemptions.
"""

import torch

from kubernetes_tpu_torch.ops import _build


# -- a build keyed by its argument (the reference's jit-factory chain) -----


def _fixture_runner(chunk: int):
    # one library per distinct chunk: a shape here builds a library per shape
    lib = _build.load(f"fixture_{chunk}")

    def run(*ptrs):
        return lib.fixture_launch(*ptrs)

    return run


def _fixture_runner_for(chunk: int):
    return _fixture_runner(int(chunk))


class FixtureLoop:
    def __init__(self, chunk: int):
        self._dev = torch.ones(4, device="cuda")
        self._state = torch.zeros(4, device="cuda")
        self._launch = _fixture_runner_for(int(chunk))

    # DC601: the launch reads a pointer of a temporary — the clone of the
    # state is freed before the kernel runs
    def dispatch_bad(self):
        self._launch(self._dev.data_ptr(), self._state.clone().data_ptr())

    # exemption: a name holds the clone past the launch — clean
    def dispatch_ok(self):
        state = self._state.clone()
        self._launch(self._dev.data_ptr(), state.data_ptr())
        self._state = state

    # DC601 one-hop: the callee building the pointers drops their tensor
    def dispatch_callee_bad(self):
        ptrs = self._peek()
        self._launch(self._dev.data_ptr(), *ptrs)

    def _peek(self):
        state = self._state.t().contiguous()
        ptrs = (state.data_ptr(),)
        del state  # the copy is freed here, before the caller launches
        return ptrs

    # DC602: unsanctioned host materialization of a device value
    def sync_bad(self):
        n = int(torch.sum(self._state))
        return n

    # exemption: sanctioned site with a reason
    def sync_ok(self):
        # device: sync — fixture-sanctioned control read
        n = int(torch.sum(self._state))
        return n


# -- DC603 shapes: the build identity ---------------------------------------


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _sticky_pad(axis, n):
    return n


def _pow2_width(n: int, lo: int) -> int:
    return max(lo, n)


def pad_bad(x):
    return _build.load(f"fixture_{_pad_to(x.shape[0], 8)}")


def pad_ok_sticky(x):
    # the padded width is the launch's argument, not part of the build
    return _build.load("fixture").fixture_launch(_sticky_pad("nodes", _pad_to(x.shape[0], 8)))


def pad_ok_annotated(x):
    return _build.load(f"fixture_{_pad_to(x.shape[0], 8)}")  # device: static — fixture-sanctioned


def width_bad(x):
    return [*_build.NVCC_FLAGS, f"-DWIDTH={_pow2_width(x.shape[1], 8)}"]


def width_ok(x):
    return [*_build.NVCC_FLAGS, f"-DWIDTH={_pow2_width(x.shape[1], 8)}"]  # device: static — fixture-sanctioned


def factory_call_bad(static):
    run = _fixture_runner(static.chunk)
    return run(0)


def factory_call_ok(static):
    run = _fixture_runner(16)
    return run(int(static.chunk))


# -- DC604 shapes ---------------------------------------------------------


def fixture_schedule(node_info_map, pods):
    work_map = dict(node_info_map)

    def mutable_info(name):
        fresh = work_map[name].clone()
        work_map[name] = fresh
        return fresh

    def apply_ok(name, pod):
        info = mutable_info(name)
        info.add_pod(pod)

    def apply_bad(name, pod):
        raw = work_map.get(name)
        raw.add_pod(pod)
        work_map[name].remove_pod(pod)
        raw.node = None

    for pod in pods:
        apply_ok(pod, pod)
        apply_bad(pod, pod)
    return work_map


# -- DC605 shapes ---------------------------------------------------------


def stale_sync_annotation(x):
    # device: sync — nothing materializes on this line or the next
    y = x + 1
    return y


def reasonless_sync(dev):
    # device: sync
    n = int(dev.cuda().sum())
    return n


def stale_static_annotation(x):
    # device: static
    return x + 1
