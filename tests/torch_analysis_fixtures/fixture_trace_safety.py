"""Seeded trace-safety violations for the port's analyzer tests: the torch
mirror of ``tests/analysis_fixtures/fixture_trace_safety.py``.

NEVER imported — the analyzer parses it as text.  One function for each
function of the reference fixture, with the same names and the same
bad/clean pairs; each hazard is its torch counterpart (a ``torch.compile``d
body in place of a ``jax.jit``ed one, the ``torch.func``/``torch.jit``
tracers in place of ``lax.scan``).  tests/test_torch_analysis.py asserts
every violation by exact code and symbol.
"""

import functools

import numpy as np
import torch


@torch.compile
def bad_host_escape(x):
    # TS101: float() concretizes the tracer (line anchors: float call)
    scale = float(x[0])
    return x * scale


@torch.compile
def bad_item_escape(x):
    # TS101: .item() forces a device->host sync inside the traced body
    n = x.sum().item()
    return x + n


@torch.compile(fullgraph=True)
def bad_np_call(x):
    # TS101: host numpy inside a compiled body runs at trace time only
    mask = np.argsort(x)
    return x[mask]


@torch.compile
def bad_branch(x):
    total = torch.sum(x)
    # TS102: Python branch on a traced value
    if total > 0:
        return x
    return -x


def bad_loop_body(state, xs):
    # traced via the torch.func.vmap tracer below, not via a decorator
    if state:  # TS102 again, through tracer-seeded tracing
        state = state + xs
    return state, xs


def drive(xs):
    return torch.func.vmap(bad_loop_body)(torch.zeros(xs.shape), xs)


def bad_set_feed(keys):
    # TS103: set iteration order reaches tensor contents
    ids = {k for k in keys}
    return torch.tensor([hash(k) for k in ids])


def bad_partial_step(state, xs):
    # traced via functools.partial passed into torch.compile (the partial
    # wrapper must not hide the helper)
    if state:  # TS102 through the partial reference
        state = state + xs
    return state, xs


def drive_partial(xs):
    return torch.compile(functools.partial(bad_partial_step))(torch.zeros(()), xs)


def bad_alias_step(state, xs):
    if state:  # TS102 through a module-level partial alias
        state = state - xs
    return state, xs


_aliased = __import__("functools").partial(bad_alias_step)


def drive_alias(xs):
    return torch.jit.trace(_aliased, (torch.zeros(()), xs))


class MethodStepper:
    def _bad_method_step(self, state, xs):
        if state:  # TS102 through a bound-method reference
            state = state + xs
        return state, xs

    def drive(self, xs):
        return torch.compile(self._bad_method_step)(torch.zeros(()), xs)

    @torch.compile
    def traced_entry(self, x):
        return self._bad_helper(x)

    def _bad_helper(self, x):
        # TS101 through a self.method() call from a traced body
        n = float(x.sum())
        return x * n


@torch.compile
def clean_static_flag(x, most: bool):
    # NOT flagged: bool-annotated parameter is the static-flag idiom
    if most:
        return x * 2
    return x


@torch.compile
def clean_is_none(x, aux=None):
    # NOT flagged: identity tests never concretize a tracer
    if aux is None:
        return x
    return x + aux


def clean_sorted_feed(keys):
    # NOT flagged: sorted() restores determinism before the tensor builder
    ids = {k for k in keys}
    return torch.tensor([hash(k) for k in sorted(ids)])
