"""Matrix-callback structures: the seam between problem compilation and
the solvers (reference solver/interior_point_matrix_callbacks.hpp:18).

Port of `sleipnir_tpu/optimization/solver/funcs.py`. All callables are
torch functions of tensors, pre-scaled by the problem scaling (like the
closures built in reference problem.hpp:618-660). Solvers never see the
expression DAG.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ScalingArrays(NamedTuple):
    """Problem scaling as device tensors."""

    f: torch.Tensor  # scalar
    c_e: torch.Tensor  # (me,)
    c_i: torch.Tensor  # (mi,)


class _Bound:
    """Callback struct with the runtime `params` and `scaling` bound as the
    trailing arguments of every callable (reference docs/usage.md
    "Suppressing constant pruning"; scaling is recomputed at every solve's
    starting point, reference problem.hpp:616)."""

    def __init__(self, funcs, params, scaling) -> None:
        self.params = params
        self.scaling = scaling
        for name in funcs._fields:
            value = getattr(funcs, name)
            if callable(value):
                value = _bind_one(value, params, scaling)
            setattr(self, name, value)


def _bind_one(fn, params, scaling):
    return lambda *args: fn(*args, params, scaling)


def bind(funcs, params, scaling) -> _Bound:
    """Bind params and scaling vectors into a callback struct."""
    return _Bound(funcs, params, scaling)


class IPMFunctions(NamedTuple):
    """Callbacks for the interior-point solver (reference
    interior_point_matrix_callbacks.hpp:18). The banded backend takes its
    derivative blocks from probes of the raw problem functions; the dense
    H, A_e and A_i callbacks come with the dense backend (ROADMAP queue 1
    item 10)."""

    num_decision_variables: int
    num_equality_constraints: int
    num_inequality_constraints: int
    f: Callable  # f(x) -> scalar
    g: Callable  # g(x) -> (n,)
    c_e: Callable  # c_e(x) -> (me,)
    c_i: Callable  # c_i(x) -> (mi,)
