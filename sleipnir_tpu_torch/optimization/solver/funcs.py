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
    starting point, reference problem.hpp:616).

    When `dtype` is given, every callable's output is cast to it, so that
    a float64 value a problem function makes (a constant of its own, a
    model's float64 table) does not promote a float32 solve's iterates
    (the reference's Scalar template fixes the arithmetic type the same
    way)."""

    def __init__(self, funcs, params, scaling, dtype=None) -> None:
        self.params = params
        self.scaling = scaling
        for name in funcs._fields:
            value = getattr(funcs, name)
            if callable(value):
                value = _bind_one(value, params, scaling, dtype)
            setattr(self, name, value)


def _bind_one(fn, params, scaling, dtype):
    if dtype is None:
        return lambda *args: fn(*args, params, scaling)
    return lambda *args: fn(*args, params, scaling).to(dtype)


def bind(funcs, params, scaling, dtype=None) -> _Bound:
    """Bind params and scaling vectors into a callback struct, with every
    output cast to `dtype` when it is given."""
    return _Bound(funcs, params, scaling, dtype)


class NewtonFunctions(NamedTuple):
    """Callbacks for the Newton solver (reference
    newton_matrix_callbacks.hpp)."""

    num_decision_variables: int
    f: Callable  # f(x) -> scalar
    g: Callable  # g(x) -> (n,)
    H: Callable  # H(x) -> (n, n)


class SQPFunctions(NamedTuple):
    """Callbacks for the SQP solver (reference sqp_matrix_callbacks.hpp)."""

    num_decision_variables: int
    num_equality_constraints: int
    f: Callable  # f(x) -> scalar
    g: Callable  # g(x) -> (n,)
    H: Callable  # H(x, y) -> (n, n)   full Lagrangian Hessian
    H_c: Callable  # H_c(x, y) -> (n, n)  constraint part only
    c_e: Callable  # c_e(x) -> (me,)
    A_e: Callable  # A_e(x) -> (me, n)


class IPMFunctions(NamedTuple):
    """Callbacks for the interior-point solver (reference
    interior_point_matrix_callbacks.hpp:18). The dense backend reads the
    dense H, A_e and A_i; the banded backend takes its derivative blocks
    from probes of the raw problem functions and leaves them None."""

    num_decision_variables: int
    num_equality_constraints: int
    num_inequality_constraints: int
    f: Callable  # f(x) -> scalar
    g: Callable  # g(x) -> (n,)
    c_e: Callable  # c_e(x) -> (me,)
    c_i: Callable  # c_i(x) -> (mi,)
    H: Callable | None = None  # H(x, y, z) -> (n, n)  full Lagrangian Hessian
    H_c: Callable | None = None  # H_c(x, y, z) -> (n, n)  constraint part only
    A_e: Callable | None = None  # A_e(x) -> (me, n)
    A_i: Callable | None = None  # A_i(x) -> (mi, n)
