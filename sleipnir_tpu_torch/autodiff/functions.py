"""Autodiff math functions (reference autodiff/variable.hpp:391-714).

Each function accepts a Variable (scalar node), a VariableMatrix or
VariableBlock (one elementwise array node), plain numbers, numpy arrays,
or torch tensors, so dynamics written against this DSL also run on the
tensors of the compiled program. Trig on tensors goes through the
f64-accurate kernels of `ops/accurate_math.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff import expression as ex
from sleipnir_tpu_torch.autodiff.variable import (
    _NUMBER_TYPES,
    Variable,
    VariableBlock,
    VariableMatrix,
    _any_operand,
)
from sleipnir_tpu_torch.ops import accurate_math

_SYMBOLIC = (Variable, VariableMatrix, VariableBlock)


def _apply_unary(op: str, np_fn, torch_fn, x):
    if isinstance(x, Variable):
        return Variable(ex.unary(op, x.expr))
    if isinstance(x, VariableBlock):
        x = x._as_matrix()
    if isinstance(x, VariableMatrix):
        return VariableMatrix._from_expr(ex.unary(op, x.expr))
    if isinstance(x, torch.Tensor):
        return torch_fn(x)
    return np_fn(x)


def _apply_binary(op: str, np_fn, torch_fn, a, b):
    if isinstance(a, _SYMBOLIC) or isinstance(b, _SYMBOLIC):
        out = ex.binary_nonlinear(op, _any_operand(a), _any_operand(b))
        if out.shape == ():
            return Variable(out)
        return VariableMatrix._from_expr(out)
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch_fn(torch.as_tensor(a), torch.as_tensor(b))
    return np_fn(a, b)


def abs(x):  # noqa: A001
    return _apply_unary("abs", np.abs, torch.abs, x)


def acos(x):
    return _apply_unary("acos", np.arccos, torch.acos, x)


def asin(x):
    return _apply_unary("asin", np.arcsin, torch.asin, x)


def atan(x):
    return _apply_unary("atan", np.arctan, torch.atan, x)


def atan2(y, x):
    return _apply_binary("atan2", np.arctan2, torch.atan2, y, x)


def cbrt(x):
    return _apply_unary("cbrt", np.cbrt, ex._cbrt, x)


def cos(x):
    return _apply_unary("cos", np.cos, accurate_math.cos, x)


def cosh(x):
    return _apply_unary("cosh", np.cosh, torch.cosh, x)


def erf(x):
    return _apply_unary("erf", np.vectorize(math.erf), torch.erf, x)


def exp(x):
    return _apply_unary("exp", np.exp, torch.exp, x)


def hypot(x, y):
    return _apply_binary("hypot", np.hypot, torch.hypot, x, y)


def log(x):
    return _apply_unary("log", np.log, torch.log, x)


def log10(x):
    return _apply_unary("log10", np.log10, torch.log10, x)


def pow(base, power):  # noqa: A001
    """pow() building a QUADRATIC-tagged node for pow(linear, 2)
    (reference autodiff/expression.hpp:1740-1748)."""
    if isinstance(base, _SYMBOLIC) and isinstance(power, _NUMBER_TYPES):
        return base**power
    if isinstance(base, _SYMBOLIC) or isinstance(power, _SYMBOLIC):
        return _apply_binary(
            "pow_expr", np.power, torch.pow, base, power
        )
    return base**power


def sign(x):
    return _apply_unary("sign", np.sign, torch.sign, x)


def sin(x):
    return _apply_unary("sin", np.sin, accurate_math.sin, x)


def sinh(x):
    return _apply_unary("sinh", np.sinh, torch.sinh, x)


def sqrt(x):
    return _apply_unary("sqrt", np.sqrt, torch.sqrt, x)


def tan(x):
    return _apply_unary("tan", np.tan, accurate_math.tan, x)


def tanh(x):
    return _apply_unary("tanh", np.tanh, torch.tanh, x)


def hypot3(x, y, z):
    """Three-argument hypot (reference autodiff/variable.hpp hypot overload)."""
    return sqrt(pow(x, 2) + pow(y, 2) + pow(z, 2))


def min(a, b):  # noqa: A001
    return _apply_binary("minimum", np.minimum, torch.minimum, a, b)


def max(a, b):  # noqa: A001
    return _apply_binary("maximum", np.maximum, torch.maximum, a, b)
