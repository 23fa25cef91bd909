"""Autodiff layer: expression DAG and Variable DSL, compiled into torch
functions of the flat decision vector (port of `sleipnir_tpu.autodiff`),
and the Gradient, Jacobian and Hessian drivers over it.
"""

from sleipnir_tpu_torch.autodiff.drivers import Gradient, Hessian, Jacobian
from sleipnir_tpu_torch.autodiff.expression_type import ExpressionType
from sleipnir_tpu_torch.autodiff.functions import (
    abs,  # noqa: A004
    acos,
    asin,
    atan,
    atan2,
    cbrt,
    cos,
    cosh,
    erf,
    exp,
    hypot,
    log,
    log10,
    max,  # noqa: A004
    min,  # noqa: A004
    pow,  # noqa: A004
    sign,
    sin,
    sinh,
    sqrt,
    tan,
    tanh,
)
from sleipnir_tpu_torch.autodiff.variable import (
    EqualityConstraints,
    InequalityConstraints,
    Variable,
    VariableBlock,
    VariableMatrix,
    block,
    bounds,
    cwise_reduce,
    solve,
)

__all__ = [
    "EqualityConstraints",
    "ExpressionType",
    "Gradient",
    "Hessian",
    "InequalityConstraints",
    "Jacobian",
    "Variable",
    "VariableBlock",
    "VariableMatrix",
    "abs",
    "acos",
    "asin",
    "atan",
    "atan2",
    "block",
    "bounds",
    "cbrt",
    "cos",
    "cosh",
    "cwise_reduce",
    "erf",
    "exp",
    "hypot",
    "log",
    "log10",
    "max",
    "min",
    "pow",
    "sign",
    "sin",
    "sinh",
    "solve",
    "sqrt",
    "tan",
    "tanh",
]
