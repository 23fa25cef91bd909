"""sleipnir_tpu_torch — the sleipnir_tpu solver ported to PyTorch and CUDA.

The second package beside `sleipnir_tpu` (JAX, the reference): the same
Problem DSL and OCP layer, an interior-point solver driven from the host,
and a banded KKT backend whose block-tridiagonal factor and solve run in
CUDA C++ kernels written for Hopper (`ops/cuda_banded.py`,
`csrc/banded.cu`). Everything on the solve path is float64, passed
explicitly; importing the package changes no global torch setting. The
solve device comes from `Options(device=...)`, "cuda" by default.

This slice covers the interior-point path on OCP stage structure (the
cart-pole swing-up at full size); ROADMAP.md lists what is still to port.
"""

from sleipnir_tpu_torch.autodiff import (
    ExpressionType,
    Variable,
    VariableBlock,
    VariableMatrix,
    abs,  # noqa: A004
    acos,
    asin,
    atan,
    atan2,
    block,
    bounds,
    cbrt,
    cos,
    cosh,
    cwise_reduce,
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
    solve,
    sqrt,
    tan,
    tanh,
)
from sleipnir_tpu_torch.optimization import (
    OCP,
    DynamicsType,
    EqualityConstraints,
    ExitStatus,
    InequalityConstraints,
    IterationInfo,
    Options,
    Problem,
    TimestepMethod,
    TranscriptionMethod,
)

__version__ = "0.1.0"

__all__ = [
    "OCP",
    "DynamicsType",
    "EqualityConstraints",
    "ExitStatus",
    "ExpressionType",
    "InequalityConstraints",
    "IterationInfo",
    "Options",
    "Problem",
    "TimestepMethod",
    "TranscriptionMethod",
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
