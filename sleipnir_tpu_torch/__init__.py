"""sleipnir_tpu_torch — the sleipnir_tpu solver ported to PyTorch and CUDA.

The second package beside `sleipnir_tpu` (JAX, the reference): the same
Problem DSL and OCP layer, interior-point, SQP and Newton solvers driven
from the host, a dense KKT backend, and a banded one whose
block-tridiagonal factor and solve run in CUDA C++ kernels written for
Hopper (`ops/cuda_banded.py`, `csrc/banded.cu`). Everything on the solve
path is float64, passed explicitly; importing the package changes no
global torch setting. The solve device comes from `Options(device=...)`,
"cuda" by default.

The port covers those solvers on OCP stage structure and without it,
with banded and dense feasibility restoration, and the whole OCP layer:
fixed and variable timesteps (a shared timestep is the banded backend's
border column), direct transcription, direct collocation and single
shooting, over dynamics that run on tensors or only on the DSL. Models:
cart-pole, flywheel, differential drive and double integrator
(`sleipnir_tpu_torch.models`). The Gradient, Jacobian and Hessian drivers
evaluate on the card too, and `multistart` solves its guesses as the lanes
of one batched interior-point solve (`sleipnir_tpu_torch.parallel`).
ROADMAP.md lists what is still to port.
"""

from sleipnir_tpu_torch.autodiff import (
    ExpressionType,
    Gradient,
    Hessian,
    Jacobian,
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
    MultistartResult,
    Options,
    Problem,
    TimestepMethod,
    TranscriptionMethod,
    multistart,
)

__version__ = "0.1.0"

__all__ = [
    "OCP",
    "DynamicsType",
    "EqualityConstraints",
    "ExitStatus",
    "ExpressionType",
    "Gradient",
    "Hessian",
    "InequalityConstraints",
    "IterationInfo",
    "Jacobian",
    "MultistartResult",
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
    "multistart",
    "pow",
    "sign",
    "sin",
    "sinh",
    "solve",
    "sqrt",
    "tan",
    "tanh",
]
