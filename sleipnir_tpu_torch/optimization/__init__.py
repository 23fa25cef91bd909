"""Optimization layer: Problem DSL, the interior-point, SQP and Newton
solvers and the OCP layer (port of `sleipnir_tpu.optimization`)."""

from sleipnir_tpu_torch.autodiff import bounds
from sleipnir_tpu_torch.autodiff.variable import (
    EqualityConstraints,
    InequalityConstraints,
)
from sleipnir_tpu_torch.optimization.ocp import (
    OCP,
    DynamicsType,
    TimestepMethod,
    TranscriptionMethod,
)
from sleipnir_tpu_torch.optimization.problem import Problem
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.iteration_info import IterationInfo
from sleipnir_tpu_torch.optimization.solver.options import Options

__all__ = [
    "OCP",
    "DynamicsType",
    "EqualityConstraints",
    "ExitStatus",
    "InequalityConstraints",
    "IterationInfo",
    "Options",
    "Problem",
    "TimestepMethod",
    "TranscriptionMethod",
    "bounds",
]
