"""Solver options (reference solver/options.hpp:13-38), plus the device
the solve runs on."""

import dataclasses
import math

import torch

#: The solver arithmetic each `Options.dtype` names.
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass
class Options:
    """Solver options."""

    #: The solver will stop once the error is below this tolerance.
    tolerance: float = 1e-8

    #: The maximum number of solver iterations before returning a solution.
    max_iterations: int = 5000

    #: The maximum elapsed wall clock time in seconds before returning a
    #: solution.
    timeout: float = math.inf

    #: Enables the feasible interior-point method. When the inequality
    #: constraints are all feasible, step sizes are reduced when necessary to
    #: prevent them becoming infeasible again.
    feasible_ipm: bool = False

    #: Enables diagnostic output.
    diagnostics: bool = False

    #: dtype for solver arithmetic ("float64" or "float32"): the
    #: reference's Scalar template (reference src/optimization/problem.cpp:7).
    #: The default 1e-8 tolerance needs float64.
    dtype: str = "float64"

    #: torch device of the solve. A CUDA device that is absent raises; the
    #: solve never moves to the CPU on its own.
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {self.dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of the solve's iterates and KKT systems."""
        return DTYPES[self.dtype]
