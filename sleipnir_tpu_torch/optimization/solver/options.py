"""Solver options (reference solver/options.hpp:13-38), plus the device
the solve runs on."""

import dataclasses
import math


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

    #: torch device of the solve. A CUDA device that is absent raises; the
    #: solve never moves to the CPU on its own.
    device: str = "cuda"
