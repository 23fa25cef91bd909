"""Per-iteration solver state passed to iteration callbacks
(reference solver/iteration_info.hpp:14-42)."""

import dataclasses

import numpy as np


@dataclasses.dataclass
class IterationInfo:
    """A view of solver state at the beginning of an iteration.

    Matrices are dense numpy arrays (the TPU build assembles block-dense
    systems rather than Eigen sparse triplets).
    """

    #: The solver iteration.
    iteration: int
    #: The decision variables.
    x: np.ndarray
    #: The inequality constraint slack variables (empty outside IPM).
    s: np.ndarray
    #: The equality constraint dual variables (empty for Newton).
    y: np.ndarray
    #: The inequality constraint dual variables (empty outside IPM).
    z: np.ndarray
    #: The cost gradient.
    g: np.ndarray
    #: The Lagrangian Hessian.
    H: np.ndarray
    #: The equality constraint Jacobian (empty for Newton).
    A_e: np.ndarray
    #: The inequality constraint Jacobian (empty outside IPM).
    A_i: np.ndarray
