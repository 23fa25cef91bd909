"""Differential drive model and problem.

Port of `sleipnir_tpu/models/differential_drive.py` (reference
test/include/differential_drive_util.hpp and
python/test/optimization/differential_drive_util.py).

States x = [x, y, heading, left velocity, right velocity];
inputs u = [left voltage, right voltage].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff import cos, sin
from sleipnir_tpu_torch.autodiff.variable import VariableMatrix
from sleipnir_tpu_torch.ops import accurate_math
from sleipnir_tpu_torch.optimization.ocp import (
    OCP,
    DynamicsType,
    TimestepMethod,
    TranscriptionMethod,
)

TRACKWIDTH = 0.699  # m
KV_LINEAR = 3.02  # V/(m/s)
KA_LINEAR = 0.642  # V/(m/s²)
KV_ANGULAR = 1.382  # V/(m/s)
KA_ANGULAR = 0.08495  # V/(m/s²)

_A1 = -(KV_LINEAR / KA_LINEAR + KV_ANGULAR / KA_ANGULAR) / 2.0
_A2 = -(KV_LINEAR / KA_LINEAR - KV_ANGULAR / KA_ANGULAR) / 2.0
_B1 = 0.5 / KA_LINEAR + 0.5 / KA_ANGULAR
_B2 = 0.5 / KA_LINEAR - 0.5 / KA_ANGULAR
A = np.array([[_A1, _A2], [_A2, _A1]])
B = np.array([[_B1, _B2], [_B2, _B1]])


def _on_device(M: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The constant matrix M on `like`'s device, made there from scalars
    with no host-to-device copy (a CUDA graph of the dynamics holds it)."""
    one = like.new_ones(())
    return torch.stack([torch.stack([one * float(v) for v in row]) for row in M])


def dynamics(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Differential drive ODE on tensors: x (5, 1), u (2, 1) -> (5, 1).

    The trig goes through the f64-accurate kernels, as in the JAX package,
    so it rounds as the JAX CPU reference does."""
    v = (x[3, 0] + x[4, 0]) / 2.0
    heading = x[2, 0]
    vel = _on_device(A, x) @ x[3:5, :] + _on_device(B, x) @ u
    return torch.cat(
        [
            torch.stack(
                [
                    v * accurate_math.cos(heading),
                    v * accurate_math.sin(heading),
                    (x[4, 0] - x[3, 0]) / TRACKWIDTH,
                ]
            ).reshape(3, 1),
            vel,
        ]
    )


def dynamics_numpy(x, u) -> np.ndarray:
    """Plain-double dynamics for test oracles."""
    x = np.asarray(x, dtype=np.float64).reshape(5, 1)
    u = np.asarray(u, dtype=np.float64).reshape(2, 1)
    out = np.empty((5, 1))
    v = (x[3, 0] + x[4, 0]) / 2.0
    out[0, 0] = v * math.cos(x[2, 0])
    out[1, 0] = v * math.sin(x[2, 0])
    out[2, 0] = (x[4, 0] - x[3, 0]) / TRACKWIDTH
    out[3:5, :] = A @ x[3:5, :] + B @ u
    return out


def dynamics_dsl(x, u) -> VariableMatrix:
    """DSL twin (reference differential_drive_util.py
    differential_drive_dynamics_variable): runs on the DSL only, so the
    OCP takes its symbolic path."""
    v = (x[3, 0] + x[4, 0]) / 2.0
    out = VariableMatrix(np.zeros((5, 1)))
    out[0, 0] = v * cos(x[2, 0])
    out[1, 0] = v * sin(x[2, 0])
    out[2, 0] = (x[4, 0] - x[3, 0]) / TRACKWIDTH
    out[3:5, :] = A @ VariableMatrix(x[3:5, :]) + B @ VariableMatrix(u)
    return out


def differential_drive_problem(N: int = 50, total_time: float = 5.0):
    """Drivetrain trajectory problem (reference
    differential_drive_problem_test): drive from the origin to (1, 1) m.

    Returns (problem, X, U).
    """
    dt = total_time / N
    x_final = np.array([[1.0], [1.0], [0.0], [0.0], [0.0]])
    u_max = 12.0

    ocp = OCP(
        5,
        2,
        dt,
        N,
        dynamics,
        DynamicsType.EXPLICIT_ODE,
        TimestepMethod.FIXED,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    X, U = ocp.X(), ocp.U()
    ocp.constrain_initial_state(np.zeros((5, 1)))
    ocp.constrain_final_state(x_final)
    ocp.subject_to(U >= -u_max)
    ocp.subject_to(U <= u_max)
    ocp.minimize((U**2).sum())
    return ocp, X, U
