"""Double integrator models and problems.

Port of `sleipnir_tpu/models/double_integrator.py` (reference
python/test/optimization/double_integrator_problem_test.py:7-49): states
x = [position, velocity], input u = [acceleration], exact discrete
kinematics p₊ = p + v·dt + a·dt²/2, v₊ = v + a·dt. Also the minimum-time
double integrator of the JAX package's
tests/solver/test_border_backend.py:21-46 (ẋ = [v, a], the timestep a
decision variable), which exercises the variable-timestep methods.
"""

from __future__ import annotations

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.ocp import (
    OCP,
    DynamicsType,
    TimestepMethod,
    TranscriptionMethod,
)


def double_integrator_problem(N: int = 100, total_time: float = 3.5, r: float = 2.0):
    """Move distance r, start and end at rest, |v| ≤ 1, |a| ≤ 1.

    Returns (problem, X, U).
    """
    dt = total_time / N

    def discrete(x, u):
        p, v = x[0, 0], x[1, 0]
        a = u[0, 0]
        return torch.stack([p + v * dt + 0.5 * a * dt * dt, v + a * dt]).reshape(2, 1)

    ocp = OCP(
        2,
        1,
        dt,
        N,
        discrete,
        DynamicsType.DISCRETE,
        TimestepMethod.FIXED,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    X, U = ocp.X(), ocp.U()
    ocp.constrain_initial_state(np.array([[0.0], [0.0]]))
    ocp.constrain_final_state(np.array([[r], [0.0]]))

    # Velocity and acceleration limits
    ocp.subject_to(X[1:2, :] >= -1.0)
    ocp.subject_to(X[1:2, :] <= 1.0)
    ocp.subject_to(U >= -1.0)
    ocp.subject_to(U <= 1.0)

    # Minimize position error
    err = r - X[0:1, :]
    ocp.minimize((err**2).sum())
    return ocp, X, U


def ode(x, u):
    """ẋ = [v, a] on tensors: x (2, 1), u (1, 1) -> (2, 1)."""
    return torch.stack([x[1, 0], u[0, 0]]).reshape(2, 1)


def min_time_problem(N: int, method: TimestepMethod):
    """Reach position 1 at rest from rest in minimum time, |a| ≤ 1, with
    the timestep a decision variable (`VARIABLE_SINGLE`: one shared dt;
    `VARIABLE`: one per step) in [1e-3, 1] s. The bang-bang optimum takes
    2 s. Returns the OCP."""
    ocp = OCP(
        2,
        1,
        0.05,
        N,
        ode,
        DynamicsType.EXPLICIT_ODE,
        method,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(np.array([[0.0], [0.0]]))
    ocp.constrain_final_state(np.array([[1.0], [0.0]]))
    ocp.set_lower_input_bound(-1.0)
    ocp.set_upper_input_bound(1.0)
    ocp.set_min_timestep(1e-3)
    ocp.set_max_timestep(1.0)
    if method == TimestepMethod.VARIABLE_SINGLE:
        ocp.minimize(ocp.dt()[0, 0] * N)
    else:
        ocp.minimize(ocp.dt()[0, :].sum())
    return ocp
