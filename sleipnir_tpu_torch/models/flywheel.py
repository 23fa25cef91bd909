"""Flywheel spin-up model and benchmark problem.

Port of `sleipnir_tpu/models/flywheel.py`, matching reference
benchmarks/scalability/flywheel/main.cpp and
python/test/optimization/flywheel_problem_test.py:13-41: discrete linear
dynamics x₊ = A x + B u with A = exp(−dt), B = 1 − exp(−dt), input bounds
±12 V, quadratic tracking cost to r = 10 rad/s. Its stage blocks on the
banded backend are 4 wide: one state, one input and two equality slots,
since stage 0 holds x₀ = 0 beside its dynamics row (as in the JAX
package). Also the minimum-time spin-up of the JAX package's
tests/solver/test_border_backend.py, whose shared timestep is the banded
backend's border column.
"""

from __future__ import annotations

import math

import numpy as np

from sleipnir_tpu_torch.autodiff.variable import Variable
from sleipnir_tpu_torch.optimization.ocp import (
    OCP,
    DynamicsType,
    TimestepMethod,
    TranscriptionMethod,
)
from sleipnir_tpu_torch.optimization.problem import Problem


def flywheel_problem(N: int = 1000, total_time: float = 5.0, fast: bool = True):
    """Build the flywheel tracking problem. Returns (problem, X, U).

    Linear dynamics, quadratic cost and linear bounds: the interior-point
    method, as in the reference. `fast=True` builds the OCP form (banded
    KKT backend); `fast=False` the plain Problem of N loop-built dynamics
    constraints, which solves on the dense backend.
    """
    dt = total_time / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)
    r = 10.0

    if fast:
        # Discrete linear dynamics as one vmapped block, solved with the
        # block-tridiagonal KKT backend.
        def discrete(x, u):
            return A * x + B * u

        ocp = OCP(
            1,
            1,
            dt,
            N,
            discrete,
            DynamicsType.DISCRETE,
            TimestepMethod.FIXED,
            TranscriptionMethod.DIRECT_TRANSCRIPTION,
        )
        X = ocp.X()
        U = ocp.U()
        ocp.constrain_initial_state(0.0)
        ocp.subject_to(U >= -12.0)
        ocp.subject_to(U <= 12.0)
        err = r - X
        ocp.minimize((err**2).sum())
        return ocp, X, U

    problem = Problem()
    X = problem.decision_variable(1, N + 1)
    U = problem.decision_variable(1, N)
    for k in range(N):
        problem.subject_to(X[0, k + 1] == A * X[0, k] + B * U[0, k])
    problem.subject_to(X[0, 0] == 0.0)
    problem.subject_to(U >= -12.0)
    problem.subject_to(U <= 12.0)
    # Minimize the tracking error Σ (r − xₖ)²
    err = r - X
    problem.minimize((err**2).sum())
    return problem, X, U


def flywheel_mpc_problem(N: int = 1000, total_time: float = 5.0):
    """The flywheel tracking OCP as a model predictive controller re-solves
    it: the measured initial state x₀ and the reference r are parameters
    (variables outside the problem), so `set_value` on them and a new
    `solve()` reuse the compiled solver. Starts at x₀ = 0, r = 10, which is
    `flywheel_problem`. Returns (ocp, X, U, x0, r)."""
    dt = total_time / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)

    def discrete(x, u):
        return A * x + B * u

    ocp = OCP(
        1, 1, dt, N, discrete, DynamicsType.DISCRETE, TimestepMethod.FIXED,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    x0, r = Variable(), Variable()
    x0.set_value(0.0)
    r.set_value(10.0)
    ocp.constrain_initial_state(x0)
    ocp.subject_to(ocp.U() >= -12.0)
    ocp.subject_to(ocp.U() <= 12.0)
    ocp.minimize(((r - ocp.X()) ** 2).sum())
    return ocp, ocp.X(), ocp.U(), x0, r


def flywheel_unbounded_problem(N: int = 1000, total_time: float = 5.0):
    """The flywheel OCP without input bounds (the JAX package's
    tests/optimization/test_sqp_banded.py:18-38): equality constraints
    only, so SQP on the banded KKT backend. Returns (ocp, X, U)."""
    dt = total_time / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)

    def discrete(x, u):
        return A * x + B * u

    ocp = OCP(
        1, 1, dt, N, discrete, DynamicsType.DISCRETE, TimestepMethod.FIXED,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(0.0)
    err = 10.0 - ocp.X()
    ocp.minimize((err**2).sum())
    return ocp, ocp.X(), ocp.U()


def flywheel_min_time_problem(N: int = 1000, target: float = 50.0):
    """Spin the flywheel (ẋ = −x/5 + 2u, |u| ≤ 12) up from rest to
    `target` rad/s in minimum time, the timestep one shared decision
    variable in [1e-4, 1] s (`VARIABLE_SINGLE`: the banded backend's
    border column). The JAX package's
    tests/solver/test_border_backend.py:85-121. The optimum rides u = 12
    the whole way: N·dt = −5·ln(1 − target/120) (`min_time_optimum`).
    Returns (ocp, X, U)."""

    def ode(x, u):
        # dx/dt = -x/5 + 2u (reference benchmarks/scalability/flywheel)
        return (-x[0, 0] / 5.0 + 2.0 * u[0, 0]).reshape(1, 1)

    ocp = OCP(
        1, 1, 0.01, N, ode, DynamicsType.EXPLICIT_ODE, TimestepMethod.VARIABLE_SINGLE,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(np.array([[0.0]]))
    ocp.constrain_final_state(np.array([[target]]))
    ocp.set_lower_input_bound(-12.0)
    ocp.set_upper_input_bound(12.0)
    ocp.set_min_timestep(1e-4)
    ocp.set_max_timestep(1.0)
    ocp.minimize(ocp.dt()[0, 0] * N)
    return ocp, ocp.X(), ocp.U()


def min_time_optimum(target: float = 50.0) -> float:
    """The minimum total time of `flywheel_min_time_problem`: the steady
    state at u = 12 is 120 rad/s, so 120(1 − e^(−T/5)) = target."""
    return -5.0 * math.log(1.0 - target / 120.0)


def oracle_failures(Xv, Uv, total_time: float = 5.0) -> list[str]:
    """Plain-numpy checks of a solved trajectory (the JAX package's
    tests/optimization/test_flywheel_problem.py): x₀ = 0, the dynamics
    x_{k+1} = A x_k + B u_k to 1e-8, |u| ≤ 12 + 1e-9, full voltage while
    far from r, the steady-state voltage once there, and x_N at r.
    Returns the checks that fail, empty when all hold."""
    Xv = np.asarray(Xv, dtype=np.float64).reshape(-1)
    Uv = np.asarray(Uv, dtype=np.float64).reshape(-1)
    N = Xv.shape[0] - 1
    dt = total_time / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)
    r = 10.0
    failures = []
    if not abs(Xv[0]) <= 1e-8:
        failures.append(f"x_0 = {Xv[0]}")
    dyn = np.abs(Xv[1:] - (A * Xv[:-1] + B * Uv[:N]))
    if not dyn.max() <= 1e-8:
        failures.append(f"dynamics residual {dyn.max():.3e} at k = {int(dyn.argmax())}")
    if not (np.all(Uv >= -12.0 - 1e-9) and np.all(Uv <= 12.0 + 1e-9)):
        failures.append(f"input outside ±12: [{Uv.min()}, {Uv.max()}]")
    u_ss = 1.0 / B * (1.0 - A) * r
    for k in range(N - 1):
        error = r - Xv[k]
        if error > 0.2 and not abs(Uv[k] - 12.0) <= 1e-4:
            failures.append(f"u_{k} = {Uv[k]} while {error} from r")
        elif error < 1e-4 and k < N - 2 and not abs(Uv[k] - u_ss) <= 1e-2:
            failures.append(f"u_{k} = {Uv[k]} at steady state, not {u_ss}")
    if not abs(Xv[N] - r) <= 1e-2:
        failures.append(f"x_N = {Xv[N]}, not r = {r}")
    return failures
