"""Cart-pole swing-up model and benchmark problem.

Port of `sleipnir_tpu/models/cart_pole.py`. Model from
https://underactuated.mit.edu/acrobot.html#cart_pole, matching reference
test/include/cart_pole_util.hpp:11-118 and the scalability benchmark
problem (reference test/src/optimization/cart_pole_problem_test.cpp:34-88).

States x = [cart position, pole angle (CCW+ from -y), cart velocity,
pole angular velocity]; input u = [horizontal force on cart].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sleipnir_tpu_torch.ops import accurate_math
from sleipnir_tpu_torch.optimization.ocp import (
    OCP,
    DynamicsType,
    TimestepMethod,
    TranscriptionMethod,
)

M_C = 5.0  # Cart mass (kg)
M_P = 0.5  # Pole mass (kg)
L = 0.5  # Pole length (m)
G = 9.806  # Standard gravity (m/s²)


def dynamics(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cart-pole ODE on tensors: x (4, 1), u (1, 1) -> dx/dt (4, 1).

    The OCP layer vmaps it over the horizon. The 2x2 mass matrix is
    inverted in closed form, with the JAX package's operation order, and
    the trig goes through the f64-accurate kernels so it rounds as the JAX
    CPU reference does.
    """
    theta = x[1, 0]
    xdot = x[2, 0]
    thetadot = x[3, 0]
    f_x = u[0, 0]
    c = accurate_math.cos(theta)
    s = accurate_math.sin(theta)

    # M(q) = [[m_c + m_p, m_p l cosθ], [m_p l cosθ, m_p l²]]
    m00 = M_C + M_P
    m01 = M_P * L * c
    m11 = M_P * L * L
    det = m00 * m11 - m01 * m01

    # rhs = τ_g − C(q, q̇)q̇ + Bu
    rhs0 = M_P * L * thetadot * s * thetadot + f_x
    rhs1 = -M_P * G * L * s

    qddot0 = (m11 * rhs0 - m01 * rhs1) / det
    qddot1 = (-m01 * rhs0 + m00 * rhs1) / det
    return torch.stack([xdot, thetadot, qddot0, qddot1]).reshape(4, 1)


def cart_pole_problem(
    N: int = 100,
    total_time: float = 5.0,
    u_max: float = 20.0,
    d_max: float = 2.0,
):
    """Build the cart-pole swing-up OCP (reference
    cart_pole_problem_test.cpp:34-88). Returns (problem, X, U)."""
    dt = total_time / N
    x_initial = np.array([[0.0], [0.0], [0.0], [0.0]])
    x_final = np.array([[1.0], [math.pi], [0.0], [0.0]])

    ocp = OCP(
        4,
        1,
        dt,
        N,
        dynamics,
        DynamicsType.EXPLICIT_ODE,
        TimestepMethod.FIXED,
        TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    X = ocp.X()
    U = ocp.U()

    # Linearly interpolated initial guess for position and angle
    guess = np.zeros((4, N + 1))
    guess[0] = np.linspace(x_initial[0, 0], x_final[0, 0], N + 1)
    guess[1] = np.linspace(x_initial[1, 0], x_final[1, 0], N + 1)
    X.set_value(guess)

    ocp.constrain_initial_state(x_initial)
    ocp.constrain_final_state(x_final)

    # Cart position constraints: 0 ≤ x ≤ d_max
    ocp.subject_to(X[0:1, :] >= 0.0)
    ocp.subject_to(X[0:1, :] <= d_max)

    # Input constraints: |u| ≤ u_max
    ocp.subject_to(U >= -u_max)
    ocp.subject_to(U <= u_max)

    # Minimize sum squared inputs
    ocp.minimize((U**2).sum())

    return ocp, X, U


def dynamics_numpy(x, u):
    """Plain-double dynamics for physics oracles (reference
    cart_pole_util.hpp dynamics_scalar)."""
    x = np.asarray(x, dtype=np.float64).reshape(4, 1)
    u = np.asarray(u, dtype=np.float64).reshape(1, 1)
    theta = x[1, 0]
    thetadot = x[3, 0]
    c, s = math.cos(theta), math.sin(theta)
    M = np.array([[M_C + M_P, M_P * L * c], [M_P * L * c, M_P * L * L]])
    C = np.array([[0.0, -M_P * L * thetadot * s], [0.0, 0.0]])
    tau_g = np.array([[0.0], [-M_P * G * L * s]])
    B = np.array([[1.0], [0.0]])
    qdot = x[2:4, :]
    qddot = np.linalg.solve(M, tau_g - C @ qdot + B @ u)
    return np.vstack([qdot, qddot])


def rk4_numpy(f, x, u, dt):
    """Plain-double RK4 oracle (reference test/include/rk4.hpp)."""
    h = dt
    k1 = f(x, u)
    k2 = f(x + h * 0.5 * k1, u)
    k3 = f(x + h * 0.5 * k2, u)
    k4 = f(x + h * k3, u)
    return x + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
