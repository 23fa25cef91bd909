"""Plain reference for the cart-pole swing-up (Sleipnir's
test/src/optimization/cart_pole_problem_test.cpp:34-88 and
benchmarks/scalability/cart_pole/main.cpp), in NumPy float64.

It judges a solution the program returned: the states X (4, N+1) and
inputs U (1, N+1) of one solve. It rebuilds the problem from the
configuration alone (the physics of Sleipnir's
test/include/cart_pole_util.hpp, RK4 over a fixed dt, x₀ = 0,
x_N = [1, π, 0, 0], 0 ≤ position ≤ d_max, |u| ≤ u_max, cost Σu²) and
returns three numbers, the last two over max(1, ‖∇f‖∞):

  viol   the largest violation of any constraint: the dynamics defects,
         both boundary states and the bounds, in the model's own units;
  stat   stationarity: with the least-squares multipliers of the equality
         rows and of the bound rows within NEAR of their bound, the larger
         of ‖∇f − Jᵀμ‖∞ and the largest bound multiplier of the wrong sign;
  compl  complementarity: the largest product of a bound multiplier and
         its slack.

Derivatives of the RK4 step come from complex steps, exact to rounding.
Nothing here imports the program: it reads only the arrays it is given.
"""

from __future__ import annotations

import math

import numpy as np

M_C = 5.0  # cart mass (kg)
M_P = 0.5  # pole mass (kg)
L = 0.5  # pole length (m)
G = 9.806  # gravity (m/s²)
TARGET = np.array([1.0, math.pi, 0.0, 0.0])
#: A bound row whose slack is at most this takes a multiplier. An
#: interior-point solution leaves a bound's multiplier z and its slack s
#: with s·z near its last barrier parameter, so a bound further away than
#: NEAR has z at most that over NEAR.
NEAR = 1e-3
#: Complex-step size: the derivative is Im f(x + ih) / h, exact to rounding.
H = 1e-30


def dynamics(x, u):
    """dx/dt of cart-pole for x (4, K) and u (K,), any float or complex
    dtype: M(q) q̈ = τ_g − C(q, q̇) q̇ + B u, M solved in closed form."""
    theta, thetadot = x[1], x[3]
    c, s = np.cos(theta), np.sin(theta)
    m00, m01, m11 = M_C + M_P, M_P * L * c, M_P * L * L
    rhs0 = M_P * L * thetadot * s * thetadot + u
    rhs1 = -M_P * G * L * s
    det = m00 * m11 - m01 * m01
    return np.stack([x[2], thetadot, (m11 * rhs0 - m01 * rhs1) / det,
                     (m00 * rhs1 - m01 * rhs0) / det])


def rk4(x, u, dt):
    k1 = dynamics(x, u)
    k2 = dynamics(x + 0.5 * dt * k1, u)
    k3 = dynamics(x + 0.5 * dt * k2, u)
    k4 = dynamics(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

#: The limit of each number `judge` returns, over every solve of a run,
#: set from readings at the cells' sizes on the H100 (`perfbench/control.py`;
#: PERF.md §2): above the largest of the program in float64 (viol 7.2e-12,
#: stat 5.3e-8, compl 6.9e-11) and below the smallest that separates from it:
#: for viol the float64 answers rounded to float32 (3.7e-7), for compl a
#: solve stopped at 100 times the stated tolerance (2.5e-9), for stat the
#: float32 path (2049), whose viol and compl read 0.25 and 0.95 or more.
LIMITS = {"viol": 1e-8, "stat": 1e-2, "compl": 1e-9}


def judge(cfg: dict, outputs: dict) -> dict:
    """{"viol": ..., "stat": ..., "compl": ..., "cost": ...} of one solution: the
    outputs X and U of a solve."""
    X, U = outputs["X"], outputs["U"]
    N = int(cfg["N"])
    dt = float(cfg["total_time"]) / N
    d_max, u_max = float(cfg["d_max"]), float(cfg["u_max"])
    X = np.asarray(X, dtype=np.float64).reshape(4, N + 1)
    u = np.asarray(U, dtype=np.float64).reshape(N + 1)
    xk, uk = X[:, :-1], u[:-1]
    defects = X[:, 1:] - rk4(xk, uk, dt)
    viol = max(
        np.abs(X[:, 0]).max(), np.abs(X[:, N] - TARGET).max(), np.abs(defects).max(),
        np.maximum(-X[0], 0.0).max(), np.maximum(X[0] - d_max, 0.0).max(),
        np.maximum(np.abs(u) - u_max, 0.0).max(),
    )

    # Variables in this order: X row-major (4·(N+1)), then u (N+1).
    nx = 4 * (N + 1)
    n = nx + N + 1

    def xi(row, k):
        return row * (N + 1) + k

    grad = np.zeros(n)
    grad[nx:] = 2.0 * u
    rows = []
    for i in range(4):  # x₀ and x_N
        for k in (0, N):
            r = np.zeros(n)
            r[xi(i, k)] = 1.0
            rows.append(r)
    # ∂ rk4 / ∂(x, u) per step, by complex steps along each of the 5 inputs.
    jac = np.empty((5, 4, N))
    for j in range(5):
        xc, uc = xk.astype(np.complex128), uk.astype(np.complex128)
        if j < 4:
            xc[j] += 1j * H
        else:
            uc += 1j * H
        jac[j] = rk4(xc, uc, dt).imag / H
    defect_rows = np.zeros((4 * N, n))
    for k in range(N):
        for i in range(4):
            r = defect_rows[4 * k + i]
            r[xi(i, k + 1)] = 1.0
            for j in range(4):
                r[xi(j, k)] = -jac[j, i, k]
            r[nx + k] = -jac[4, i, k]
    rows = np.vstack([np.array(rows), defect_rows])
    # Bound rows c(v) ≥ 0 with ∇c = ±eⱼ: (slack, column, sign of ∇c).
    bound = []
    for k in range(N + 1):
        for slack, col, sign in ((X[0, k], xi(0, k), 1.0), (d_max - X[0, k], xi(0, k), -1.0),
                                 (u[k] + u_max, nx + k, 1.0), (u_max - u[k], nx + k, -1.0)):
            if slack <= NEAR:
                bound.append((slack, col, sign))
    B = np.zeros((len(bound), n))
    for i, (_slack, col, sign) in enumerate(bound):
        B[i, col] = sign
    A = np.vstack([rows, B])
    # ∇f = Jₑᵀλ + Σ zᵢ ∇cᵢ with zᵢ ≥ 0 at a KKT point.
    mult, *_ = np.linalg.lstsq(A.T, grad, rcond=None)
    z = mult[len(rows):]
    slacks = np.array([slack for slack, _col, _sign in bound])
    scale = max(1.0, np.abs(grad).max())
    stat = max(np.abs(grad - A.T @ mult).max(), np.maximum(-z, 0.0).max(initial=0.0)) / scale
    compl = (np.maximum(z, 0.0) * np.maximum(slacks, 0.0)).max(initial=0.0) / scale
    return {"viol": float(viol), "stat": float(stat), "compl": float(compl),
            "cost": float(np.sum(u * u))}
