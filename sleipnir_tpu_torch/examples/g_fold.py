"""Guided fuel-optimal landing diversion (G-FOLD) on sleipnir_tpu_torch —
reference examples/g-fold/main.py.

Solves the lossless-convexified soft-landing problem (Açıkmeşe et al.,
problems 3/4): minimum-fuel powered descent with glide-slope, thrust-cone,
velocity, and thrust-magnitude constraints, with an optional golden-section
search over the horizon length N (reference g-fold/main.py:66-80).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
from numpy.linalg import norm
from scipy.signal import cont2discrete

from sleipnir_tpu_torch import ExitStatus, Problem, bounds


def lerp(a, b, t):
    return a + t * (b - a)


def golden_section_search(f, first: int, last: int):
    """Golden-section search over the unimodal integer function f
    (reference g-fold/main.py:31-63)."""
    phi_inv = (math.sqrt(5) - 1) / 2
    b = round(lerp(first, last, phi_inv))
    b_sol = f(b)
    while abs(last - first) > 1:
        a = round(lerp(first, b, phi_inv))
        a_sol = f(a)
        if a_sol[0] < b_sol[0]:
            b_sol = a_sol
            last = b
            b = a
        else:
            first = last
            last = a
    return b, b_sol


def main(
    N: int | None = 25, search: bool = False, verbose: bool = True, device: str = "cuda"
):
    # Section IV of Açıkmeşe et al. 2013
    m_wet = 2000.0  # kg
    m_fuel = 300.0  # kg
    m_dry = m_wet - m_fuel
    T_max = 24000.0  # N
    rho_1 = 0.2 * T_max
    rho_2 = 0.8 * T_max
    alpha = 5e-4  # s/m

    q_0 = np.array([[2400.0, 450.0, -330.0]]).T
    v_0 = np.array([[-10.0, -40.0, 10.0]]).T
    q_f = np.zeros((3, 1))
    v_f = np.zeros((3, 1))
    g = np.array([[-3.71, 0.0, 0.0]]).T
    omega = np.array([[2.53e-5, 0.0, 6.62e-5]]).T
    theta = math.radians(90)  # thrust pointing limit
    gamma_gs = math.radians(30)  # glide slope
    v_max = 90.0
    dt = 0.5
    end_straight = True

    w1, w2, w3 = omega[0, 0], omega[1, 0], omega[2, 0]
    S = np.array([[0.0, -w3, w2], [w3, 0.0, -w1], [-w2, w1, 0.0]])
    A = np.block([[np.zeros((3, 3)), np.identity(3)], [-S @ S, -2 * S]])
    B = np.block([[np.zeros((3, 3))], [np.identity(3)]])
    A_d, B_d, _, _, _ = cont2discrete(
        (A, B, np.identity(3), np.zeros((3, 3))), dt
    )

    def solve(N: int):
        problem = Problem()

        X = problem.decision_variable(6, N + 1)  # [position, velocity]
        Z = problem.decision_variable(1, N + 1)  # ln(m)
        U = problem.decision_variable(3, N)  # T_c/m
        sigma = problem.decision_variable(1, N)  # Γ/m

        q = X[:3, :]
        v = X[3:6, :]

        problem.subject_to(q[:, 0:1] == q_0)
        problem.subject_to(v[:, 0:1] == v_0)
        problem.subject_to(Z[0, 0] == math.log(m_wet))
        problem.subject_to(q[:, N : N + 1] == q_f)
        problem.subject_to(v[:, N : N + 1] == v_f)

        guess = np.zeros((6, N + 1))
        for i in range(3):
            guess[i] = np.linspace(q_0[i, 0], q_f[i, 0], N + 1)
            guess[3 + i] = np.linspace(v_0[i, 0], v_f[i, 0], N + 1)
        X.set_value(guess)

        for k in range(N + 1):
            t = k * dt
            q_k = X[:3, k : k + 1]
            v_k = X[3:6, k : k + 1]
            z_k = Z[0, k]

            # Velocity limit
            problem.subject_to(v_k.T @ v_k <= v_max**2)

            z_min = math.log(m_wet - alpha * rho_2 * t)
            z_max = math.log(m_wet - alpha * rho_1 * t)
            z_estimate = (z_min + z_max) / 2
            Z[0, k].set_value(z_estimate)

            if k < N:
                x_k = X[:, k : k + 1]
                x_k1 = X[:, k + 1 : k + 2]
                z_k1 = Z[0, k + 1]
                u_k = U[:, k : k + 1]
                sigma_k = sigma[0, k]

                u_min = rho_1 / math.exp(z_estimate)
                u_max = rho_2 / math.exp(z_estimate)
                U[:, k : k + 1].set_value(
                    np.array([[(u_min + u_max) / 2], [0.0], [0.0]])
                )

                # Glide slope (eq (12) of [1])
                problem.subject_to(
                    (X[0, k] - q_f[0, 0]) ** 2
                    >= math.tan(gamma_gs) ** 2
                    * (
                        (X[1, k] - q_f[1, 0]) ** 2
                        + (X[2, k] - q_f[2, 0]) ** 2
                    )
                )

                problem.subject_to(sigma_k >= 0)

                if k == N - 1 and end_straight:
                    problem.subject_to(U[0, k] == sigma_k)
                    problem.subject_to(U[1, k] == 0)
                    problem.subject_to(U[2, k] == 0)
                else:
                    # Thrust magnitude limit (eq (34) of [1])
                    problem.subject_to(u_k.T @ u_k <= sigma_k**2)
                    # Thrust pointing limit
                    problem.subject_to(U[0, k] >= math.cos(theta) * sigma_k)

                # Thrust slack limits (eq (34) of [2])
                z_0 = math.log(m_wet - alpha * rho_2 * t)
                mu_1 = rho_1 * math.exp(-z_0)
                mu_2 = rho_2 * math.exp(-z_0)
                sigma_min = mu_1 * (
                    1 - (z_k - z_0) + 0.5 * (z_k - z_0) ** 2
                )
                sigma_max = mu_2 * (1 - (z_k - z_0))
                problem.subject_to(bounds(sigma_min, sigma_k, sigma_max))
                sigma[0, k].set_value(
                    (sigma_min.value() + sigma_max.value()) / 2
                )

                # Discretized dynamics (eq (2) of [1])
                problem.subject_to(x_k1 == A_d @ x_k + B_d @ (g + u_k))
                problem.subject_to(z_k1 == z_k - alpha * dt * sigma_k)

        # Problem 4 of [1]: minimum fuel
        problem.minimize(sigma.sum())
        status = problem.solve(device=device)
        cost = float(np.sum(sigma.value()))
        return cost if status == ExitStatus.SUCCESS else math.inf, status, X

    if search:
        t_min = m_dry * norm(v_0) / rho_2
        t_max = m_fuel / (alpha * rho_1)
        N_min = math.ceil(t_min / dt)
        N_max = math.floor(t_max / dt)
        N, (cost, status, X) = golden_section_search(solve, N_min, N_max)
    else:
        cost, status, X = solve(N)

    if verbose:
        print(f"N = {N}: status = {status}, fuel cost = {cost:.4f}")
        print("final position:", X.value()[:3, -1].ravel())
    return status, cost


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--N", type=int, default=25)
    parser.add_argument("--search", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.N, args.search, device=args.device)
