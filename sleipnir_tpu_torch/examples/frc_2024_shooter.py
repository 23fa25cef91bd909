"""FRC 2024 shooter trajectory optimization on sleipnir_tpu_torch (reference
examples/frc_2024_shooter/main.py).

Finds initial velocity, pitch, and yaw to hit the 2024 FRC speaker target,
minimizing the sensitivity of the landing position to the initial velocity
— a cost built from a *symbolic gradient* (Gradient(...).get()), with
single-shooting RK4 through the DSL.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
from numpy.linalg import norm

import sleipnir_tpu_torch as slp
from sleipnir_tpu_torch import Gradient, Problem, VariableMatrix, block, sqrt

field_width = 8.2296  # m
field_length = 16.4592  # m
g = np.array([[0.0], [0.0], [9.806]])
target_wrt_field = np.array(
    [[0.0], [5.547868], [2.3], [0.0], [0.0], [0.0]]
)
target_wrt_field[0, 0] += 0.458788  # speaker lip offset


def cross(a, b) -> VariableMatrix:
    return VariableMatrix(
        [
            [a[1, 0] * b[2, 0] - a[2, 0] * b[1, 0]],
            [a[2, 0] * b[0, 0] - a[0, 0] * b[2, 0]],
            [a[0, 0] * b[1, 0] - a[1, 0] * b[0, 0]],
        ]
    )


def f(x):
    """Note flight dynamics with drag and Magnus lift
    (reference frc_2024_shooter/main.py:51-88)."""
    rho = 1.204
    v = VariableMatrix(x[3:6, :])
    v2 = (v.T @ v)[0, 0]
    v_norm = sqrt(v2)
    v_hat = v / v_norm
    omega = np.array([[0.0], [-25.0], [0.0]])
    A = math.pi * 0.3556 * 0.0508  # m² (torus cross section)
    m = 0.2353  # kg

    C_D = 0.5
    F_D = 0.5 * rho * v2 * C_D * A
    C_L = 0.5
    F_L = 0.5 * rho * v_norm * C_L * A
    omega_m = VariableMatrix(omega)
    return block(
        [[v], [-g - (F_D / m) * v_hat - (F_L / m) * cross(v, omega_m)]]
    )


def main(N: int = 10, verbose: bool = True, device: str = "cuda"):
    robot_wrt_field = np.array(
        [
            [0.75 * field_length],
            [field_width / 3.0],
            [0.0],
            [1.524],
            [-1.524],
            [0.0],
        ]
    )
    max_initial_velocity = 15.0

    shooter_wrt_robot = np.array(
        [[0.0], [0.0], [0.6096], [0.0], [0.0], [0.0]]
    )
    shooter_wrt_field = robot_wrt_field + shooter_wrt_robot

    problem = Problem()

    T = problem.decision_variable()
    problem.subject_to(T >= 0)
    T.set_value(1.0)
    dt = T / N

    # Disc state [position; velocity]
    x = problem.decision_variable(6)
    x[:3, :].set_value(shooter_wrt_field[:3, :])
    uvec = target_wrt_field[:3, :] - shooter_wrt_field[:3, :]
    uvec = uvec / norm(uvec)
    x[3:, :].set_value(
        robot_wrt_field[3:, :] + max_initial_velocity * uvec
    )

    v0_wrt_shooter = VariableMatrix(x[3:, :]) - shooter_wrt_field[3:, :]

    # Shooter initial position
    problem.subject_to(x[:3, :] == shooter_wrt_field[:3, :])

    # Initial velocity below max
    problem.subject_to(
        (x[3, 0] - robot_wrt_field[3, 0]) ** 2
        + (x[4, 0] - robot_wrt_field[4, 0]) ** 2
        + (x[5, 0] - robot_wrt_field[5, 0]) ** 2
        <= max_initial_velocity**2
    )

    # Single shooting — RK4 integration
    h = dt
    x_k = VariableMatrix(x)
    for _ in range(N - 1):
        k1 = f(x_k)
        k2 = f(x_k + (h / 2) * k1)
        k3 = f(x_k + (h / 2) * k2)
        k4 = f(x_k + h * k3)
        x_k = x_k + (h / 6) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    # Final position in the target; final velocity up
    problem.subject_to(x_k[:3, :] == target_wrt_field[:3, :])
    problem.subject_to(x_k[5, 0] > 0.0)

    # Minimize sensitivity of the landing x-velocity to the initial
    # velocity (symbolic gradient as a cost, reference main.py:212-213)
    sensitivity = Gradient(x_k[3, 0], VariableMatrix(x[3:, :]), device=device).get()
    problem.minimize(sensitivity.T @ sensitivity)

    status = problem.solve(device=device)

    v0 = v0_wrt_shooter.value()
    velocity = norm(v0)
    pitch = math.atan2(v0[2, 0], math.hypot(v0[0, 0], v0[1, 0]))
    yaw = math.atan2(v0[1, 0], v0[0, 0])
    if verbose:
        print(f"status = {status}")
        print(f"Velocity = {velocity:.03f} m/s")
        print(f"Pitch = {np.rad2deg(pitch):.03f} deg")
        print(f"Yaw = {np.rad2deg(yaw):.03f} deg")
        print(f"Total time = {T.value():.03f} s")
    return status, velocity, pitch, yaw


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
