"""FRC 2022 shooter trajectory optimization on sleipnir_tpu_torch (reference
examples/frc_2022_shooter/main.py).

Finds the initial velocity, pitch, and yaw for a game piece to hit the
2022 FRC target, minimizing initial velocity, with air resistance and
Magnus lift, variable flight duration, and a keep-out cone around the
target — direct transcription through the Problem DSL.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
from numpy.linalg import norm

import sleipnir_tpu_torch as slp
from sleipnir_tpu_torch import Problem, VariableMatrix, block, sqrt

field_width = 8.2296  # 27 ft -> m
field_length = 16.4592  # 54 ft -> m
target_wrt_field = np.array(
    [[field_length / 2.0], [field_width / 2.0], [2.64], [0.0], [0.0], [0.0]]
)
target_radius = 0.61  # m
cone_angle = math.pi / 4  # rad
g = np.array([[0.0], [0.0], [9.806]])  # m/s²


def lerp(a, b, t):
    return a + t * (b - a)


def cross(a, b) -> VariableMatrix:
    """3-vector cross product a x b via cyclic index rotation."""
    rows = []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        rows.append([a[i, 0] * b[j, 0] - a[j, 0] * b[i, 0]])
    return VariableMatrix(rows)


def f(x):
    """Ball flight dynamics with drag and Magnus lift
    (reference frc_2022_shooter/main.py:46-90)."""
    rho = 1.204  # kg/m³
    v = VariableMatrix(x[3:6, :])
    v2 = (v.T @ v)[0, 0]
    v_norm = sqrt(v2)
    v_hat = v / v_norm
    omega = np.array([[0.0], [-2.0], [0.0]])  # rad/s
    r = 0.15  # m
    A = math.pi * r**2  # m²
    m = 0.283  # kg

    C_D = 0.5
    F_D = 0.5 * rho * v2 * C_D * A
    C_L = 0.5
    F_L = 0.5 * rho * v_norm * C_L * A

    omega_m = VariableMatrix(omega)
    return block(
        [[v], [-g - (F_D / m) * v_hat - (F_L / m) * cross(v, omega_m)]]
    )


def main(N: int = 30, verbose: bool = True, device: str = "cuda"):
    robot_wrt_field = np.array(
        [
            [field_length / 4.0],
            [field_width / 4.0],
            [0.0],
            [1.524],
            [-1.524],
            [0.0],
        ]
    )
    max_initial_velocity = 10.0  # m/s

    shooter_wrt_robot = np.array(
        [[0.0], [0.0], [1.2], [0.0], [0.0], [0.0]]
    )
    shooter_wrt_field = robot_wrt_field + shooter_wrt_robot

    problem = Problem()

    T = problem.decision_variable()
    problem.subject_to(T >= 0)
    T.set_value(1.0)
    dt = T / N

    X = problem.decision_variable(6, N)
    p = X[:3, :]
    v = X[3:, :]

    # Initial guesses: lerp positions, max velocity toward target
    guess = np.zeros((6, N))
    for k in range(N):
        for i in range(3):
            guess[i, k] = lerp(
                shooter_wrt_field[i, 0], target_wrt_field[i, 0], k / N
            )
    uvec = target_wrt_field[:3, :] - shooter_wrt_field[:3, :]
    uvec = uvec / norm(uvec)
    for k in range(N):
        guess[3:, k : k + 1] = (
            robot_wrt_field[3:, :] + max_initial_velocity * uvec
        )
    X.set_value(guess)

    v0_wrt_shooter = VariableMatrix(X[3:, 0:1]) - shooter_wrt_field[3:, :]

    # Shooter initial position
    problem.subject_to(p[:, 0:1] == shooter_wrt_field[:3, :])

    # Initial velocity below max
    problem.subject_to(
        (X[3, 0] - robot_wrt_field[3, 0]) ** 2
        + (X[4, 0] - robot_wrt_field[4, 0]) ** 2
        + (X[5, 0] - robot_wrt_field[5, 0]) ** 2
        <= max_initial_velocity**2
    )

    # Keep-out region: outside the cylinder or inside the cone
    x_c = target_wrt_field[0, 0]
    y_c = target_wrt_field[1, 0]
    z_c = target_wrt_field[2, 0] - target_radius / math.tan(cone_angle)
    for k in range(N):
        x_k = X[0, k]
        y_k = X[1, k]
        z_k = X[2, k]
        x2 = (x_k - x_c) ** 2
        y2 = (y_k - y_c) ** 2
        z2 = (z_k - z_c) ** 2
        cylinder = x2 + y2 - target_radius**2
        cone = z2 * math.tan(cone_angle) ** 2 - x2 - y2
        problem.subject_to(slp.max(cylinder, cone) >= 0)

    # Dynamics constraints — RK4 integration
    h = dt
    for k in range(N - 1):
        x_k = VariableMatrix(X[:, k : k + 1])
        x_k1 = X[:, k + 1 : k + 2]
        k1 = f(x_k)
        k2 = f(x_k + (h / 2) * k1)
        k3 = f(x_k + (h / 2) * k2)
        k4 = f(x_k + h * k3)
        problem.subject_to(
            x_k1 == x_k + (h / 6) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        )

    # Final position in target center; final velocity down
    problem.subject_to(p[:, N - 1 : N] == target_wrt_field[:3, :])
    problem.subject_to(X[5, N - 1] < 0.0)

    # Minimize initial velocity
    problem.minimize(v0_wrt_shooter.T @ v0_wrt_shooter)

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
