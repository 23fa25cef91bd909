"""Constrained multi-tag pose estimation on sleipnir_tpu_torch (reference
examples/constrained_multitag/main.py).

Estimates a planar robot pose from AprilTag reprojection observations by
minimizing squared reprojection error through a symbolic camera model
(4x4 homogeneous transforms, a symbolic matrix inverse via solve()).
"""

from __future__ import annotations

import argparse

import numpy as np

from sleipnir_tpu_torch import Problem, Variable, VariableMatrix, cos, sin, solve


def main(verbose: bool = True, device: str = "cuda"):
    problem = Problem()

    # Camera calibration
    fx, fy, cx, cy = 600, 600, 300, 150

    # Robot pose
    robot_x = problem.decision_variable()
    robot_y = problem.decision_variable()
    robot_z = Variable(0)
    robot_theta = problem.decision_variable()

    sin_t = sin(robot_theta)
    cos_t = cos(robot_theta)

    var0 = Variable(0)
    var1 = Variable(1)
    field2robot = VariableMatrix(
        [
            [cos_t, -sin_t, var0, robot_x],
            [sin_t, cos_t, var0, robot_y],
            [var0, var0, var1, robot_z],
            [var0, var0, var0, var1],
        ]
    )

    # Robot is ENU, cameras are SDE
    robot2camera = np.array(
        [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float64,
    )

    field2camera = field2robot @ robot2camera

    # Field-space target points to reproject (x, y, z, 1)
    field2points = [
        VariableMatrix([[2, 0 - 0.08255, 0.4, 1]]).T,
        VariableMatrix([[2, 0 + 0.08255, 0.4, 1]]).T,
    ]
    # Observed pixel coordinates
    point_observations = [(325, 30), (275, 30)]

    # Initial guess; expected convergence to (0, 0, 0)
    robot_x.set_value(-0.1)
    robot_y.set_value(0.0)
    robot_theta.set_value(0.2)

    camera2field = solve(field2camera, VariableMatrix(np.identity(4)))

    J = 0
    for field2point, observation in zip(field2points, point_observations):
        camera2point = camera2field @ field2point
        x = camera2point[0, 0]
        y = camera2point[1, 0]
        z = camera2point[2, 0]

        u_observed, v_observed = observation
        u = fx * (x / z) + cx
        v = fy * (y / z) + cy

        u_err = u - u_observed
        v_err = v - v_observed
        J += u_err**2 + v_err**2

    problem.minimize(J)
    status = problem.solve(device=device)

    if verbose:
        print(f"status = {status}")
        print(f"x = {robot_x.value()} m")
        print(f"y = {robot_y.value()} m")
        print(f"theta = {robot_theta.value()} rad")
    return status, robot_x.value(), robot_y.value(), robot_theta.value()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
