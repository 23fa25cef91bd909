"""Flywheel direct transcription example on sleipnir_tpu_torch (reference
examples/flywheel_direct_transcription/main.py): the same spin-up posed
directly through the Problem DSL."""

from __future__ import annotations

import argparse
import math

import sleipnir_tpu_torch as slp


def main(N: int = 100, total_time: float = 5.0, verbose: bool = True, device: str = "cuda"):
    dt = total_time / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)

    problem = slp.Problem()
    X = problem.decision_variable(1, N + 1)
    U = problem.decision_variable(1, N)

    # Dynamics constraint
    for k in range(N):
        problem.subject_to(
            X[:, k + 1 : k + 2] == A * X[:, k : k + 1] + B * U[:, k : k + 1]
        )

    # State and input constraints
    problem.subject_to(X[0, 0] == 0.0)
    problem.subject_to(U >= -12)
    problem.subject_to(U <= 12)

    # Cost — minimize error from reference
    r = 10.0
    err = r - X
    problem.minimize((err**2).sum())

    status = problem.solve(device=device)
    if verbose:
        print(f"status = {status}")
        print(f"final velocity = {X.value(0, N):.4f} rad/s")
    return status, X, U


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
