"""Flywheel OCP example on sleipnir_tpu_torch (reference examples/flywheel_ocp/main.py):
spin a flywheel up to 10 rad/s through the OCP class."""

from __future__ import annotations

import argparse
import math

import sleipnir_tpu_torch as slp


def main(N: int = 100, total_time: float = 5.0, verbose: bool = True, device: str = "cuda"):
    dt = total_time / N
    A_d = math.exp(-dt)
    B_d = 1.0 - math.exp(-dt)
    r = 10.0

    def dynamics(x, u):
        return A_d * x + B_d * u

    ocp = slp.OCP(
        1,
        1,
        dt,
        N,
        dynamics,
        slp.DynamicsType.DISCRETE,
        slp.TimestepMethod.FIXED,
        slp.TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(0.0)
    ocp.set_lower_input_bound(-12.0)
    ocp.set_upper_input_bound(12.0)

    err = r - ocp.X()
    ocp.minimize((err**2).sum())

    status = ocp.solve(device=device)
    if verbose:
        print(f"status = {status}")
        print(f"final velocity = {ocp.X().value(0, N):.4f} rad/s")
    return status, ocp


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(device=parser.parse_args().device)
