"""The port's FRC 2024 shooter example against the JAX package's, on the
CPU, in a file of its own: the JAX example alone takes over a minute.

At its published size (N=10) the JAX example ends NONFINITE_INITIAL_GUESS:
its cost is built from a symbolic gradient (`Gradient(...).get()`) that
is not finite at the initial guess. The port states the same problem and
reproduces that status with the same initial velocity, pitch and yaw; it
does not correct the example. The port's `Gradient` builds the symbolic
gradient without a card, so the example also runs at its default device
until the solve."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.examples import frc_2024_shooter

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_frc_2024_shooter_matches_jax():
    spec = importlib.util.spec_from_file_location(
        "jax_example_frc_2024_shooter", EXAMPLES / "frc_2024_shooter.py"
    )
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)

    jstatus, *jshot = jax_example.main(verbose=False)
    tstatus, *tshot = frc_2024_shooter.main(verbose=False, device="cpu")
    assert int(tstatus) == int(jstatus) == int(tslp.ExitStatus.NONFINITE_INITIAL_GUESS)
    # velocity (m/s), pitch and yaw (rad) at the initial guess
    np.testing.assert_allclose(tshot, jshot, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tshot[0], 15.0, rtol=1e-12)
