"""The port's examples (`sleipnir_tpu_torch/examples/`) against the JAX
package's (`examples/`), on the CPU.

The current manager is held to the cases of
tests/examples/test_current_manager.py. Each of the other examples here
runs through the JAX example, imported from `examples/` by path, and
through the port's at the same published size: the exit statuses are
equal, and the costs and solutions agree within 1e-6 relative or 1e-8
absolute (`TOL`), whichever is looser. The shooter of 2024 and G-FOLD
have files of their own (`test_torch_examples_frc2024.py`,
`test_torch_examples_gfold.py`)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.examples import (
    constrained_multitag,
    current_manager,
    flywheel_direct_transcription,
    flywheel_ocp,
    frc_2022_shooter,
)

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

#: Relative and absolute tolerance of every value compared with the JAX
#: example's.
TOL = {"rtol": 1e-6, "atol": 1e-8}


def jax_example(name: str):
    """The JAX package's example module `examples/<name>.py`, loaded by
    path under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_current_manager_enough_current():
    manager = current_manager.CurrentManager([1.0, 5.0, 10.0, 5.0], 40.0, device="cpu")
    currents = manager.calculate([25.0, 10.0, 5.0, 0.0])

    assert currents[0] == pytest.approx(25.0, abs=1e-3)
    assert currents[1] == pytest.approx(10.0, abs=1e-3)
    assert currents[2] == pytest.approx(5.0, abs=1e-3)
    assert currents[3] == pytest.approx(0.0, abs=1e-3)


def test_current_manager_not_enough_current():
    manager = current_manager.CurrentManager([1.0, 5.0, 10.0, 5.0], 40.0, device="cpu")
    currents = manager.calculate([30.0, 10.0, 5.0, 0.0])

    assert currents[0] == pytest.approx(29.960, abs=1e-3)
    assert currents[1] == pytest.approx(9.008, abs=1e-3)
    assert currents[2] == pytest.approx(1.032, abs=1e-3)
    assert currents[3] == pytest.approx(0.0, abs=1e-3)


def test_flywheel_ocp_matches_jax():
    jstatus, jocp = jax_example("flywheel_ocp").main(verbose=False)
    tstatus, tocp = flywheel_ocp.main(verbose=False, device="cpu")
    assert int(tstatus) == int(jstatus) == int(tslp.ExitStatus.SUCCESS)
    np.testing.assert_allclose(tocp.X().value(), jocp.X().value(), **TOL)
    np.testing.assert_allclose(tocp.U().value(), jocp.U().value(), **TOL)
    # The OCP form takes the banded backend (K1/K2 on the card).
    [bundle] = [v for k, v in tocp._solver_cache.items() if k[0] == "ipm"]
    assert type(bundle[-1]).__name__ == "BandedBackend"


def test_flywheel_direct_transcription_matches_jax():
    jstatus, jX, jU = jax_example("flywheel_direct_transcription").main(verbose=False)
    tstatus, tX, tU = flywheel_direct_transcription.main(verbose=False, device="cpu")
    assert int(tstatus) == int(jstatus) == int(tslp.ExitStatus.SUCCESS)
    np.testing.assert_allclose(tX.value(), jX.value(), **TOL)
    np.testing.assert_allclose(tU.value(), jU.value(), **TOL)


def test_constrained_multitag_matches_jax():
    jstatus, *jpose = jax_example("constrained_multitag").main(verbose=False)
    tstatus, *tpose = constrained_multitag.main(verbose=False, device="cpu")
    assert int(tstatus) == int(jstatus) == int(tslp.ExitStatus.SUCCESS)
    np.testing.assert_allclose(tpose, jpose, **TOL)


def test_frc_2022_shooter_matches_jax():
    jstatus, *jshot = jax_example("frc_2022_shooter").main(verbose=False)
    tstatus, *tshot = frc_2022_shooter.main(verbose=False, device="cpu")
    assert int(tstatus) == int(jstatus) == int(tslp.ExitStatus.SUCCESS)
    # velocity (m/s), pitch and yaw (rad)
    np.testing.assert_allclose(tshot, jshot, **TOL)
