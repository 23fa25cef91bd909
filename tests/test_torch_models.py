"""The port's differential-drive and double-integrator models against
the JAX package's (tests/optimization/test_model_problems.py, at its
sizes): the same exit status and iterations, X and U to 1e-8, and the
numpy oracles of the dynamics."""

import numpy as np
import torch

import jax.numpy as jnp

from sleipnir_tpu.models import differential_drive as jax_dd
from sleipnir_tpu.models import double_integrator as jax_di
from sleipnir_tpu_torch.models import differential_drive, double_integrator
from tests.test_torch_ocp import _assert_same_solve

torch.set_num_threads(1)


def test_differential_drive_matches_jax():
    """tests/optimization/test_model_problems.py:42-70 at N=40, T=4 s in
    both packages, and the RK4 oracle of the plain-double dynamics."""
    N, T = 40, 4.0
    jp, jX, jU = jax_dd.differential_drive_problem(N=N, total_time=T)
    tp, tX, tU = differential_drive.differential_drive_problem(N=N, total_time=T)
    _assert_same_solve(jp, tp, jX, tX, jU, tU)
    Xv, Uv = tX.value(), tU.value()
    np.testing.assert_allclose(Xv[:, 0], np.zeros(5), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xv[:, N], [1.0, 1.0, 0.0, 0.0, 0.0], rtol=0, atol=1e-7)
    dt = T / N
    f = differential_drive.dynamics_numpy
    for k in range(N):
        x, u = Xv[:, k : k + 1], Uv[:, k : k + 1]
        k1 = f(x, u)
        k2 = f(x + dt / 2 * k1, u)
        k3 = f(x + dt / 2 * k2, u)
        k4 = f(x + dt * k3, u)
        expected = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        np.testing.assert_allclose(Xv[:, k + 1], expected.ravel(), rtol=0, atol=1e-7)
    # The tensor dynamics agree with the oracle (and with the JAX model's)
    x = np.array([[0.3], [-0.2], [0.7], [1.1], [0.4]])
    u = np.array([[2.0], [-3.0]])
    got = differential_drive.dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, f(x, u), rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jax_dd.dynamics(jnp.asarray(x), jnp.asarray(u))), rtol=1e-15, atol=0
    )


def test_double_integrator_matches_jax():
    """tests/optimization/test_model_problems.py:16-39 at N=70 in both
    packages, and the exact discrete kinematics and limits."""
    N, T, r = 70, 3.5, 2.0
    jp, jX, jU = jax_di.double_integrator_problem(N=N, total_time=T, r=r)
    tp, tX, tU = double_integrator.double_integrator_problem(N=N, total_time=T, r=r)
    _assert_same_solve(jp, tp, jX, tX, jU, tU)
    Xv, Uv = tX.value(), tU.value()
    dt = T / N
    np.testing.assert_allclose(Xv[:, 0], [0.0, 0.0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xv[:, N], [r, 0.0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        Xv[0, 1:], Xv[0, :-1] + Xv[1, :-1] * dt + 0.5 * Uv[0, :N] * dt * dt, rtol=0, atol=1e-8
    )
    np.testing.assert_allclose(Xv[1, 1:], Xv[1, :-1] + Uv[0, :N] * dt, rtol=0, atol=1e-8)
    assert np.all(np.abs(Xv[1]) <= 1.0 + 1e-9)
    assert np.all(np.abs(Uv[0, :N]) <= 1.0 + 1e-9)
