"""The port's `regularized_ldlt` (optimization/solver/util/
regularized_ldlt.py) against the JAX package's, in float32 and float64,
on the inputs of the JAX package's tests/solver/test_ldlt.py:62-95: the
δ and γ it settles on, whether it succeeded, and the pivots d."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sleipnir_tpu.optimization.solver.util import regularized_ldlt as jreg
from sleipnir_tpu_torch.ops.ldlt import inertia
from sleipnir_tpu_torch.optimization.solver.util import regularized_ldlt as treg

torch.set_num_threads(1)

#: Pivot tolerance, relative to the largest |d|: the two packages factor
#: the same matrix by the same unpivoted algorithm, with sums in another
#: order (XLA's against torch's), so d agrees to a few ulps of the dtype.
D_RTOL = {"float64": 1e-12, "float32": 1e-5}


def _saddle(H, A):
    n, me = H.shape[0], A.shape[0]
    K = np.zeros((n + me, n + me))
    K[:n, :n] = H
    K[:n, n:] = A.T
    K[n:, :n] = A
    return K


def _random_sym(n, rng):
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2 + n * np.eye(n)


def _case(name):
    """(lhs, n, me, prev_delta) of one case."""
    if name == "corrects-inertia":  # test_ldlt.py:62-86
        return _saddle(np.diag([1.0, -2.0, 1.0]), np.array([[1.0, 1.0, 1.0]])), 3, 1, 0.0
    if name == "corrects-inertia-warm":  # the same from the previous δ
        return _saddle(np.diag([1.0, -2.0, 1.0]), np.array([[1.0, 1.0, 1.0]])), 3, 1, 0.3
    if name == "identity-passthrough":  # test_ldlt.py:89-95
        return _random_sym(6, np.random.default_rng(3)), 6, 0, 0.0
    rng = np.random.default_rng(7)  # test_ldlt.py:43-59, as a KKT system
    return _saddle(_random_sym(20, rng), rng.standard_normal((8, 20))), 20, 8, 0.0


CASES = ["corrects-inertia", "corrects-inertia-warm", "identity-passthrough", "saddle"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_regularized_ldlt_matches_jax(name, dtype):
    lhs, n, me, prev = _case(name)
    jfac = jreg.regularized_ldlt(
        jnp.asarray(lhs, dtype), n, me, jnp.asarray(prev, dtype), 1e-10
    )
    tdtype = getattr(torch, dtype)
    tfac = treg.regularized_ldlt(torch.as_tensor(lhs, dtype=tdtype), n, me,
                                 torch.tensor(prev, dtype=tdtype), 1e-10)
    assert tfac.d.dtype == tdtype and tfac.delta.dtype == tdtype
    assert tfac.ok == bool(jfac.ok)
    assert float(tfac.delta) == float(jfac.delta)
    assert float(tfac.gamma) == float(jfac.gamma)
    jd = np.asarray(jfac.d)
    np.testing.assert_allclose(tfac.d.numpy(), jd, rtol=0,
                               atol=D_RTOL[dtype] * np.abs(jd).max())
    eps = float(torch.finfo(tdtype).eps)
    assert [int(v) for v in inertia(tfac.d, eps)] == [n, me, 0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_regularized_solve_solves_the_regularized_system(dtype):
    """test_ldlt.py:80-86 in both dtypes: the regularized factor solves
    K + diag(δ…, −γ…) to the dtype's accuracy."""
    lhs, n, me, _prev = _case("corrects-inertia")
    tdtype = getattr(torch, dtype)
    fac = treg.regularized_ldlt(torch.as_tensor(lhs, dtype=tdtype), n, me,
                                torch.tensor(0.0, dtype=tdtype), 1e-10)
    assert fac.ok and float(fac.delta) > 0.0
    x = treg.regularized_solve(fac, torch.ones(n + me, dtype=tdtype))
    assert x.dtype == tdtype
    reg = np.diag([float(fac.delta)] * n + [-float(fac.gamma)] * me)
    atol = {"float64": 1e-8, "float32": 1e-4}[dtype]
    np.testing.assert_allclose((lhs + reg) @ x.double().numpy(), 1.0, atol=atol)
