"""The port's flywheel model against the JAX package's at N=100, in both
forms: the OCP form (discrete linear dynamics on the banded backend,
stage blocks 4 wide) and the plain-Problem form (the dense backend). The
same iterations, the same trajectory, and the numpy oracle of
tests/optimization/test_flywheel_problem.py."""

import numpy as np
import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models.flywheel import flywheel_problem as jax_flywheel
from sleipnir_tpu_torch.models.flywheel import flywheel_problem, oracle_failures

torch.set_num_threads(1)

N = 100
TOTAL_TIME = 5.0


def test_flywheel_matches_jax():
    jp, jX, jU = jax_flywheel(N=N, total_time=TOTAL_TIME)
    tp, tX, tU = flywheel_problem(N=N, total_time=TOTAL_TIME)
    assert tp.cost_function_type() == tslp.ExpressionType.QUADRATIC
    assert tp.equality_constraint_type() == tslp.ExpressionType.LINEAR
    assert tp.inequality_constraint_type() == tslp.ExpressionType.LINEAR
    # Stage blocks are 4 wide in both packages: (x_k, u_k) and two
    # equality slots, since stage 0 holds x_0 = 0 beside its dynamics row.
    structure = tp._stage_structure(tp._compile())
    assert (structure.stage_width, structure.eq_pad) == (2, 2)

    assert jp.solve() == jslp.ExitStatus.SUCCESS
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    np.testing.assert_allclose(tX.value(), jX.value(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tU.value(), jU.value(), rtol=0, atol=1e-8)
    assert oracle_failures(tX.value(), tU.value(), TOTAL_TIME) == []


def test_oracle_catches_a_broken_trajectory():
    tp, tX, tU = flywheel_problem(N=20, total_time=TOTAL_TIME)
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    Xv, Uv = tX.value().copy(), tU.value().copy()
    assert oracle_failures(Xv, Uv, TOTAL_TIME) == []
    Xv[0, 7] += 1e-6
    assert any("dynamics" in f for f in oracle_failures(Xv, Uv, TOTAL_TIME))


def test_plain_problem_form_raises():
    """The plain-Problem form no longer raises: it builds a plain Problem
    (no OCP stage structure) that solves on the dense backend."""
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend

    tp, tX, tU = flywheel_problem(N=10, total_time=TOTAL_TIME, fast=False)
    assert type(tp) is tslp.Problem
    assert (tX.shape, tU.shape) == ((1, 11), (1, 10))
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    [cached] = [v for k, v in tp._solver_cache.items() if k[0] == "ipm"]
    assert isinstance(cached[-1], DenseBackend)


def test_plain_problem_form_matches_jax():
    """tests/optimization/test_flywheel_problem.py:70 (the DSL path) at
    N=100 through both packages: the dense interior-point method, the
    same iterations and trajectory, and the numpy oracle."""
    jp, jX, jU = jax_flywheel(N=N, total_time=TOTAL_TIME, fast=False)
    tp, tX, tU = flywheel_problem(N=N, total_time=TOTAL_TIME, fast=False)
    assert jp.solve() == jslp.ExitStatus.SUCCESS
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    np.testing.assert_allclose(tX.value(), jX.value(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tU.value(), jU.value(), rtol=0, atol=1e-8)
    assert oracle_failures(tX.value(), tU.value(), TOTAL_TIME) == []


def test_off_band_ocp_falls_back_to_the_dense_backend_as_jax_does():
    """A constraint between stages 1 and N does not fit the stage band: the
    OCP warns and solves on the dense backend in both packages, with the
    same iterations and trajectory."""
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend

    def build(slp, n=20):
        dt = TOTAL_TIME / n
        a = np.exp(-dt)
        ocp = slp.OCP(
            1, 1, dt, n, lambda x, u: a * x + (1.0 - a) * u, slp.DynamicsType.DISCRETE,
            slp.TimestepMethod.FIXED, slp.TranscriptionMethod.DIRECT_TRANSCRIPTION,
        )
        ocp.constrain_initial_state(0.0)
        ocp.subject_to(ocp.U() >= -12.0)
        ocp.subject_to(ocp.U() <= 12.0)
        X = ocp.X()
        ocp.subject_to(X[0, n] - X[0, 1] >= -100.0)
        ocp.minimize(((10.0 - X) ** 2).sum())
        return ocp

    jp, tp = build(jslp), build(tslp)
    assert jp.solve() == jslp.ExitStatus.SUCCESS
    with pytest.warns(UserWarning, match="does not fit the block-tridiagonal"):
        assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    [cached] = [v for k, v in tp._solver_cache.items() if k[0] == "ipm"]
    assert isinstance(cached[-1], DenseBackend)
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    np.testing.assert_allclose(tp.X().value(), jp.X().value(), rtol=0, atol=1e-8)
