"""The port's flywheel model (discrete linear dynamics on the banded
backend, stage blocks 4 wide) against the JAX package's fast form at N=100:
the same iterations, the same trajectory, and the numpy oracle of
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
    with pytest.raises(NotImplementedError, match="item 10"):
        flywheel_problem(N=10, fast=False)
