"""Multistart in the port against the JAX package, on the cases of
tests/optimization/test_multistart.py: Mishra's bird function (the dense
backend) by closures run in sequence and as the lanes of one batched
solve, and the winner of a batch at full tolerance with no re-solve."""

import numpy as np
import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as slp
from sleipnir_tpu.parallel.batch import solve_ipm_batched as jax_solve_ipm_batched
from sleipnir_tpu_torch import ExitStatus, MultistartResult, Options, Problem, multistart
from sleipnir_tpu_torch.parallel import multistart_batched, solve_ipm_batched

torch.set_num_threads(1)

GUESSES = [(-3.0, -8.0), (-3.0, -1.5), (-6.0, -4.0), (-2.0, -6.0)]
CPU = Options(device="cpu")


def _bird(pkg):
    problem = pkg.Problem()
    x = problem.decision_variable()
    y = problem.decision_variable()
    cost = (
        pkg.sin(y) * pkg.exp((1 - pkg.cos(x)) ** 2)
        + pkg.cos(x) * pkg.exp((1 - pkg.sin(y)) ** 2)
        + (x - y) ** 2
    )
    problem.minimize(cost)
    problem.subject_to((x + 5) ** 2 + (y + 5) ** 2 < 25)
    return problem, x, y, cost


def test_callable_form_runs_each_closure():
    """tests/optimization/test_multistart.py:15-49 on the port."""

    def solve(initial_guess):
        problem, x, y, cost = _bird(slp)
        x.set_value(initial_guess[0])
        y.set_value(initial_guess[1])
        status = problem.solve(device="cpu")
        return MultistartResult(status, float(cost.value()), (x.value(), y.value()))

    result = multistart(solve, [(-3.0, -8.0), (-3.0, -1.5)])
    assert result.status == ExitStatus.SUCCESS
    assert result.variables[0] == pytest.approx(-3.1302468, abs=1e-3)
    assert result.variables[1] == pytest.approx(-1.5821422, abs=1e-3)


def test_problem_form_matches_jax_batch():
    """The four guesses as lanes: statuses, costs (1e-8 relative) and x
    (1e-6) as the JAX package's `solve_ipm_batched` gives them; the
    winner is the constrained global minimum."""
    guesses = [np.asarray(g) for g in GUESSES]
    problem, _x, _y, _c = _bird(slp)
    statuses, costs, xs, _final = solve_ipm_batched(problem, guesses, CPU)
    jp, _jx, _jy, _jc = _bird(jslp)
    j_statuses, j_costs, j_xs, _jf = jax_solve_ipm_batched(jp, guesses)
    assert statuses.tolist() == np.asarray(j_statuses).tolist()
    np.testing.assert_allclose(costs, np.asarray(j_costs), rtol=1e-8, atol=0)
    np.testing.assert_allclose(xs, np.asarray(j_xs), rtol=0, atol=1e-6)

    result = multistart(problem, guesses, CPU)
    assert result.status == ExitStatus.SUCCESS
    assert result.variables[0] == pytest.approx(-3.1302468, abs=1e-3)
    assert result.variables[1] == pytest.approx(-1.5821422, abs=1e-3)
    assert result.cost == pytest.approx(costs.min(), rel=1e-15)


def test_lanes_match_serial_solves():
    """tests/optimization/test_multistart.py:82-102: each lane's status as
    the port's serial solve from its guess, x within 1e-6."""
    guesses = [np.asarray(g) for g in GUESSES[:2]]
    problem, _x, _y, _c = _bird(slp)
    statuses, _costs, xs, _final = solve_ipm_batched(problem, guesses, CPU)
    assert statuses.shape == (2,) and xs.shape[0] == 2
    for guess, status, xv in zip(guesses, statuses, xs):
        serial, sx, sy, _sc = _bird(slp)
        sx.set_value(guess[0])
        sy.set_value(guess[1])
        serial_status = serial.solve(device="cpu")
        assert int(status) == int(serial_status)
        if int(status) == int(ExitStatus.SUCCESS):
            np.testing.assert_allclose(xv, [sx.value(), sy.value()], rtol=0, atol=1e-6)


def test_batch_winner_is_at_full_tolerance_without_a_polish():
    """tests/optimization/test_multistart.py:105-133: the JAX package
    re-solves the winner because a TPU batch runs on f64 emulation; in the
    port every lane is native f64, and the batch's winner is already at
    [2, −1] to 1e-7."""
    problem = Problem()
    x = problem.decision_variable()
    y = problem.decision_variable()
    problem.minimize((x - 2.0) ** 2 + (y + 1.0) ** 2)
    problem.subject_to(x <= 5.0)
    res = multistart_batched(problem, [np.array([0.0, 0.0]), np.array([4.0, 4.0])], CPU)
    assert res.status == ExitStatus.SUCCESS
    np.testing.assert_allclose(np.asarray(res.variables), [2.0, -1.0], rtol=0, atol=1e-7)
