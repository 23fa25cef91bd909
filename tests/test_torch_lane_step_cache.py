"""The lane step is built once per prepared interior-point bundle and kept
beside it (`parallel/batch.py` `_lane_step`): every later batched call on
that bundle reuses it, whatever its lane count, and whatever drops or
re-keys the bundle builds a new one. `SolveStats.lane_steps_built` counts
the steps a call built. On the CPU the graphed functions run eagerly, so
these cases hold the cache's keys and its answers; the card's replays are
`tests/test_torch_spans.py`'s `cuda` cases. The flywheel at N=40 on the
banded backend, from four guesses.

    python -m pytest tests/test_torch_lane_step_cache.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sleipnir_tpu_torch import Options, multistart
from sleipnir_tpu_torch.models.flywheel import flywheel_mpc_problem, flywheel_problem
from sleipnir_tpu_torch.parallel import Mesh, solve_ipm_batched

torch.set_num_threads(1)

N, LANES = 40, 4
CPU = Options(device="cpu")


def _guesses(problem, count=LANES):
    rng = np.random.default_rng(0)
    n = problem._compile()["n"]
    return [0.01 * k * rng.standard_normal(n) for k in range(count)]


def _built(problem):
    return problem.last_solve_stats.lane_steps_built


def _answers(out):
    """Statuses, iterations, costs and x of a batched solve, in lane order
    (a mesh's groups joined)."""
    statuses, costs, xs, final = out
    finals = (final,) if hasattr(final, "_fields") else final  # an IPMState, or one per group
    iterations = np.concatenate([f.iterations.cpu().numpy() for f in finals])
    return statuses, iterations, costs, xs


def _assert_same(out, expected):
    for got, want in zip(_answers(out), _answers(expected)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fresh():
    """A fresh problem's first call from the four guesses."""
    problem = flywheel_problem(N=N)[0]
    out = solve_ipm_batched(problem, _guesses(problem), CPU)
    assert _built(problem) == 1 and out[0].tolist() == [0] * LANES
    return out


@pytest.mark.parametrize("first_lanes", [LANES, 2], ids=["same lane count", "two lanes first"])
def test_a_second_call_reuses_the_step_and_answers_as_a_fresh_problem(first_lanes, fresh):
    problem = flywheel_problem(N=N)[0]
    guesses = _guesses(problem)
    solve_ipm_batched(problem, guesses[:first_lanes], CPU)
    assert _built(problem) == 1
    out = solve_ipm_batched(problem, guesses, CPU)
    assert _built(problem) == 0
    _assert_same(out, fresh)


def _options(**fields):
    def change(_problem, _monkeypatch):
        return dataclasses.replace(CPU, **fields)

    return change


def _time_axis_mesh(problem, _monkeypatch):
    problem.set_time_axis_mesh(Mesh.of(["cpu"] * 2), "t")
    return CPU


def _factor_form(_problem, monkeypatch):
    monkeypatch.setenv("SLEIPNIR_TPU_BCR", "1")
    return CPU


def _structure(problem, _monkeypatch):
    problem.subject_to(problem.U() <= 11.0)
    return CPU


@pytest.mark.parametrize("change", [
    _options(tolerance=1e-7), _options(max_iterations=60), _options(feasible_ipm=True),
    _time_axis_mesh, _factor_form, _structure,
], ids=["tolerance", "max_iterations", "feasible_ipm", "time-axis mesh", "factor form",
        "structure"])
def test_what_re_keys_the_bundle_builds_a_new_step(change, monkeypatch):
    problem = flywheel_problem(N=N)[0]
    guesses = _guesses(problem, 2)
    solve_ipm_batched(problem, guesses, CPU)
    assert _built(problem) == 1
    (old,) = [v for k, v in problem._solver_cache.items() if k[0] == "lanes"]
    options = change(problem, monkeypatch)
    solve_ipm_batched(problem, _guesses(problem, 2), options)
    assert _built(problem) == 1
    new = [v for k, v in problem._solver_cache.items() if k[0] == "lanes" and v is not old]
    assert len(new) == 1 and new[0][1] is not old[1]
    solve_ipm_batched(problem, _guesses(problem, 2), options)
    assert _built(problem) == 0


def test_a_second_prepare_on_the_device_keeps_the_constants():
    """A mesh's lane groups on one device prepare their bundles from one
    compiled problem, one after another, and a kept step's graphs read its
    device constants where they were captured: preparing again keeps each
    tensor as it is."""
    compiled = flywheel_problem(N=N)[0]._compile()["compiled"]
    compiled.prepare(torch.device("cpu"))
    cache = compiled.compiled._device_cache
    before = dict(cache)
    compiled.prepare(torch.device("cpu"))
    assert before and cache.keys() == before.keys()
    assert all(cache[k] is t for k, t in before.items())


def test_a_mesh_builds_one_step_per_group_on_its_first_call_only(fresh):
    problem = flywheel_problem(N=N)[0]
    mesh = Mesh.of(["cpu", "cpu"], "batch")
    first = solve_ipm_batched(problem, _guesses(problem), CPU, mesh=mesh)
    assert _built(problem) == 2
    steps = [v[1] for k, v in problem._solver_cache.items() if k[0] == "lanes"]
    assert len({id(s) for s in steps}) == 2
    second = solve_ipm_batched(problem, _guesses(problem), CPU, mesh=mesh)
    assert _built(problem) == 0
    _assert_same(second, first)
    # The groups split the lanes of one batch: the same answers, to rounding.
    np.testing.assert_array_equal(_answers(second)[1], _answers(fresh)[1])
    np.testing.assert_allclose(second[2], fresh[2], rtol=0, atol=1e-12)


def test_a_multistart_after_a_parameter_change_returns_what_a_fresh_problem_returns():
    """The lane analogue of `tests/test_torch_graphs.py`'s
    `test_cached_solver_takes_new_parameters_on_the_cpu`: the parameters
    reach the reused lane step as inputs."""
    problem, _X, _U, x0, r = flywheel_mpc_problem(N=30)
    guesses = _guesses(problem, 3)
    before = multistart(problem, guesses, CPU)
    x0.set_value(3.0)
    r.set_value(5.0)
    after = multistart(problem, guesses, CPU)
    assert _built(problem) == 0 and after.cost != before.cost
    fresh, _X2, _U2, x02, r2 = flywheel_mpc_problem(N=30)
    x02.set_value(3.0)
    r2.set_value(5.0)
    expected = multistart(fresh, guesses, CPU)
    assert _built(fresh) == 1
    assert (after.status, after.cost) == (expected.status, expected.cost)
    np.testing.assert_array_equal(after.variables, expected.variables)
