"""Lanes of the port's batched interior-point solve are independent: the
same guess in every lane gives lane 0's result bit for bit, with as many
host reads per iteration as one lane; a lane with a NaN guess ends
NONFINITE_INITIAL_GUESS and leaves the other lanes as they were without
it. Cart-pole N=24 on the banded backend."""

import numpy as np
import pytest
import torch

from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.parallel import Mesh, solve_ipm_batched

torch.set_num_threads(1)

N = 24


@pytest.fixture(scope="module")
def problem():
    p, _X, _U = cart_pole_problem(N=N, total_time=5.0)
    return p


@pytest.fixture(scope="module")
def guess(problem):
    rng = np.random.default_rng(0)
    n = problem._compile()["n"]
    rng.standard_normal(n)
    return 0.01 * rng.standard_normal(n)


def _run(problem, guesses):
    """(statuses, costs, xs, final, host reads) of one batched solve."""
    backend = problem.prepare_ipm(Options(device="cpu"))[1][-1]
    before = backend.syncs.count
    out = solve_ipm_batched(problem, guesses, Options(device="cpu"))
    return (*out, backend.syncs.count - before)


@pytest.fixture(scope="module")
def single(problem, guess):
    return _run(problem, [guess])


def test_identical_lanes_match_lane_zero_and_one_lane(problem, guess, single):
    statuses, costs, xs, final, reads = _run(problem, [guess] * 3)
    s1, c1, x1, f1, reads1 = single
    assert s1.tolist() == [int(ExitStatus.SUCCESS)]
    for lane in range(1, 3):
        for a in (final.x, final.s, final.y, final.z, final.f, final.mu, final.iterations, final.status):
            assert torch.equal(a[lane], a[0])
    assert final.iterations.tolist() == [int(f1.iterations[0])] * 3
    # Host reads per iteration do not depend on the lane count.
    assert reads / int(final.iterations.max()) == reads1 / int(f1.iterations.max())
    np.testing.assert_allclose(xs[0], x1[0], rtol=0, atol=1e-12)


def test_nan_guess_ends_its_lane_only(problem, guess, single):
    statuses, costs, xs, final, _reads = _run(problem, [np.full_like(guess, np.nan), guess])
    s1, c1, x1, f1, _r1 = single
    assert statuses.tolist() == [int(ExitStatus.NONFINITE_INITIAL_GUESS), int(s1[0])]
    assert int(final.iterations[0]) == 0
    assert int(final.iterations[1]) == int(f1.iterations[0])
    np.testing.assert_allclose(xs[1], x1[0], rtol=0, atol=1e-12)
    assert costs[1] == pytest.approx(c1[0], rel=1e-14)


def test_only_one_device_is_taken(problem, guess):
    """A batch takes one device unless it is given a `Mesh`: anything else
    as the mesh raises, and a mesh its lanes do not split over raises
    before any solve."""
    with pytest.raises(TypeError, match="Mesh"):
        solve_ipm_batched(problem, [guess], Options(device="cpu"), mesh=object())
    with pytest.raises(ValueError, match="do not split evenly"):
        solve_ipm_batched(problem, [guess], Options(device="cpu"), mesh=Mesh.of(["cpu"] * 2))
