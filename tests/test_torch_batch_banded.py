"""The port's batched interior-point solve on the banded backend against
the JAX package's `solve_ipm_batched`: cart-pole N=24 from three guesses
(built as `__graft_entry__.py:83-86` builds them), solved as the lanes of
one solve. Also: a lane that finished does not move while the others
run, and every ladder of the batch is one factor call over all lanes and
candidates, every step solve one call over all lanes."""

import numpy as np
import pytest
import torch

from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole_problem
from sleipnir_tpu.parallel.batch import solve_ipm_batched as jax_solve_ipm_batched
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.kkt_backend import LADDER
from sleipnir_tpu_torch.parallel import batch

torch.set_num_threads(1)

N, L = 24, 3


def guesses(n, count):
    rng = np.random.default_rng(0)
    return [0.01 * k * rng.standard_normal(n) for k in range(count)]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


@pytest.fixture(scope="module")
def port_run():
    """The batch, with every state the runner produced and the shapes the
    factor and solve wrappers were called at."""
    problem, _X, _U = cart_pole_problem(N=N, total_time=5.0)
    history = []
    real = batch.make_lane_interior_point

    def recording(*args, **kwargs):
        init, step = real(*args, **kwargs)

        def step_and_record(state, run):
            state = step(state, run)
            history.append(state)
            return state

        return init, step_and_record

    batch.make_lane_interior_point = recording
    cuda_banded.reset_counters()
    try:
        out = batch.solve_ipm_batched(
            problem, guesses(problem._compile()["n"], L), Options(device="cpu")
        )
    finally:
        batch.make_lane_interior_point = real
    return out, history, dict(cuda_banded.PLAIN_BY_SHAPE)


def test_cart_pole_batch_matches_jax(port_run):
    """Statuses equal (all SUCCESS), costs to 1e-8 relative, x to 1e-6,
    and per-lane iterations within 3 of the JAX package's (it gives
    [42, 36, 36]; the port [42, 36, 36] when this test was written)."""
    (statuses, costs, xs, final), _history, _shapes = port_run
    jp, _jX, _jU = jax_cart_pole_problem(N=N, total_time=5.0)
    j_statuses, j_costs, j_xs, j_final = jax_solve_ipm_batched(jp, guesses(xs.shape[1], L))
    assert statuses.tolist() == np.asarray(j_statuses).tolist() == [0] * L
    np.testing.assert_allclose(costs, np.asarray(j_costs), rtol=1e-8, atol=0)
    np.testing.assert_allclose(xs, np.asarray(j_xs), rtol=0, atol=1e-6)
    iterations = final.iterations.numpy()
    j_iterations = np.asarray(j_final.iterations)
    assert np.all(np.abs(iterations - j_iterations) <= 3), (iterations, j_iterations)


def test_finished_lane_does_not_move(port_run):
    """Once a lane leaves RUNNING, every tensor of its state stays as it
    was while the other lanes iterate."""
    _out, history, _shapes = port_run
    finished_early = 0
    for lane in range(L):
        done = [i for i, st in enumerate(history) if int(st.status[lane]) != status_codes.RUNNING]
        first = done[0]
        frozen = [leaf[lane] for leaf in _leaves(history[first]._replace(params=()))]
        for st in history[first + 1 :]:
            for a, b in zip(frozen, (leaf[lane] for leaf in _leaves(st._replace(params=())))):
                assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan()))
        finished_early += first + 1 < len(history)
    assert finished_early > 0


def test_one_factor_call_per_ladder_over_all_lanes(port_run):
    """K1 runs once per ladder at B = 4·L (never per lane), plus at B = L
    for a sequential fallback; K2 runs at B = L for the step solves."""
    _out, history, shapes = port_run
    K, w = N + 1, 13
    factor_batches = {key[1] for key in shapes if key[0] == "factor"}
    assert factor_batches <= {LADDER * L, L}
    assert shapes["factor", LADDER * L, K, w] == len(history)
    assert {key[1:] for key in shapes if key[0] == "solve"} == {(L, K, w)}
