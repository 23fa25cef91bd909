"""A batch whose lanes all need feasibility restoration: cart-pole N=12
(total time 5 s) from the guesses `__graft_entry__.py:83-86` builds. The
JAX package's batched runner ends every lane with code 101
(FEASIBILITY_RESTORATION_REQUESTED) and runs no restoration
(`sleipnir_tpu/parallel/batch.py:52-58`); the port's lanes must end the
same way."""

import numpy as np
import torch

from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole_problem
from sleipnir_tpu.parallel.batch import solve_ipm_batched as jax_solve_ipm_batched
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.parallel import solve_ipm_batched

torch.set_num_threads(1)


def test_every_lane_requests_restoration_as_in_jax():
    """Statuses equal, all 101. The iterations at which the line search
    gives up are not held: the paths to a failure drift apart (JAX
    [99, 103, 83], the port [67, 110, 83] when this test was written)."""
    N, L = 12, 3
    problem, _X, _U = cart_pole_problem(N=N, total_time=5.0)
    n = problem._compile()["n"]
    rng = np.random.default_rng(0)
    guesses = [0.01 * k * rng.standard_normal(n) for k in range(L)]
    statuses, costs, xs, final = solve_ipm_batched(problem, guesses, Options(device="cpu"))
    jp, _jX, _jU = jax_cart_pole_problem(N=N, total_time=5.0)
    j_statuses, _jc, _jx, j_final = jax_solve_ipm_batched(jp, guesses)
    expected = [status_codes.FEASIBILITY_RESTORATION_REQUESTED] * L
    assert statuses.tolist() == np.asarray(j_statuses).tolist() == expected
    assert np.all(np.isfinite(xs)) and np.all(np.isfinite(costs))
    assert np.all(final.iterations.numpy() > 0)
    print("iterations: port", final.iterations.tolist(), "JAX", np.asarray(j_final.iterations).tolist())
