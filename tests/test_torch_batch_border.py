"""The batched solve through the banded backend's border (arrowhead): the
minimum-time flywheel, whose shared dt is a border column, from two
guesses as two lanes, held against the port's serial solve from each
guess (`tests/test_torch_border.py` holds that solve against the JAX
package). The border's T⁻¹·col of every lane and candidate is one solve
call at B = 4·L."""

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff import expression as ex
from sleipnir_tpu_torch.models import flywheel
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.optimization.solver.kkt_backend import LADDER
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.parallel import solve_ipm_batched

torch.set_num_threads(1)


def test_min_time_flywheel_lanes_match_serial_solves():
    N = 20
    problem, _X, _U = flywheel.flywheel_min_time_problem(N)
    ids = problem._compile()["all_ids"]
    x0 = ex._registry.get(ids).copy()
    rng = np.random.default_rng(1)
    guesses = [x0, x0 + 0.01 * np.abs(rng.standard_normal(x0.shape))]
    cuda_banded.reset_counters()
    statuses, costs, xs, final = solve_ipm_batched(problem, guesses, Options(device="cpu"))
    shapes = dict(cuda_banded.PLAIN_BY_SHAPE)

    for lane, guess in enumerate(guesses):
        serial, _sX, _sU = flywheel.flywheel_min_time_problem(N)
        serial_ids = serial._compile()["all_ids"]
        ex._registry.set(serial_ids, guess)
        assert int(serial.solve(device="cpu")) == int(statuses[lane]) == 0
        assert serial.last_solve_stats.iterations == int(final.iterations[lane])
        np.testing.assert_allclose(xs[lane], ex._registry.get(serial_ids), rtol=0, atol=1e-9)
        assert abs(costs[lane] - serial.dt().value(0, 0) * N) <= 1e-9

    [(K, w)] = {key[2:] for key in shapes if key[:2] == ("factor", LADDER * 2)}
    assert shapes["solve", LADDER * 2, K, w] > 0
