"""The flywheel at N=5000 under SLEIPNIR_TPU_BCR in both packages: block
cyclic reduction reaches SUCCESS in 24 iterations (18 by default) and
misses the flywheel oracle's steady-state voltage at three steps, in the
JAX package as in the port. BCR eliminates without pivoting: on an
interior-point-like chain its unrefined residual is about 1e8 against
the pivoted chain's 1e-6 (chip_smoke.py phase 17), and its iterations
grow with the horizon past the default's (N=1000: 21 against 16). The
port holds the JAX package's status, iterations within ±2, the same
missed steps and the solution within 1e-6."""

import numpy as np
import torch

from sleipnir_tpu.models.flywheel import flywheel_problem as jax_flywheel
from sleipnir_tpu_torch.models.flywheel import flywheel_problem, oracle_failures
from tests.test_torch_factor_variants import VARIABLES, jax_solve, port_solve

torch.set_num_threads(1)

N = 5000
TOTAL_TIME = 5.0


def test_flywheel_bcr_at_n5000_misses_the_oracle_as_jax_does(monkeypatch):
    for name in VARIABLES.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SLEIPNIR_TPU_BCR", "1")
    jstatus, jiterations, jx = jax_solve(*jax_flywheel(N=N, total_time=TOTAL_TIME))
    status, iterations, _syncs, x, backend, calls = port_solve(
        *flywheel_problem(N=N, total_time=TOTAL_TIME))
    assert backend.use_bcr and {K for _kind, _B, K, _w in calls} == {2}
    assert int(status) == jstatus == 0
    assert abs(iterations - jiterations) <= 2 and jiterations == 24
    assert np.abs(x - jx).max() < 1e-6
    misses = [oracle_failures(v[: N + 1], v[N + 1:], TOTAL_TIME) for v in (x, jx)]
    steps = [[f.split(" = ")[0] for f in m] for m in misses]
    assert steps[0] == steps[1] == ["u_1792", "u_1793", "u_1794"]
    assert all("at steady state" in f for f in misses[0])
