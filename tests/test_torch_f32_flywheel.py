"""The port's float32 flywheel at N=60 (the JAX package's
tests/optimization/test_dtype_axis.py case) held to the JAX package's
float32 record on the CPU (`f32_reference.py flywheel --N 60`): SUCCESS
after 1,404 iterations. The JAX solve is not repeated here; the JAX
package's own test runs the port in tests/test_torch_reference_dtype.py."""

import torch

import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.models.flywheel import flywheel_problem

torch.set_num_threads(1)

#: The JAX package's flywheel at N=60 in float32 to 1e-2 on the banded
#: interior-point path (CPU, seed-free): SUCCESS after 1,404 iterations.
JAX_N60_ITERATIONS = 1404
#: The port takes another count there (1,211): the two packages' problem
#: functions round differently (the JAX package's compute with float64
#: constants and cast, the port's in float32), and the iterates drift
#: apart slowly while the solve crawls at δ = 1e2-1e3 until one meets the
#: 1e-2 tolerance first. The band is ±40%.
N60_BAND = (0.6 * JAX_N60_ITERATIONS, 1.4 * JAX_N60_ITERATIONS)


def test_flywheel_n60_float32_reaches_the_jax_status():
    """The port's float32 flywheel at N=60 to 1e-2 (the JAX package's
    test_dtype_axis.py case): SUCCESS, as the JAX package, with float32
    iterates throughout, x_N within the JAX test's bound and the
    iterations in the band around the JAX package's 1,404."""
    p, X, _U = flywheel_problem(N=60, total_time=5.0)
    status = p.solve(tslp.Options(dtype="float32", tolerance=1e-2, device="cpu"))
    assert status == tslp.ExitStatus.SUCCESS
    assert p._last_state.x.dtype == torch.float32
    assert abs(X.value()[0, 60] - 10.0) <= 5.0
    iterations = p.last_solve_stats.iterations
    print(f"flywheel N=60 float32: {iterations} iterations (JAX package: {JAX_N60_ITERATIONS})")
    assert N60_BAND[0] <= iterations <= N60_BAND[1]
