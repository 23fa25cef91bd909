"""The port's interior-point step and full solve against the JAX package:
one step from the same state on cart-pole N=10, then the whole cart-pole
swing-up at N=20 through both packages."""

import math

import numpy as np
import pytest
import torch

import jax

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole
from sleipnir_tpu_torch.interop import ipm_state_from_numpy
from sleipnir_tpu_torch.models.cart_pole import (
    cart_pole_problem as torch_cart_pole,
    dynamics_numpy,
    rk4_numpy,
)

torch.set_num_threads(1)

#: The smallest horizon in 10..60 at which both packages reach SUCCESS
#: (N=10 ends LOCALLY_INFEASIBLE in the JAX package); the pair solves in
#: well under 90 s on one CPU core.
SOLVE_N = 20


def _to_numpy(value):
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _assert_states_close(port, ref, rtol, path="state"):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in port:
                _assert_states_close(port[k], v, rtol, f"{path}.{k}")
        return
    a, b = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.size:
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= rtol, (path, err)


def test_one_step_matches_jax():
    jp, _, _ = jax_cart_pole(N=10)
    jp.solve(max_iterations=0)
    _, jcached = jp.prepare_ipm(jslp.Options())
    jstep = jax.jit(jcached[1])

    tp, _, _ = torch_cart_pole(N=10)
    tp.solve(max_iterations=0, device="cpu")
    _init, tstep, *_rest = tp._prepare_ipm(
        tp._compile(), tslp.Options(device="cpu"), torch.device("cpu")
    )
    # Both packages start from the same point.
    _assert_states_close(_to_numpy(tp._last_state), _to_numpy(jp._last_state), 1e-12)

    jstate = jp._last_state
    for _ in range(3):
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(ipm_state_from_numpy(start, "cpu"))
        assert port.status == int(jstate.status)
        assert port.iterations == int(jstate.iterations)
        _assert_states_close(_to_numpy(port), _to_numpy(jstate), 1e-9)


def test_full_solve_matches_jax():
    N, total_time = SOLVE_N, 5.0
    jp, jX, _ = jax_cart_pole(N=N, total_time=total_time)
    tp, tX, tU = torch_cart_pole(N=N, total_time=total_time)
    assert tp.cost_function_type() == jp.cost_function_type()
    assert tp.equality_constraint_type() == jp.equality_constraint_type()
    assert tp.inequality_constraint_type() == jp.inequality_constraint_type()

    assert jp.solve() == jslp.ExitStatus.SUCCESS
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    j_iters = int(jp._last_state.iterations)
    t_iters = tp.last_solve_stats.iterations
    print(f"cart-pole N={N}: JAX {j_iters} iterations, port {t_iters}")
    assert abs(t_iters - j_iters) <= 0.1 * j_iters

    Xv, Uv = tX.value(), tU.value()
    np.testing.assert_allclose(Xv, jX.value(), atol=1e-6)
    np.testing.assert_allclose(Xv[:, 0], [0, 0, 0, 0], atol=1e-8)
    np.testing.assert_allclose(Xv[:, N], [1.0, math.pi, 0.0, 0.0], atol=1e-8)
    for k in range(N):
        expected = rk4_numpy(dynamics_numpy, Xv[:, k : k + 1], Uv[:, k : k + 1], total_time / N)
        np.testing.assert_allclose(Xv[:, k + 1], expected.ravel(), atol=1e-8)


def test_missing_cuda_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present, so the device resolves")
    p, _, _ = torch_cart_pole(N=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        p.solve()


def test_paths_outside_the_slice_raise():
    """Diagnostics printing (queue 1 item 6) is not ported; problems
    without OCP structure solve densely, and the OCP options of item 11
    (variable timesteps, collocation) are ported: they build banded stage
    structures, per-step dt in the stage and a shared dt as a border."""
    p = tslp.Problem()
    x = p.decision_variable()
    p.minimize(x**4 + x)
    p.subject_to(x >= -1.0)
    with pytest.raises(NotImplementedError, match="item 6:"):
        p.solve(device="cpu", diagnostics=True)
    assert p.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    for kwargs, width, border in (
        ({"timestep_method": tslp.TimestepMethod.VARIABLE}, 4, 0),
        ({"timestep_method": tslp.TimestepMethod.VARIABLE_SINGLE}, 3, 1),
        ({"transcription_method": tslp.TranscriptionMethod.DIRECT_COLLOCATION}, 3, 0),
    ):
        ocp = tslp.OCP(2, 1, 0.1, 5, lambda x, u: x, **kwargs)
        ocp.minimize((ocp.U() ** 2).sum())
        structure = ocp._stage_structure(ocp._compile())
        assert (structure.stage_width, structure.border.shape[0]) == (width, border)
