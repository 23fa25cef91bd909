"""Equality-only OCPs reach SQP through the banded KKT backend in the port
as in the JAX package (its tests/optimization/test_sqp_banded.py): the
flywheel without input bounds, solved through both packages at N=200,
and one banded SQP step from the same state at N=20."""

import math

import numpy as np
import torch

import jax

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.interop import state_from_numpy
from sleipnir_tpu_torch.models.flywheel import flywheel_unbounded_problem
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend
from sleipnir_tpu_torch.optimization.solver.sqp import SQPState

torch.set_num_threads(1)
TOTAL_TIME = 5.0


def _flywheel_no_bounds(slp, N: int):
    """tests/optimization/test_sqp_banded.py:18-38, through `slp` (the
    port's own is `models/flywheel.flywheel_unbounded_problem`)."""
    dt = TOTAL_TIME / N
    A = math.exp(-dt)
    B = 1.0 - math.exp(-dt)

    def discrete(x, u):
        return A * x + B * u

    ocp = slp.OCP(
        1, 1, dt, N, discrete, slp.DynamicsType.DISCRETE, slp.TimestepMethod.FIXED,
        slp.TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(0.0)
    err = 10.0 - ocp.X()
    ocp.minimize((err**2).sum())
    return ocp


def test_sqp_uses_banded_backend_and_matches_jax():
    N = 200
    jp, tp = _flywheel_no_bounds(jslp, N), flywheel_unbounded_problem(N, TOTAL_TIME)[0]
    assert jp.solve() == jslp.ExitStatus.SUCCESS
    assert tp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)

    [cached] = [v for k, v in tp._solver_cache.items() if k[0] == "sqp"]
    backend = cached[-1]
    assert isinstance(backend, BandedBackend), type(backend)
    assert backend.K == N + 1

    Xv, Uv = tp.X().value(), tp.U().value()
    np.testing.assert_allclose(Xv, jp.X().value(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Uv, jp.U().value(), rtol=0, atol=1e-8)
    # The JAX package's checks of the solution.
    assert abs(Xv[0, 0]) < 1e-9
    assert Xv[0, N] > 9.9
    A = math.exp(-TOTAL_TIME / N)
    np.testing.assert_allclose(Xv[0, 1:], A * Xv[0, :-1] + (1.0 - A) * Uv[0, :N], atol=1e-7)


def _to_numpy(value):
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _assert_states_close(port, ref, rtol, atol=0.0, path="state"):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in port:
                _assert_states_close(port[k], v, rtol, atol, f"{path}.{k}")
        return
    a, b = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.size:
        err = np.abs(a - b).max()
        assert err <= rtol * np.abs(b).max() + atol, (path, err, np.abs(b).max())


def test_banded_sqp_step_matches_jax():
    """Every field of the next state to 1e-9 relative, as the banded IPM
    step is held (tests/test_torch_ipm.py): the two packages factor the
    same staged systems in another order (LAPACK block LUs against the
    port's plain twin), which moves the solution near 1e-10 relative.
    The dynamics are linear, so after the first step cₑ is rounding noise
    (about 1e-15 against x near 45) and is held to 1e-12 absolute."""
    N = 20
    jp, tp = _flywheel_no_bounds(jslp, N), flywheel_unbounded_problem(N, TOTAL_TIME)[0]
    jp.solve(max_iterations=0)
    tp.solve(max_iterations=0, device="cpu")
    _assert_states_close(_to_numpy(tp._last_state), _to_numpy(jp._last_state), 1e-12)
    [jcached] = [v for k, v in jp._solver_cache.items() if k[0] == "sqp"]
    [tcached] = [v for k, v in tp._solver_cache.items() if k[0] == "sqp"]
    assert isinstance(tcached[-1], BandedBackend)
    jstep, tstep = jax.jit(jcached[1]), tcached[1]
    jstate = jp._last_state
    for _ in range(3):
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(state_from_numpy(SQPState, start, "cpu"))
        assert port.status == int(jstate.status)
        assert port.iterations == int(jstate.iterations)
        _assert_states_close(_to_numpy(port), _to_numpy(jstate), 1e-9, atol=1e-12)
