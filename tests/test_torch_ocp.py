"""The port's OCP layer against the JAX package's on the transcriptions
and dynamics forms beyond fixed-step direct transcription (the problems
of tests/optimization/test_ocp.py and test_model_problems.py): direct
collocation, single shooting, discrete dynamics, dynamics that only run
on the DSL and `for_each_step` in every timestep method. Each pair
solves from the same start: the same exit status and iterations, X and U
to 1e-8. The differential-drive and double-integrator models are in
tests/test_torch_models.py."""

import math

import numpy as np
import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models import differential_drive as jax_dd
from sleipnir_tpu_torch.models import differential_drive
from sleipnir_tpu_torch.optimization.problem import _FnBlock
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend

torch.set_num_threads(1)


def _backend(problem):
    [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    return cached[-1]


def _assert_same_solve(jp, tp, jX, tX, jU, tU):
    jstatus = jp.solve()
    tstatus = tp.solve(device="cpu")
    assert int(tstatus) == int(jstatus) == 0
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    np.testing.assert_allclose(tX.value(), jX.value(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tU.value(), jU.value(), rtol=0, atol=1e-8)


def _tracking_ocp(slp, N, dynamics, dynamics_type, transcription):
    """tests/optimization/test_ocp.py's flywheel OCPs: track 10 with
    |u| ≤ 12 (dt = 0.1)."""
    ocp = slp.OCP(1, 1, 0.1, N, dynamics, dynamics_type, slp.TimestepMethod.FIXED, transcription)
    if transcription != slp.TranscriptionMethod.SINGLE_SHOOTING:
        ocp.constrain_initial_state(0.0)
    ocp.set_lower_input_bound(-12)
    ocp.set_upper_input_bound(12)
    ocp.minimize(((10.0 - ocp.X()) ** 2).sum())
    return ocp


def _discrete(x, u):
    return math.exp(-0.1) * x + (1.0 - math.exp(-0.1)) * u


@pytest.mark.parametrize(
    "case,N",
    [("DIRECT_COLLOCATION", 30), ("SINGLE_SHOOTING", 10), ("DISCRETE", 50)],
)
def test_flywheel_transcriptions_match_jax(case, N):
    """Collocation (N=30) on the band, single shooting (N=10) on the dense
    path with no warning, discrete dynamics (N=50) on the band."""
    discrete = case == "DISCRETE"
    transcription = "DIRECT_TRANSCRIPTION" if discrete else case
    ocps = [
        _tracking_ocp(
            slp, N, _discrete if discrete else (lambda x, u: -x + u),
            slp.DynamicsType.DISCRETE if discrete else slp.DynamicsType.EXPLICIT_ODE,
            getattr(slp.TranscriptionMethod, transcription),
        )
        for slp in (jslp, tslp)
    ]
    jp, tp = ocps
    _assert_same_solve(jp, tp, jp.X(), tp.X(), jp.U(), tp.U())
    shooting = case == "SINGLE_SHOOTING"
    assert isinstance(_backend(tp), DenseBackend if shooting else BandedBackend)
    if shooting:
        # x(1 s) at u = 12 throughout (the JAX package's test_ocp.py:172-175)
        assert tp.X().value(0, N) == pytest.approx(12.0 * (1.0 - math.exp(-1.0)), abs=0.2)
    else:
        assert tp.X().value(0, 0) == pytest.approx(0.0, abs=1e-8)


def _dsl_drive(slp, dynamics, N=10, total_time=4.0):
    """The differential drive of differential_drive_problem with dynamics
    that only run on the DSL (the reference's symbolic expansion)."""
    ocp = slp.OCP(5, 2, total_time / N, N, dynamics, slp.DynamicsType.EXPLICIT_ODE,
                  slp.TimestepMethod.FIXED, slp.TranscriptionMethod.DIRECT_TRANSCRIPTION)
    ocp.constrain_initial_state(np.zeros((5, 1)))
    ocp.constrain_final_state(np.array([[1.0], [1.0], [0.0], [0.0], [0.0]]))
    ocp.subject_to(ocp.U() >= -12.0)
    ocp.subject_to(ocp.U() <= 12.0)
    ocp.minimize((ocp.U() ** 2).sum())
    return ocp


def test_dsl_only_dynamics_match_jax():
    """`dynamics_dsl` does not run on tensors, so the OCP takes the
    symbolic path in both packages. Its rows pass through a matrix
    product, which the stage analysis cannot place, so both warn and
    solve on the dense backend."""
    jp = _dsl_drive(jslp, jax_dd.dynamics_dsl)
    tp = _dsl_drive(tslp, differential_drive.dynamics_dsl)
    assert not any(isinstance(b, _FnBlock) for b in tp._equality)
    with pytest.warns(UserWarning, match="does not fit the block-tridiagonal"):
        jstatus = jp.solve()
    with pytest.warns(UserWarning, match="does not fit the block-tridiagonal"):
        tstatus = tp.solve(device="cpu")
    assert int(tstatus) == int(jstatus) == 0
    assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    np.testing.assert_allclose(tp.X().value(), jp.X().value(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tp.U().value(), jp.U().value(), rtol=0, atol=1e-8)
    assert isinstance(_backend(tp), DenseBackend)


@pytest.mark.parametrize("method", ["FIXED", "VARIABLE", "VARIABLE_SINGLE"])
def test_for_each_step_four_arguments_matches_jax(method):
    """callback(t, x, u, dt) sees the same times, timesteps and shapes in
    both packages, in every timestep method."""
    seen = {}
    for name, slp, f in (("jax", jslp, lambda x, u: -x + u), ("port", tslp, lambda x, u: -x + u)):
        ocp = slp.OCP(1, 1, 0.15 if method == "VARIABLE_SINGLE" else 0.1, 5, f,
                      slp.DynamicsType.EXPLICIT_ODE, getattr(slp.TimestepMethod, method))
        if method == "VARIABLE":
            ocp.dt().set_value(np.linspace(0.1, 0.2, 6)[None, :])
        rows = []
        ocp.for_each_step(lambda t, x, u, dt: rows.append(
            (float(np.asarray(t.value())), x.shape, u.shape, float(np.asarray(dt.value())))
        ))
        seen[name] = rows
    assert len(seen["port"]) == 6
    for (tt, txs, tus, tdt), (jt, jxs, jus, jdt) in zip(seen["port"], seen["jax"]):
        assert (txs, tus) == (jxs, jus) == ((1, 1), (1, 1))
        assert tt == pytest.approx(jt, abs=1e-15) and tdt == pytest.approx(jdt, abs=1e-15)


@pytest.mark.parametrize("dynamics", ["EXPLICIT_ODE", "DISCRETE"])
@pytest.mark.parametrize("transcription", ["DIRECT_TRANSCRIPTION", "DIRECT_COLLOCATION",
                                           "SINGLE_SHOOTING"])
@pytest.mark.parametrize("timestep", ["FIXED", "VARIABLE", "VARIABLE_SINGLE"])
def test_every_ocp_combination_solves(timestep, transcription, dynamics):
    """Every timestep method × transcription × dynamics type the JAX package
    takes builds and solves (N=6, |u| ≤ 1, dt in [0.01, 1] when it is a
    variable): per-step dt widens the stage to 3, a shared dt is one border
    column, single shooting is dense; collocation of discrete dynamics is
    refused, as the JAX package refuses it."""
    def build():
        ocp = tslp.OCP(1, 1, 0.1, 6, lambda x, u: -x + u, getattr(tslp.DynamicsType, dynamics),
                       getattr(tslp.TimestepMethod, timestep),
                       getattr(tslp.TranscriptionMethod, transcription))
        ocp.set_lower_input_bound(-1)
        ocp.set_upper_input_bound(1)
        if timestep != "FIXED":
            ocp.set_min_timestep(0.01)
            ocp.set_max_timestep(1.0)
        ocp.minimize(((1.0 - ocp.X()) ** 2).sum())
        return ocp

    if transcription == "DIRECT_COLLOCATION" and dynamics == "DISCRETE":
        with pytest.raises(ValueError, match="explicit ODE"):
            build()
        return
    ocp = build()
    structure = ocp._stage_structure(ocp._compile())
    if transcription == "SINGLE_SHOOTING":
        assert structure is None
    else:
        assert (structure.stage_width, structure.border.shape[0]) == (
            3 if timestep == "VARIABLE" else 2, 1 if timestep == "VARIABLE_SINGLE" else 0
        )
    assert ocp.solve(device="cpu") == tslp.ExitStatus.SUCCESS
