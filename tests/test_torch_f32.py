"""The float32 solve (`Options.dtype="float32"`) against the JAX
package's float32 path, on the CPU: the plain twin of K1/K2 against the
JAX package's block-tridiagonal factor, solve and inertia; the 2-deep
float32 regularization ladder, on a synthetic factorization and on the
flywheel's assembled KKT system; one interior-point step from the same
state; and the `Options.dtype` field. The flywheel at N=60 against the
JAX package's record is in tests/test_torch_f32_flywheel.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models.flywheel import flywheel_problem as jax_flywheel
from sleipnir_tpu.ops import block_tridiag as jbt
from sleipnir_tpu.optimization.solver import kkt_backend as jkb
from sleipnir_tpu_torch.interop import ipm_state_from_numpy
from sleipnir_tpu_torch.models.flywheel import flywheel_problem as torch_flywheel
from sleipnir_tpu_torch.ops import block_tridiag as tbt
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.optimization.solver import kkt_backend as tkb
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs

torch.set_num_threads(1)

F32 = torch.float32
EPS_INERTIA = tkb.eps_inertia(F32)


def _to_numpy(value):
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) if b.size else 0.0


def _conditioned(rng, K, w):
    """Symmetric indefinite stages with |λ| in [20, 40], coupled weakly:
    every Schur complement stays far from singular."""
    Q, _ = np.linalg.qr(rng.standard_normal((K, w, w)))
    lam = rng.choice([-1.0, 1.0], (K, w)) * rng.uniform(20.0, 40.0, (K, w))
    D = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    return 0.5 * (D + np.swapaxes(D, 1, 2)), 0.5 * rng.standard_normal((K - 1, w, w))


@pytest.mark.parametrize("K,w", [(1, 3), (7, 3), (61, 4), (40, 13), (9, 37)])
def test_twin_matches_jax_block_tridiag_in_float32(K, w):
    """Inertia exactly; solutions to 1e-4 relative (float32 eps is 1.2e-7
    and these systems are well conditioned: both factor with LAPACK's
    float32 LU, in another order of operations)."""
    rng = np.random.default_rng(K * 100 + w)
    D, E = _conditioned(rng, K, w)
    b = rng.standard_normal((K, w))
    D32, E32, b32 = (a.astype(np.float32) for a in (D, E, b))
    jfac = jbt.block_tridiag_factor(jnp.asarray(D32), jnp.asarray(E32))
    jx = np.asarray(jbt.block_tridiag_solve(jfac, jnp.asarray(b32)))
    assert jx.dtype == np.float32

    Dt, Et, bt = (torch.as_tensor(a)[None] for a in (D32, E32, b32))
    cuda_banded.reset_counters()
    tfac = cuda_banded.banded_factor(Dt, Et)
    tx = cuda_banded.banded_solve(tfac, bt)[0]
    assert cuda_banded.PLAIN_BY_SHAPE[("factor_f32", 1, K, w)] == 1
    assert cuda_banded.PLAIN_BY_SHAPE[("solve_f32", 1, K, w)] == 1
    assert tfac.d.dtype == F32 and tx.dtype == F32
    tin = [int(v[0]) for v in tbt.block_tridiag_inertia(tfac, EPS_INERTIA)]
    jin = [int(v) for v in jbt.block_tridiag_inertia(jfac, EPS_INERTIA)]
    assert tin == jin
    assert _rel(tx.numpy(), jx) <= 1e-4


@pytest.mark.parametrize("threshold", [0.0, 1e-4, 5e-4, 0.5, 1e30])
def test_float32_ladder_is_two_deep_and_falls_back_as_jax(threshold):
    """A synthetic factorization whose inertia turns ideal once δ reaches
    `threshold`, in float32: the rungs are (0, 0) and (δ₀, γ_min) only,
    so 5e-4 and 0.5 take the sequential fallback, which chooses (and
    rounds δ and γ) as the JAX loop does; 1e30 overflows."""
    ideal_pos, ideal_neg = 6, 3
    batches = []

    def jax_factor(delta, gamma):
        return (delta * jnp.ones(2, jnp.float32), jnp.asarray(ideal_pos), jnp.asarray(ideal_neg),
                jnp.where(delta >= threshold, 0, 1), jnp.asarray(False))

    def torch_factor(deltas, gammas):
        assert deltas.dtype == F32 and gammas.dtype == F32
        batches.append(deltas.shape[0])
        ones = torch.ones_like(deltas, dtype=torch.int64)
        return (deltas[:, None] * torch.ones(2, dtype=F32), ideal_pos * ones, ideal_neg * ones,
                torch.where(deltas >= threshold, 0, 1), torch.zeros_like(ones, dtype=torch.bool))

    for prev in (0.0, 3e-3):
        batches.clear()
        j = jkb.regularization_loop(jax_factor, ideal_pos, ideal_neg,
                                    jnp.asarray(prev, jnp.float32), 1e-10, jnp.float32)
        t = tkb.regularization_loop(torch_factor, ideal_pos, ideal_neg,
                                    torch.tensor(prev, dtype=F32), 1e-10, HostSyncs())
        assert batches[0] == 2 and all(b == 1 for b in batches[1:])
        assert t.ok == bool(j.ok)
        if t.ok:
            assert t.delta.dtype == F32
            assert float(t.delta) == float(j.delta)
            assert float(t.gamma) == float(j.gamma)
            np.testing.assert_array_equal(t.fac[0].numpy(), np.asarray(j.fac))


@pytest.fixture(scope="module")
def flywheel_start():
    """Both packages' float32 interior-point solver and initial state at
    the flywheel N=10."""
    jp, _, _ = jax_flywheel(N=10, total_time=5.0)
    jp.solve(jslp.Options(dtype="float32", tolerance=1e-2, max_iterations=0))
    _, jcached = jp.prepare_ipm(jslp.Options(dtype="float32", tolerance=1e-2))
    tp, _, _ = torch_flywheel(N=10, total_time=5.0)
    options = tslp.Options(dtype="float32", tolerance=1e-2, device="cpu")
    tp.solve(options, max_iterations=0)
    tcached = tp._prepare_ipm(tp._compile(), options, torch.device("cpu"))
    return jp, jcached, tp, tcached


def test_float32_ladder_picks_the_jax_rung_on_the_flywheel_system(flywheel_start):
    """The banded backend's ladder on the same assembled float32 KKT
    system (the JAX package's initial state carried across) picks the
    JAX package's δ and γ, with the same inertia."""
    jp, jcached, tp, tcached = flywheel_start
    jst = jp._last_state
    tst = ipm_state_from_numpy(_to_numpy(jst), "cpu", F32)
    jb, tb = jcached[-1], tcached[-1]
    assert tb.dtype == F32 and tst.x.dtype == F32
    for prev in (0.0, 1e-3):
        jfac = jb.factor(jst.derivs, jst.z / jst.s, jnp.asarray(prev, jnp.float32), 1e-10)
        tfac = tb.factor(tst.derivs, tst.z / tst.s, torch.tensor(prev, dtype=F32), 1e-10)
        assert tfac.ok == bool(jfac.ok)
        assert float(tfac.delta) == float(jfac.delta)
        assert float(tfac.gamma) == float(jfac.gamma)
        assert tfac.fac.LU.dtype == F32
        td, jd = tfac.fac.d[0].numpy(), np.asarray(jfac.fac.d)
        for sel in (lambda d: d > EPS_INERTIA, lambda d: d < -EPS_INERTIA):
            assert int(sel(td).sum()) == int(sel(jd).sum())


def test_one_float32_step_matches_jax(flywheel_start):
    """Three float32 steps from the JAX package's states: the same status
    and iteration count, and iterates to 1e-3 relative (float32 KKT
    solves of Σ-scaled systems carry ~1e-5 relative error, and the
    problem functions round differently in the two packages)."""
    jp, jcached, tp, tcached = flywheel_start
    jstep = jax.jit(jcached[1])
    tstep = tcached[1]
    assert _rel(_to_numpy(tp._last_state.x), _to_numpy(jp._last_state.x)) <= 1e-6
    jstate = jp._last_state
    for _ in range(3):
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(ipm_state_from_numpy(start, "cpu", F32))
        assert port.status == int(jstate.status)
        assert port.iterations == int(jstate.iterations)
        for name in ("x", "s", "y", "z", "mu"):
            assert getattr(port, name).dtype == F32
            assert _rel(getattr(port, name).numpy(), np.asarray(getattr(jstate, name))) <= 1e-3, name


def test_options_dtype_field():
    """`Options.dtype`: the JAX package's six fields in its order, `device`
    last, float64 by default; any other value than "float64" or
    "float32" raises."""
    import dataclasses

    jfields = [f.name for f in dataclasses.fields(jslp.Options)]
    tfields = [f.name for f in dataclasses.fields(tslp.Options)]
    assert tfields == jfields + ["device"]
    assert tslp.Options().dtype == "float64" and tslp.Options().torch_dtype == torch.float64
    assert tslp.Options(dtype="float32").torch_dtype == F32
    for bad in ("float16", "bfloat16", "f32", torch.float32):
        with pytest.raises(ValueError, match="dtype"):
            tslp.Options(dtype=bad)
