"""The port's banded KKT backend against the JAX package's at cart-pole
N=10's starting point: derivative blocks, the regularization the ladder
chooses, the inertia and the refined solve; and the ladder's sequential
fallback against the JAX loop."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole
from sleipnir_tpu.optimization.solver import kkt_backend as jkb
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem as torch_cart_pole
from sleipnir_tpu_torch.optimization.solver import kkt_backend as tkb
from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs

torch.set_num_threads(1)

N = 10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size == 0:  # the border fields of a problem without a border
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def start():
    """Both packages' initial IPM state, backend and bound functions."""
    jp, _, _ = jax_cart_pole(N=N)
    jp.solve(max_iterations=0)
    _, jcached = jp.prepare_ipm(jslp.Options())
    tp, _, _ = torch_cart_pole(N=N)
    tp.solve(max_iterations=0, device="cpu")
    comp = tp._compile()
    tcached = tp._prepare_ipm(comp, tslp.Options(device="cpu"), torch.device("cpu"))
    jst, tst = jp._last_state, tp._last_state
    return {
        "jst": jst,
        "tst": tst,
        "jbackend": jcached[-1],
        "tbackend": tcached[-1],
    }


def test_banded_derivs_match(start):
    jd, td = start["jst"].derivs, start["tst"].derivs
    for name in td._fields:
        assert _rel(getattr(td, name).numpy(), getattr(jd, name)) <= 1e-12, name


def _rhs(st, backend):
    """The IPM step's Newton right-hand side (interior_point.py:351-361)."""
    sigma = st.z / st.s
    rhs_top = -st.g + backend.AeT(st.derivs, st.y) + backend.AiT(
        st.derivs, -sigma * st.c_i + st.mu / st.s + st.z
    )
    return sigma, rhs_top, -st.c_e


def test_factor_and_refined_solve_match(start):
    jst, tst = start["jst"], start["tst"]
    jb, tb = start["jbackend"], start["tbackend"]
    jsig, jtop, jbot = _rhs(jst, jb)
    tsig, ttop, tbot = _rhs(tst, tb)

    jfac = jb.factor(jst.derivs, jsig, jnp.asarray(0.0), 1e-10)
    tfac = tb.factor(tst.derivs, tsig, torch.tensor(0.0, dtype=torch.float64), 1e-10)
    assert bool(jfac.ok) and tfac.ok
    assert float(tfac.delta) == float(jfac.delta)
    assert float(tfac.gamma) == float(jfac.gamma)

    jd = np.asarray(jfac.fac.d)
    td = tfac.fac.d[0].numpy()
    for sel in (lambda d: d > EPS_INERTIA, lambda d: d < -EPS_INERTIA):
        assert int(sel(td).sum()) == int(sel(jd).sum())
    np.testing.assert_allclose(tfac.s.numpy(), np.asarray(jfac.s), rtol=1e-12)

    jpx, jpy = jb.solve_refined(jst.derivs, jsig, jfac, jtop, jbot)
    tpx, tpy = tb.solve_refined(tst.derivs, tsig, tfac, ttop, tbot)
    assert _rel(tpx.numpy(), jpx) <= 1e-10
    assert _rel(tpy.numpy(), jpy) <= 1e-10


def test_matvecs_match(start):
    rng = np.random.default_rng(8)
    jst, tst = start["jst"], start["tst"]
    jb, tb = start["jbackend"], start["tbackend"]
    u = rng.standard_normal(tb.n)
    ve = rng.standard_normal(tb.me)
    vi = rng.standard_normal(tb.mi)
    pairs = [
        (tb.AeT(tst.derivs, torch.tensor(ve)), jb.AeT(jst.derivs, jnp.asarray(ve))),
        (tb.Ae(tst.derivs, torch.tensor(u)), jb.Ae(jst.derivs, jnp.asarray(u))),
        (tb.AiT(tst.derivs, torch.tensor(vi)), jb.AiT(jst.derivs, jnp.asarray(vi))),
        (tb.Ai(tst.derivs, torch.tensor(u)), jb.Ai(jst.derivs, jnp.asarray(u))),
    ]
    for got, want in pairs:
        assert _rel(got.numpy(), want) <= 1e-13


@pytest.mark.parametrize("threshold", [0.0, 5e-4, 0.5, 1e30])
def test_regularization_ladder_and_fallback_match(threshold):
    """A synthetic factorization whose inertia turns ideal once δ reaches
    `threshold`: a ladder rung (0, 5e-4), the sequential fallback (0.5),
    and overflow (1e30) choose as the JAX loop does."""
    ideal_pos, ideal_neg = 6, 3

    def jax_factor(delta, gamma):
        return (
            delta * jnp.ones(2),
            jnp.asarray(ideal_pos),
            jnp.asarray(ideal_neg),
            jnp.where(delta >= threshold, 0, 1),
            jnp.asarray(False),
        )

    def torch_factor(deltas, gammas):
        ones = torch.ones_like(deltas, dtype=torch.int64)
        return (
            deltas[:, None] * torch.ones(2, dtype=torch.float64),
            ideal_pos * ones,
            ideal_neg * ones,
            torch.where(deltas >= threshold, 0, 1),
            torch.zeros_like(ones, dtype=torch.bool),
        )

    for prev in (0.0, 3e-3):
        j = jkb.regularization_loop(jax_factor, ideal_pos, ideal_neg, jnp.asarray(prev), 1e-10, jnp.float64)
        t = tkb.regularization_loop(
            torch_factor, ideal_pos, ideal_neg, torch.tensor(prev, dtype=torch.float64), 1e-10, HostSyncs()
        )
        assert t.ok == bool(j.ok)
        if t.ok:
            assert float(t.delta) == float(j.delta)
            assert float(t.gamma) == float(j.gamma)
            np.testing.assert_array_equal(t.fac[0].numpy(), np.asarray(j.fac))
