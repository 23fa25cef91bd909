"""The port's arrowhead (band + border) KKT backend against the JAX
package's, on the minimum-time problems of
tests/solver/test_border_backend.py: the stage structure of both timestep
methods, the border fields of the derivative blocks, the regularization
the ladder chooses, the bordered refined solve, the dense view, and
banded restoration from an infeasible minimum-time iterate. The full
minimum-time solves are in tests/test_torch_min_time.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu.optimization.solver.util.feasibility_restoration as jfr
import sleipnir_tpu_torch as tslp
import sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration as tfr
from sleipnir_tpu.optimization.solver.funcs import ScalingArrays as JaxScaling
from sleipnir_tpu.optimization.solver.funcs import bind as jax_bind
from sleipnir_tpu_torch.interop import ipm_state_from_numpy
from sleipnir_tpu_torch.models import double_integrator
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays, bind
from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA

torch.set_num_threads(1)

VS, VAR = "VARIABLE_SINGLE", "VARIABLE"


def _jax_double_integrator(x, u):
    return jnp.stack([x[1, 0], u[0, 0]]).reshape(2, 1)


def _jax_min_time(N, method):
    """tests/solver/test_border_backend.py:_min_time_double_integrator."""
    ocp = jslp.OCP(
        2, 1, 0.05, N, _jax_double_integrator, jslp.DynamicsType.EXPLICIT_ODE,
        getattr(jslp.TimestepMethod, method), jslp.TranscriptionMethod.DIRECT_TRANSCRIPTION,
    )
    ocp.constrain_initial_state(np.array([[0.0], [0.0]]))
    ocp.constrain_final_state(np.array([[1.0], [0.0]]))
    ocp.set_lower_input_bound(-1.0)
    ocp.set_upper_input_bound(1.0)
    ocp.set_min_timestep(1e-3)
    ocp.set_max_timestep(1.0)
    if method == VS:
        ocp.minimize(ocp.dt()[0, 0] * N)
    else:
        ocp.minimize(ocp.dt()[0, :].sum())
    return ocp


def _torch_min_time(N, method):
    return double_integrator.min_time_problem(N, getattr(tslp.TimestepMethod, method))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("method,width,nb", [(VS, 3, 1), (VAR, 4, 0)])
def test_stage_structure_matches_jax(method, width, nb):
    """The shared dt is one border column over stages (x0, x1, u); per-step
    dt widens the stage to (x0, x1, u, dt) instead (the JAX package's
    test_border_backend.py:49-66), and every index agrees."""
    jp, tp = _jax_min_time(20, method), _torch_min_time(20, method)
    js = jp._stage_structure(jp._compile())
    ts = tp._stage_structure(tp._compile())
    assert ts.stage_width == width and ts.border.shape == (nb,)
    for name in ts._fields:
        assert np.array_equal(np.asarray(getattr(ts, name)), np.asarray(getattr(js, name))), name


def test_shared_dt_broadcasts_as_one_node():
    """The shared dt reaches every step through one expression node, so
    evaluating the N+1 dt bounds costs O(1) operations, not one per step
    (at N=5000 a row of N+1 parts made each iteration 20x slower on the
    card), with the values and bound rows of the JAX package's row."""
    N = 50
    tp = _torch_min_time(N, VS)
    dt = tp.dt()
    assert dt.shape == (1, N + 1) and len(dt.expr.args) <= 2
    np.testing.assert_array_equal(dt.value(), np.full((1, N + 1), 0.05))
    assert tp._compile()["mi"] == _jax_min_time(N, VS)._compile()["mi"]


@pytest.fixture(scope="module")
def bordered():
    """Both packages' IPM bundles for the VARIABLE_SINGLE double integrator
    at N=12, and one random interior state (x, s, y, z) in numpy."""
    N = 12
    jp, tp = _jax_min_time(N, VS), _torch_min_time(N, VS)
    jcomp, jbundle = jp.prepare_ipm(jslp.Options())
    tcomp = tp._compile()
    tbundle = tp._prepare_ipm(tcomp, tslp.Options(device="cpu"), torch.device("cpu"))
    n, me, mi = tcomp["n"], tcomp["me"], tcomp["mi"]
    rng = np.random.default_rng(3)
    state = {
        "x": 0.1 + 0.05 * rng.standard_normal(n),
        "y": rng.standard_normal(me),
        "z": 0.5 + 0.1 * rng.standard_normal(mi) ** 2,
        "s": 0.5 + 0.1 * rng.standard_normal(mi) ** 2,
    }
    scaling = {"f": 0.7, "c_e": 0.5 + rng.random(me), "c_i": 0.5 + rng.random(mi)}
    jparams = jnp.asarray(jcomp["compiled"].gather_params())
    tparams = torch.as_tensor(tcomp["compiled"].gather_params())
    jF = jax_bind(jbundle[3], jparams, JaxScaling(*(jnp.asarray(scaling[k]) for k in
                                                    ("f", "c_e", "c_i"))), jnp.float64)
    tF = bind(tbundle[3], tparams, ScalingArrays(*(torch.as_tensor(scaling[k]) for k in
                                                   ("f", "c_e", "c_i"))))
    jb, tb = jbundle[-1], tbundle[-1]
    jd = jb.eval_derivs(jF, *(jnp.asarray(state[k]) for k in "xyz"))
    td = tb.eval_derivs(tF, *(torch.as_tensor(state[k]) for k in "xyz"))
    return {"jb": jb, "tb": tb, "jd": jd, "td": td, "state": state, "tF": tF, "tparams": tparams,
            "jp": jp, "jcomp": jcomp, "jbundle": jbundle, "tp": tp, "tcomp": tcomp,
            "tbundle": tbundle}


def test_banded_derivs_match_jax(bordered):
    jd, td = bordered["jd"], bordered["td"]
    assert bordered["tb"].nb == 1
    assert td.Hb.shape == (1, 13, 3) and td.Aib.shape[1] == 1
    for name in td._fields:
        assert _rel(getattr(td, name).numpy(), getattr(jd, name)) <= 1e-12, name


def _rhs(backend, d, st, to):
    """An IPM-like right-hand side (interior_point.py:351-361) at the
    state, with μ = 0.1 and the constraint values replaced by unit rows."""
    x, s, y, z = (to(st[k]) for k in "xsyz")
    sigma = z / s
    rhs_top = -x + backend.AeT(d, y) + backend.AiT(d, -sigma + 0.1 / s + z)
    return sigma, rhs_top, -y


def test_factor_and_bordered_solve_match_jax(bordered):
    jb, tb, jd, td, st = (bordered[k] for k in ("jb", "tb", "jd", "td", "state"))
    jsig, jtop, jbot = _rhs(jb, jd, st, jnp.asarray)
    tsig, ttop, tbot = _rhs(tb, td, st, torch.as_tensor)
    for prev in (0.0, 1e-2):
        jfac = jb.factor(jd, jsig, jnp.asarray(prev), 1e-10)
        tfac = tb.factor(td, tsig, torch.tensor(prev, dtype=torch.float64), 1e-10)
        assert bool(jfac.ok) and tfac.ok
        assert float(tfac.delta) == float(jfac.delta)
        assert float(tfac.gamma) == float(jfac.gamma)
        # Inertia of the band and of the border Schur complement
        for td_, jd_ in ((tfac.fac.d[0].numpy(), np.asarray(jfac.fac.d)),
                         (tfac.Sb_d.numpy(), np.asarray(jfac.Sb_d))):
            for sel in (lambda d: d > EPS_INERTIA, lambda d: d < -EPS_INERTIA):
                assert int(sel(td_).sum()) == int(sel(jd_).sum())
        assert _rel(tfac.Sb_d.numpy(), jfac.Sb_d) <= 1e-10
        assert _rel(tfac.Xcols.numpy(), jfac.Xcols) <= 1e-10
        assert _rel(tfac.col.numpy(), jfac.col) <= 1e-12
        assert _rel(tfac.e0.numpy(), jfac.e0) <= 1e-12

        jpx, jpy = jb.solve_refined(jd, jsig, jfac, jtop, jbot)
        tpx, tpy = tb.solve_refined(td, tsig, tfac, ttop, tbot)
        assert _rel(tpx.numpy(), jpx) <= 1e-10
        assert _rel(tpy.numpy(), jpy) <= 1e-10


def test_matvecs_match_jax(bordered):
    jb, tb, jd, td = (bordered[k] for k in ("jb", "tb", "jd", "td"))
    rng = np.random.default_rng(8)
    u = rng.standard_normal(tb.n)
    ve, vi = rng.standard_normal(tb.me), rng.standard_normal(tb.mi)
    for name, v in (("AeT", ve), ("Ae", u), ("AiT", vi), ("Ai", u)):
        got = getattr(tb, name)(td, torch.as_tensor(v)).numpy()
        assert _rel(got, getattr(jb, name)(jd, jnp.asarray(v))) <= 1e-13, name


def test_border_dense_reconstruction_matches_autodiff(bordered):
    """backend.dense() reproduces the whole H, Aₑ and Aᵢ, border column
    included, against torch.func Jacobians and Hessians of the same
    functions (the JAX package's test_border_backend.py:141-183)."""
    tb, td, tF, st = (bordered[k] for k in ("tb", "td", "tF", "state"))
    params, sc = bordered["tparams"], tF.scaling
    x, y, z = (torch.as_tensor(st[k]) for k in "xyz")
    H, A_e, A_i = tb.dense(td)

    def lag(xv):
        return (sc.f * tb.f_raw(xv, params) - (sc.c_e * y) @ tb.ce_raw(xv, params)
                - (sc.c_i * z) @ tb.ci_raw(xv, params))

    A_e_ref = torch.func.jacfwd(lambda xv: sc.c_e * tb.ce_raw(xv, params))(x).numpy()
    A_i_ref = torch.func.jacfwd(lambda xv: sc.c_i * tb.ci_raw(xv, params))(x).numpy()
    H_ref = torch.func.hessian(lag)(x).numpy()
    np.testing.assert_allclose(A_e, A_e_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(A_i, A_i_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(H, H_ref, rtol=0, atol=1e-8)


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
    assert _rel(port, ref) <= rtol, path


def test_ipm_steps_from_the_jax_state_match(bordered):
    """Three interior-point steps of the VARIABLE_SINGLE double integrator
    (N=12), each from the JAX package's state carried across as numpy,
    border derivative fields included: every field of the next state to
    1e-9, the same status and iteration count."""
    jp = bordered["jp"]
    jp.solve(max_iterations=0)
    jstep = jax.jit(bordered["jbundle"][1])
    tstep = bordered["tbundle"][1]
    jstate = jp._last_state
    assert np.asarray(jstate.derivs.Hb).shape == (1, 13, 3)
    for _ in range(3):
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(ipm_state_from_numpy(start, "cpu"))
        assert port.status == int(jstate.status)
        assert port.iterations == int(jstate.iterations)
        _assert_states_close(_to_numpy(port), _to_numpy(jstate), 1e-9)


def test_restore_from_min_time_iterate_matches_jax(bordered):
    """Banded restoration of the VARIABLE_SINGLE double integrator (N=12)
    from a strongly infeasible iterate (seed 7, scale 0.5, dt among the
    variables): the border column carries into the augmented problem, and
    both packages hand the iterate back with the violation reduced. The
    problems are the module's, so the JAX package reuses its compiled
    solver."""
    seed, scale = 7, 0.5
    jp, jcomp, jbundle = (bordered[k] for k in ("jp", "jcomp", "jbundle"))
    tp, tcomp, tbundle = (bordered[k] for k in ("tp", "tcomp", "tbundle"))
    jinit, jfuncs, jbackend = jbundle[0], jbundle[3], jbundle[-1]
    jparams = jcomp["compiled"].gather_params()
    x0 = scale * np.random.default_rng(seed).standard_normal(jcomp["n"])
    jsc, _ = jp.compute_ipm_scaling(jcomp, jbundle, x0, jparams)
    jstate = jinit(x0, np.ones(jcomp["mi"]), np.zeros(jcomp["me"]), np.ones(jcomp["mi"]),
                   0.1 * jsc.f, 0, jparams,
                   JaxScaling(*(jnp.asarray(a) for a in (jsc.f, jsc.c_e, jsc.c_i))))

    options = tslp.Options(device="cpu")
    tinit, _step, _resume, tfuncs, g_fn, tbackend = tbundle
    tparams = tcomp["compiled"].gather_params()
    tsc, _, _ = tp._ipm_scaling(g_fn, tbackend, x0, tparams)
    np.testing.assert_allclose(tsc.c_i, jsc.c_i, rtol=1e-14)
    np.testing.assert_allclose(tsc.c_e, jsc.c_e, rtol=1e-14)
    tstate = tinit(x0, np.ones(tcomp["mi"]), np.zeros(tcomp["me"]), np.ones(tcomp["mi"]),
                   0.1 * tsc.f, 0, tparams, ScalingArrays(f=tsc.f, c_e=tsc.c_e, c_i=tsc.c_i))

    def viol(c_e, c_i):
        return np.sum(np.abs(c_e)) + np.sum(np.abs(np.minimum(c_i, 0.0)))

    def jviol(x):
        xj = jnp.asarray(x)
        return viol(np.asarray(jfuncs.c_e(xj, jstate.params, jstate.scaling)),
                    np.asarray(jfuncs.c_i(xj, jstate.params, jstate.scaling)))

    def tviol(x):
        xt = torch.as_tensor(x)
        return viol(tfuncs.c_e(xt, tstate.params, tstate.scaling).numpy(),
                    tfuncs.c_i(xt, tstate.params, tstate.scaling).numpy())

    v0 = jviol(x0)
    assert v0 > 1e-2 and tviol(x0) == pytest.approx(v0, rel=1e-12)
    jout = jfr.restore(jfuncs, jstate, jslp.Options(), parent_backend=jbackend)
    tout = tfr.restore(tfuncs, tstate, options, parent_backend=tbackend)
    print(f"JAX {jout[0]} after {jout[-1]} iterations, port {tout[0]} after {tout[-1]}")
    assert tout[0] == jout[0] == "resume"
    assert jviol(jout[1]) < 0.95 * v0
    assert tviol(tout[1]) < 0.95 * v0
    assert abs(tout[-1] - jout[-1]) <= 2
    assert np.all(tout[2] > 0.0)
