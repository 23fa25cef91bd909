"""The port's autodiff layer against the JAX package on the same inputs:
the f64-accurate trig kernels, DSL expressions evaluated and
differentiated through both compiled evaluators, and the cart-pole
dynamics."""

import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd, jvp, vmap

import jax
import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.autodiff import expression as jex
from sleipnir_tpu.models import cart_pole as jcp
from sleipnir_tpu.ops import accurate_math as jam
from sleipnir_tpu_torch.autodiff import expression as tex
from sleipnir_tpu_torch.models import cart_pole as tcp
from sleipnir_tpu_torch.ops import accurate_math as tam

torch.set_num_threads(1)


def _within_ulps(a, b, ulps):
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(np.abs(a - b) <= ulps * np.spacing(np.abs(b))))


@pytest.mark.parametrize("scale", [0.8, np.pi, 20.0, 1e3, 1e6])
def test_accurate_trig_matches_jax(scale):
    rng = np.random.default_rng(int(scale) % 7919)
    x = np.concatenate(
        [rng.uniform(-scale, scale, 2048), np.pi / 2 * np.arange(-8, 9) + 1e-13]
    )
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for name in ("sin", "cos", "tan"):
        got = getattr(tam, name)(xt).numpy()
        want = np.asarray(getattr(jam, name)(xj))
        assert _within_ulps(got, want, 1), name
        if name != "tan":  # tan is unbounded near the poles this grid hits
            # ... and within a few ulp of libm (tests/ops/test_accurate_math.py)
            np.testing.assert_allclose(got, getattr(np, name)(x), rtol=0, atol=4e-15)


def test_accurate_trig_derivatives_match_jax():
    x = np.array([-7.3, -0.4, 0.3, 1.9, 12.5])
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for name in ("sin", "cos"):
        tf, jf = getattr(tam, name), getattr(jam, name)
        # reverse mode, elementwise
        g_t = vmap(grad(tf))(xt).numpy()
        g_j = np.asarray(jax.vmap(jax.grad(jf))(xj))
        assert _within_ulps(g_t, g_j, 1), name
        # reverse-over-reverse
        gg_t = vmap(grad(grad(tf)))(xt).numpy()
        gg_j = np.asarray(jax.vmap(jax.grad(jax.grad(jf)))(xj))
        assert _within_ulps(gg_t, gg_j, 1), name
        # forward-over-reverse (the banded backend's HVP pattern)
        def gsum_t(v):
            return grad(lambda u: tf(u).sum())(v)

        hv_t = jvp(gsum_t, (xt,), (torch.ones_like(xt),))[1].numpy()
        hv_j = np.asarray(
            jax.jvp(jax.grad(lambda u: jf(u).sum()), (xj,), (jnp.ones_like(xj),))[1]
        )
        assert _within_ulps(hv_t, hv_j, 1), name


def _build(slp):
    """The same DSL program in either package: matmul, slicing, pow, trig
    and sum, plus a parameter."""
    x = slp.VariableMatrix(4, 1)
    A = np.array([[1.0, -2.0, 0.5, 3.0], [0.25, 1.5, -1.0, 2.0], [2.0, 0.0, 1.0, -0.5]])
    p = slp.Variable(1.7)
    y = A @ x  # (3, 1)
    scalar = (
        (y.T @ y)[0, 0] * p
        + slp.sin(x[1, 0]) * x[2, 0] ** 3
        + slp.cos(x[0:2, :]).sum()
        - slp.tan(x[3, 0] * 0.3)
        + (x[1:4, :] ** 2).sum()
    )
    vector = slp.block([[y * slp.sin(x[0, 0])], [x[2:4, :] ** 3 - p]])
    return x, scalar, vector


def test_dsl_expressions_match_jax():
    rng = np.random.default_rng(11)
    xv = rng.uniform(-1.5, 1.5, 4)
    results = {}
    for name, slp, ex in (("jax", jslp, jex), ("torch", tslp, tex)):
        x, scalar, vector = _build(slp)
        assert scalar.type() == vector.type()
        x.set_value(xv)
        results[name] = (
            ex.CompiledEval([scalar.expr, vector.expr], x.expr.ids.ravel()),
            scalar.value(),
            vector.value(),
        )
    cj, sj, vj = results["jax"]
    ct, st, vt = results["torch"]
    np.testing.assert_allclose(st, sj, rtol=1e-14)
    np.testing.assert_allclose(vt, vj, rtol=1e-14)

    pj, pt = jnp.asarray(cj.gather_params()), torch.tensor(ct.gather_params())
    x_j, x_t = jnp.asarray(xv), torch.tensor(xv)

    def rel(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()

    s_j, v_j = cj(x_j, pj)
    s_t, v_t = ct(x_t, pt)
    assert rel(s_t.numpy(), s_j) <= 1e-14
    assert rel(v_t.numpy(), v_j) <= 1e-14
    g_j = jax.grad(lambda u: cj(u, pj)[0])(x_j)
    g_t = grad(lambda u: ct(u, pt)[0])(x_t)
    assert rel(g_t.numpy(), g_j) <= 1e-14
    J_j = jax.jacfwd(lambda u: cj(u, pj)[1].reshape(-1))(x_j)
    J_t = jacfwd(lambda u: ct(u, pt)[1].reshape(-1))(x_t)
    assert rel(J_t.numpy(), J_j) <= 1e-14
    H_j = jax.hessian(lambda u: cj(u, pj)[0])(x_j)
    H_t = torch.func.hessian(lambda u: ct(u, pt)[0])(x_t)
    assert rel(H_t.numpy(), H_j) <= 1e-14


def test_symbolic_gradient_node_matches_jax():
    rng = np.random.default_rng(4)
    xv = rng.uniform(-1.0, 1.0, 3)
    vals = []
    for slp, ex in ((jslp, jex), (tslp, tex)):
        x = slp.VariableMatrix(3, 1)
        x.set_value(xv)
        f = (slp.sin(x[0, 0]) * x[1, 0] ** 2 + x[2, 0] * x[0, 0]).expr
        vals.append(np.asarray(ex.evaluate(ex.grad_of(f, x.expr))))
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-14)


def test_cart_pole_dynamics_matches_jax():
    rng = np.random.default_rng(1)
    xs = rng.uniform(-4.0, 4.0, (64, 4, 1))
    us = rng.uniform(-20.0, 20.0, (64, 1, 1))
    got = vmap(tcp.dynamics)(torch.tensor(xs), torch.tensor(us)).numpy()
    want = np.asarray(jax.vmap(jcp.dynamics)(jnp.asarray(xs), jnp.asarray(us)))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    # The JAX package's plain-double oracle agrees with both.
    oracle = np.stack([jcp.dynamics_numpy(x, u) for x, u in zip(xs, us)])
    np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        np.stack([tcp.dynamics_numpy(x, u) for x, u in zip(xs, us)]), oracle
    )


def test_dsl_surface_matches_jax():
    """Slicing, assignment, comparisons and set_value/value behave alike."""
    out = []
    for slp in (jslp, tslp):
        X = slp.VariableMatrix(2, 3)
        X.set_value(np.arange(6.0).reshape(2, 3))
        X[1, 2] = X[0, 0] * 4.0 + 1.0
        con = X[0:1, :] >= 0.5
        eq = X[:, 1] == np.array([[1.0], [4.0]])
        out.append((X.value(), X[1, :].value(), con.residual_values(), bool(eq), X.type()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_cache_holds_no_transform_wrapped_tensor():
    """Constants reach the device before any torch.func transform runs, so
    none of the cached tensors belongs to a transform that has ended."""
    from torch._C._functorch import is_functorch_wrapped_tensor

    p, _, _ = tcp.cart_pole_problem(N=5)
    p.solve(device="cpu", max_iterations=2)
    ((*_rest, backend),) = p._solver_cache.values()
    cache = backend.ce_raw.__self__.compiled._device_cache
    assert cache
    assert not any(is_functorch_wrapped_tensor(t) for t in cache.values())
