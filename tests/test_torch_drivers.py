"""The port's Gradient, Jacobian and Hessian drivers against the JAX
package's, on expressions built alike in both DSLs from seeded values:
`.value()` to 1e-12 (both the forward-mode and the reverse-mode
Jacobian), `.get()` as a symbolic matrix evaluated at the same point, and
a `.get()` reused inside a cost and differentiated again."""

import numpy as np
import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp

torch.set_num_threads(1)

N = 4


def _vars(pkg, seed):
    """A column of N variables at seeded values."""
    x = pkg.VariableMatrix(N)
    x.set_value(np.random.default_rng(seed).uniform(0.5, 1.5, (N, 1)))
    return x


def _scalar(pkg, x):
    return (
        pkg.sin(x[0, 0]) * x[1, 0] ** 3
        + pkg.exp(x[2, 0] * x[3, 0])
        + pkg.log(x[1, 0] + x[3, 0]) / x[0, 0]
        + pkg.sqrt(x[2, 0]) * pkg.cos(x[3, 0])
    )


def _tall(pkg, x):
    """Six functions of four variables (jacfwd in both packages)."""
    return pkg.VariableMatrix([
        [x[0, 0] * x[1, 0]], [pkg.sin(x[2, 0])], [x[3, 0] ** 2 - x[0, 0]],
        [pkg.exp(x[1, 0]) * x[2, 0]], [x[0, 0] + x[1, 0] + x[2, 0] + x[3, 0]],
        [pkg.atan2(x[3, 0], x[0, 0])],
    ])


def _wide(pkg, x):
    """Two functions of four variables (jacrev in both packages)."""
    return pkg.VariableMatrix([
        [x[0, 0] * x[1, 0] * x[2, 0] - x[3, 0]],
        [pkg.hypot(x[0, 0], x[3, 0]) + pkg.tanh(x[1, 0] * x[2, 0])],
    ])


def _pair(seed, build):
    jx, tx = _vars(jslp, seed), _vars(tslp, seed)
    return (build(jslp, jx), jx), (build(tslp, tx), tx)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_and_hessian_values(seed):
    (jf, jx), (tf, tx) = _pair(seed, _scalar)
    jg, tg = jslp.Gradient(jf, jx).value(), tslp.Gradient(tf, tx, device="cpu").value()
    assert tg.shape == (N, 1)
    np.testing.assert_allclose(tg, jg, rtol=1e-12, atol=1e-12)
    jh, th = jslp.Hessian(jf, jx).value(), tslp.Hessian(tf, tx, device="cpu").value()
    assert th.shape == (N, N)
    np.testing.assert_allclose(th, jh, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("build,rows", [(_tall, 6), (_wide, 2)])
def test_jacobian_values_both_modes(build, rows):
    (jf, jx), (tf, tx) = _pair(3, build)
    jj, tj = jslp.Jacobian(jf, jx).value(), tslp.Jacobian(tf, tx, device="cpu").value()
    assert tj.shape == (rows, N)
    np.testing.assert_allclose(tj, jj, rtol=1e-12, atol=1e-12)


def test_values_follow_set_value():
    (jf, jx), (tf, tx) = _pair(4, _scalar)
    tg = tslp.Gradient(tf, tx, device="cpu")
    for pkg_x in (jx, tx):
        pkg_x.set_value(np.full((N, 1), 0.75))
    np.testing.assert_allclose(tg.value(), jslp.Gradient(jf, jx).value(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["gradient", "jacobian", "hessian"])
def test_symbolic_get_values(kind):
    build = _tall if kind == "jacobian" else _scalar
    (jf, jx), (tf, tx) = _pair(5, build)
    cls = {"gradient": "Gradient", "jacobian": "Jacobian", "hessian": "Hessian"}[kind]
    jm = getattr(jslp, cls)(jf, jx).get()
    tm = getattr(tslp, cls)(tf, tx, device="cpu").get()
    assert tm.shape == jm.shape
    np.testing.assert_allclose(tm.value(), jm.value(), rtol=1e-12, atol=1e-12)


def test_get_reused_inside_a_cost():
    """‖∇f‖² built from `Gradient.get()`: its value and its own gradient
    (a derivative through the symbolic gradient node) agree."""
    (jf, jx), (tf, tx) = _pair(6, _scalar)
    jg, tg = jslp.Gradient(jf, jx).get(), tslp.Gradient(tf, tx, device="cpu").get()
    jc, tc = (jg.T @ jg)[0, 0], (tg.T @ tg)[0, 0]
    assert tc.value() == pytest.approx(jc.value(), rel=1e-12)
    np.testing.assert_allclose(
        tslp.Gradient(tc, tx, device="cpu").value(), jslp.Gradient(jc, jx).value(),
        rtol=1e-12, atol=1e-12,
    )


def test_default_device_is_the_card():
    """The default device is the card: without one, `.value()` raises
    (the device is resolved there, not in the constructor)."""
    x = tslp.Variable()
    x.set_value(2.0)
    gradient = tslp.Gradient(x * x, x)
    if torch.cuda.is_available():
        assert gradient.value()[0, 0] == 4.0
    else:
        with pytest.raises(RuntimeError, match="asks for CUDA"):
            gradient.value()


@pytest.mark.parametrize("driver", ["Gradient", "Jacobian", "Hessian"])
def test_get_needs_no_device(driver):
    """`.get()` is symbolic: at the default device it builds the derivative
    without a card, as the JAX package's drivers do, and the result
    evaluates like the JAX package's."""
    (jf, jx), (tf, tx) = _pair(4, _tall if driver == "Jacobian" else _scalar)
    port = getattr(tslp, driver)(tf, tx).get()
    ref = getattr(jslp, driver)(jf, jx).get()
    np.testing.assert_allclose(port.value(), ref.value(), rtol=1e-12, atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="asks for CUDA"):
            getattr(tslp, driver)(tf, tx).value()
