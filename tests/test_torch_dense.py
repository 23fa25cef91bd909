"""The port's blocked dense LDLᵀ (`ops/ldlt.py`) and dense KKT backend
(`kkt_backend.DenseBackend`) against the JAX package's, on the same
float64 inputs made from a seed with numpy; and the cases of the JAX
package's tests/solver/test_ldlt.py that need no solver."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sleipnir_tpu.ops import ldlt as jldlt
from sleipnir_tpu.optimization.solver import kkt_backend as jkb
from sleipnir_tpu_torch.ops import ldlt as tldlt
from sleipnir_tpu_torch.optimization.solver import kkt_backend as tkb
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs

torch.set_num_threads(1)

_EPS = float(np.finfo(np.float64).eps)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _random_sym(n, rng):
    """The JAX package's test matrix: symmetric, diagonally shifted."""
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2 + n * np.eye(n)


def _indefinite(n, rng):
    """Symmetric indefinite: diagonal entries of random sign and size
    about n, so every unpivoted pivot stays away from zero."""
    A = rng.standard_normal((n, n))
    signs = rng.choice([-1.0, 1.0], n)
    return (A + A.T) / 2 + np.diag(signs * rng.uniform(n, 2.0 * n, n))


def _refined_solve(solve, A, b):
    """One solve plus one refinement pass against A."""
    x = solve(b)
    return x + solve(b - A @ x)


@pytest.mark.parametrize("n", [7, 128, 129, 300])
def test_blocked_ldlt_matches_jax_across_the_block_edge(n):
    """Inertia exactly; solutions after one refinement to 1e-11 relative
    (both are backward-stable solves of the same well-posed system; the
    block edge at 128 is where the blocked path's panel solve and
    trailing update begin)."""
    rng = np.random.default_rng(n)
    A = _indefinite(n, rng)
    b = rng.standard_normal(n)
    L, d = tldlt.ldlt_factor(_t(A))
    jL, jd = jldlt.ldlt_factor(jnp.asarray(A))
    eps = _EPS**0.75
    assert [int(v) for v in tldlt.inertia(d, eps)] == [int(v) for v in jldlt.inertia(jd, eps)]
    assert [int(v) for v in tldlt.inertia(d, eps)] == [
        int(np.sum(np.linalg.eigvalsh(A) > 0)), int(np.sum(np.linalg.eigvalsh(A) < 0)), 0
    ]
    x = _refined_solve(lambda r: tldlt.ldlt_solve(L, d, r), _t(A), _t(b)).numpy()
    jx = np.asarray(_refined_solve(lambda r: jldlt.ldlt_solve(jL, jd, r), jnp.asarray(A), jnp.asarray(b)))
    scale = np.abs(jx).max()
    assert np.abs(x - jx).max() <= 1e-11 * scale
    assert np.abs(x - np.linalg.solve(A, b)).max() <= 1e-11 * scale


@pytest.mark.parametrize("n", [1, 4, 17, 128, 200, 300])
def test_ldlt_reconstruction(n):
    """tests/solver/test_ldlt.py::test_ldlt_reconstruction on the port."""
    rng = np.random.default_rng(n)
    A = _random_sym(n, rng)
    L, d = (t.numpy() for t in tldlt.ldlt_factor(_t(A)))
    np.testing.assert_allclose(L @ np.diag(d) @ L.T, A, atol=1e-8)
    np.testing.assert_allclose(np.diag(L), 1.0, atol=1e-12)
    assert np.allclose(np.triu(L, 1), 0.0)


@pytest.mark.parametrize("n", [5, 64, 190])
def test_ldlt_solve(n):
    """tests/solver/test_ldlt.py::test_ldlt_solve on the port."""
    rng = np.random.default_rng(n)
    A = _random_sym(n, rng)
    b = rng.standard_normal(n)
    L, d = tldlt.ldlt_factor(_t(A))
    x = tldlt.ldlt_solve(L, d, _t(b)).numpy()
    np.testing.assert_allclose(A @ x, b, atol=1e-7)


def test_inertia_of_saddle_matrix():
    """tests/solver/test_ldlt.py::test_inertia_of_saddle_matrix on the port."""
    rng = np.random.default_rng(7)
    n, me = 20, 8
    H = _random_sym(n, rng)
    A = rng.standard_normal((me, n))
    K = np.zeros((n + me, n + me))
    K[:n, :n] = H
    K[:n, n:] = A.T
    K[n:, :n] = A
    _L, d = tldlt.ldlt_factor(_t(K))
    pos, neg, zero = (int(v) for v in tldlt.inertia(d, _EPS))
    eig = np.linalg.eigvalsh(K)
    assert (pos, neg, zero) == (int(np.sum(eig > 0)), int(np.sum(eig < 0)), 0)


def test_batched_factor_equals_each_matrix_alone():
    """The ladder factors its candidates as one batch."""
    rng = np.random.default_rng(3)
    mats = np.stack([_indefinite(150, rng) for _ in range(3)])
    L, d = tldlt.ldlt_factor(_t(mats))
    for i in range(3):
        Li, di = tldlt.ldlt_factor(_t(mats[i]))
        np.testing.assert_allclose(L[i].numpy(), Li.numpy(), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(d[i].numpy(), di.numpy(), rtol=1e-13)


def _kkt_case(name):
    """Random scaled KKT data (H, A_e, A_i, σ) and the regularization
    history: me = 0, me > 0 with an indefinite H, rank-deficient Aₑ, and
    a previous δ."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, me, mi, prev_delta = {
        "unconstrained-pd": (9, 0, 0, 0.0),
        "ineq-only": (12, 0, 7, 0.0),
        "eq-indefinite": (20, 6, 10, 0.0),
        "eq-rank-deficient": (15, 5, 4, 0.0),
        "prev-delta": (30, 10, 12, 3e-3),
        "across-block-edge": (110, 40, 30, 0.0),
    }[name]
    H = rng.standard_normal((n, n))
    H = (H + H.T) / 2
    if name in ("unconstrained-pd", "ineq-only"):
        H = H @ H.T + np.eye(n)
    A_e = rng.standard_normal((me, n))
    if name == "eq-rank-deficient":
        A_e[-1] = A_e[0]
    A_i = rng.standard_normal((mi, n))
    sigma = rng.uniform(0.1, 10.0, mi)
    rhs_top, rhs_bottom = rng.standard_normal(n), rng.standard_normal(me)
    return n, me, mi, prev_delta, (H, A_e, A_i), sigma, rhs_top, rhs_bottom


@pytest.mark.parametrize("name", [
    "unconstrained-pd", "ineq-only", "eq-indefinite", "eq-rank-deficient", "prev-delta",
    "across-block-edge",
])
def test_dense_backend_matches_jax(name):
    """The chosen δ and γ exactly, the factor's inertia exactly, and the
    refined solutions to 1e-10 relative: the two packages factor the same
    equilibrated matrices with the same unpivoted algorithm, in another
    summation order."""
    n, me, mi, prev_delta, (H, A_e, A_i), sigma, rt, rb = _kkt_case(name)
    jb = jkb.DenseBackend(n, me, mi, jnp.float64)
    jd = jkb.DenseDerivs(H=jnp.asarray(H), A_e=jnp.asarray(A_e), A_i=jnp.asarray(A_i))
    jfac = jb.factor(jd, jnp.asarray(sigma), jnp.asarray(prev_delta), 1e-10)
    jx, jy = jb.solve_refined(jd, jnp.asarray(sigma), jfac, jnp.asarray(rt), jnp.asarray(rb))

    tb = tkb.DenseBackend(n, me, mi, torch.device("cpu"), HostSyncs())
    td = tkb.DenseDerivs(H=_t(H), A_e=_t(A_e), A_i=_t(A_i))
    tfac = tb.factor(td, _t(sigma), _t(prev_delta), 1e-10)
    tx, ty = tb.solve_refined(td, _t(sigma), tfac, _t(rt), _t(rb))

    assert bool(tfac.ok) == bool(jfac.ok)
    assert float(tfac.delta) == float(jfac.delta)
    assert float(tfac.gamma) == float(jfac.gamma)
    eps = tkb.EPS_INERTIA
    assert [int(v) for v in tldlt.inertia(tfac.d, eps)] == [
        int(v) for v in jldlt.inertia(jfac.d, eps)
    ] == [n, me, 0]
    ref = np.concatenate([np.asarray(jx), np.asarray(jy)])
    out = np.concatenate([tx.numpy(), ty.numpy()])
    assert np.abs(out - ref).max() <= 1e-10 * np.abs(ref).max()
    if name == "eq-rank-deficient":
        assert float(tfac.gamma) > 0.0


def test_dense_backend_corrects_inertia():
    """tests/solver/test_ldlt.py::test_regularized_ldlt_corrects_inertia
    through the port's dense backend: an indefinite Hessian needs δ > 0,
    and the regularized factor solves its regularized system."""
    n, me = 3, 1
    H = np.diag([1.0, -2.0, 1.0])
    A = np.array([[1.0, 1.0, 1.0]])
    tb = tkb.DenseBackend(n, me, 0, torch.device("cpu"), HostSyncs())
    td = tkb.DenseDerivs(H=_t(H), A_e=_t(A), A_i=torch.zeros((0, n), dtype=torch.float64))
    empty = torch.zeros(0, dtype=torch.float64)
    fac = tb.factor(td, empty, _t(0.0), 1e-10)
    assert fac.ok
    assert float(fac.delta) > 0.0
    assert [int(v) for v in tldlt.inertia(fac.d, tkb.EPS_INERTIA)] == [n, me, 0]
    p_x, p_y = tb.solve(fac, torch.ones(n, dtype=torch.float64), torch.ones(me, dtype=torch.float64))
    K = np.block([[H + float(fac.delta) * np.eye(n), A.T], [A, -float(fac.gamma) * np.eye(me)]])
    np.testing.assert_allclose(K @ np.concatenate([p_x.numpy(), -p_y.numpy()]), 1.0, atol=1e-8)
