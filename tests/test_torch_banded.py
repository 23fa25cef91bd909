"""The port's block-tridiagonal factor/solve/inertia (the plain twin of
the Hopper kernels K1/K2) against the JAX package's CPU scan, its Pallas
kernels in interpret mode, a dense numpy solve and eigvalsh. The CUDA
kernels are held against the twin on the card in
tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sleipnir_tpu.ops import block_tridiag as jbt
from sleipnir_tpu.ops import pallas_banded as pb
from sleipnir_tpu_torch.interop import banded_system_from_numpy
from sleipnir_tpu_torch.ops import block_tridiag as tbt
from sleipnir_tpu_torch.ops import cuda_banded

torch.set_num_threads(1)

#: Pivot zero-threshold of the inertia count on these O(1)-pivot systems.
EPS = 1e-12


def _dense(D, E):
    K, w, _ = D.shape
    M = np.zeros((K * w, K * w))
    for k in range(K):
        M[k * w:(k + 1) * w, k * w:(k + 1) * w] = D[k]
        if k + 1 < K:
            M[(k + 1) * w:(k + 2) * w, k * w:(k + 1) * w] = E[k]
            M[k * w:(k + 1) * w, (k + 1) * w:(k + 2) * w] = E[k].T
    return M


def _random_system(K, w, seed=42, r=None):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((K, w, w))
    D = D + np.swapaxes(D, 1, 2) + 10 * np.eye(w)
    D[::3] -= 18 * np.eye(w)
    E = rng.standard_normal((max(K - 1, 0), w, w))
    b = rng.standard_normal((K, w) if r is None else (K, w, r))
    return D, E, b


def _ipm_like_chain():
    """Quasidefinite stage blocks with tiny Hessian diagonals and near
    rank-deficient within-stage Jacobians (tests/ops/test_pallas_banded.py)."""
    rng = np.random.default_rng(3)
    K, m, p = 40, 5, 8
    w = m + p
    D = np.zeros((K, w, w))
    E = np.zeros((K - 1, w, w))
    for k in range(K):
        A = rng.standard_normal((p, m))
        D[k, :m, :m] = 1e-4 * np.eye(m)
        D[k, :m, m:] = A.T
        D[k, m:, :m] = A
        D[k, m:, m:] = -1e-10 * np.eye(p)
        if k + 1 < K:
            E[k, :m, :m] = 0.01 * rng.standard_normal((m, m))
            E[k, m:, :m] = rng.standard_normal((p, m))
    return D, E, rng.standard_normal((K, w))


def _twin(D, E, b):
    Dt, Et, bt = banded_system_from_numpy(D, E, b, "cpu")
    fac = tbt.block_tridiag_factor(Dt, Et)
    return fac, tbt.block_tridiag_solve(fac, bt)[0].numpy()


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize(
    "K,w", [(1, 4), (7, 3), (25, 5), (40, 13), (5, 37), (6, 32), (6, 33), (3, 1)]
)
def test_twin_matches_dense_eigvalsh_and_jax_scan(K, w):
    D, E, b = _random_system(K, w)
    fac, x = _twin(D, E, b)
    M = _dense(D, E)
    assert _rel(x.reshape(-1), np.linalg.solve(M, b.reshape(-1))) <= 1e-11

    ev = np.linalg.eigvalsh(M)
    pos, neg, zero = (int(t[0]) for t in tbt.block_tridiag_inertia(fac, EPS))
    assert (pos, neg, zero) == (int((ev > 0).sum()), int((ev < 0).sum()), 0)

    jfac = jbt.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    xj = np.asarray(jbt.block_tridiag_solve(jfac, jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-11
    assert [int(v) for v in jbt.block_tridiag_inertia(jfac, EPS)] == [pos, neg, zero]
    # The unpivoted-LDLᵀ pivots are the same recursion in both packages.
    np.testing.assert_allclose(fac.d[0].numpy(), np.asarray(jfac.d), rtol=1e-9, atol=1e-12)


def _tie_system(K, w, seed):
    """A random system whose S_0 and S_3 have a tie in column 0: rows 2 and
    4 hold ±7, the largest |entry|. E_2 = 0, so S_3 = D_3 exactly."""
    D, E, b = _random_system(K, w, seed=seed)
    for k in (0, 3):
        D[k, :, 0] = D[k, 0, :] = 0.5
        D[k, 0, 0] = 1.0
        D[k, 2, 0] = D[k, 0, 2] = 7.0
        D[k, 4, 0] = D[k, 0, 4] = -7.0
    E[2] = 0.0
    return D, E, b


@pytest.mark.parametrize("w", [5, 13])
def test_twin_tie_column_takes_the_first_row_and_matches_jax_scan(w):
    """LAPACK's rule on a tie: the first row holding the largest |entry|
    is the pivot, here row 2 of S_0 and of S_3."""
    D, E, b = _tie_system(6, w, seed=w)
    fac, x = _twin(D, E, b)
    assert int(fac.perm[0, 0, 0]) == 2 and int(fac.perm[0, 3, 0]) == 2
    jfac = jbt.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    xj = np.asarray(jbt.block_tridiag_solve(jfac, jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-11
    assert [int(t[0]) for t in tbt.block_tridiag_inertia(fac, EPS)] == [
        int(v) for v in jbt.block_tridiag_inertia(jfac, EPS)
    ]


def test_twin_factor_layout():
    """LU packed per Schur block with (PS)[i] = S[perm[i]], X_k = S_k⁻¹E_kᵀ."""
    D, E, _ = _random_system(6, 5, seed=9)
    Dt, Et, _ = banded_system_from_numpy(D, E, np.zeros((6, 5)), "cpu")
    fac = tbt.block_tridiag_factor(Dt, Et)
    S = D[0]
    for k in range(6):
        LU, perm = fac.LU[0, k].numpy(), fac.perm[0, k].numpy()
        L = np.tril(LU, -1) + np.eye(5)
        np.testing.assert_allclose(S[perm], L @ np.triu(LU), atol=1e-12)
        if k + 1 < 6:
            X = np.linalg.solve(S, E[k].T)
            np.testing.assert_allclose(fac.X[0, k].numpy(), X, rtol=1e-11, atol=1e-12)
            S = D[k + 1] - E[k] @ X


def test_twin_ipm_like_chain_matches_jax_scan():
    D, E, b = _ipm_like_chain()
    fac, x = _twin(D, E, b)
    jfac = jbt.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    xj = np.asarray(jbt.block_tridiag_solve(jfac, jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-11
    assert [int(t[0]) for t in tbt.block_tridiag_inertia(fac, EPS)] == [
        int(v) for v in jbt.block_tridiag_inertia(jfac, EPS)
    ]
    M = _dense(D, E)
    ev = np.linalg.eigvalsh(M)
    assert int((fac.d > EPS).sum()) == int((ev > 0).sum())
    assert int((fac.d < -EPS).sum()) == int((ev < 0).sum())
    # Backward stability: the residual is refinement-recoverable.
    r = M @ x.reshape(-1) - b.reshape(-1)
    assert np.abs(r).max() / np.abs(b).max() < 1e-3


def test_twin_batched_ladder_and_multiple_rhs():
    """A batch of B=3 systems (the regularization ladder's axis), each with
    three right-hand sides, agrees with per-system dense solves."""
    rng = np.random.default_rng(5)
    B, K, w = 3, 9, 4
    D = rng.standard_normal((B, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 8 * np.eye(w)
    E = rng.standard_normal((B, K - 1, w, w))
    b = rng.standard_normal((B, K, w, 3))
    Dt, Et, bt = banded_system_from_numpy(D, E, b, "cpu")
    fac = tbt.block_tridiag_factor(Dt, Et)
    x = tbt.block_tridiag_solve(fac, bt).numpy()
    x_vec = tbt.block_tridiag_solve(fac, bt[..., 0].contiguous()).numpy()
    pos, neg, zero = tbt.block_tridiag_inertia(fac, EPS)
    for c in range(B):
        M = _dense(D[c], E[c])
        xd = np.linalg.solve(M, b[c].reshape(K * w, 3))
        assert _rel(x[c].reshape(K * w, 3), xd) <= 1e-11
        # One column solved alone agrees to rounding (other BLAS kernels).
        np.testing.assert_allclose(x_vec[c], x[c, ..., 0], rtol=1e-13, atol=1e-15)
        ev = np.linalg.eigvalsh(M)
        assert (int(pos[c]), int(neg[c]), int(zero[c])) == (
            int((ev > 0).sum()), int((ev < 0).sum()), 0
        )


@pytest.mark.parametrize("K,w", [(7, 3), (9, 4)])
def test_twin_matches_pallas_interpret(K, w):
    """The TPU kernels K1/K2 in interpret mode agree with the twin to the
    double-float precision of their arithmetic."""
    D, E, b = _random_system(K, w, seed=K)
    fac, x = _twin(D, E, b)
    pfac = pb.pallas_banded_factor(jnp.asarray(D), jnp.asarray(E))
    xp = np.asarray(pb.pallas_banded_solve(pfac, jnp.asarray(b)))
    assert _rel(x, xp) <= 1e-10
    d = np.asarray(pb.pallas_pivots(pfac))
    assert int((d > EPS).sum()) == int((fac.d > EPS).sum())
    assert int((d < -EPS).sum()) == int((fac.d < -EPS).sum())
    np.testing.assert_array_equal(np.asarray(pfac.perm), fac.perm[0].numpy())


def test_wrappers_run_the_twin_on_cpu_tensors():
    cuda_banded.reset_counters()
    D, E, b = _random_system(7, 3)
    Dt, Et, bt = banded_system_from_numpy(D, E, b, "cpu")
    fac = cuda_banded.banded_factor(Dt, Et)
    x = cuda_banded.banded_solve(fac, bt)
    ref = tbt.block_tridiag_factor(Dt, Et)
    for a, r in zip(fac, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    torch.testing.assert_close(x, tbt.block_tridiag_solve(ref, bt), rtol=0, atol=0)
    assert cuda_banded.FACTOR_LAUNCHES == 0
    assert cuda_banded.SOLVE_LAUNCHES == 0


def _matvec(D, E, x):
    """The block-tridiagonal matrix times x (K, w)."""
    y = np.einsum("kij,kj->ki", D, x)
    y[1:] += np.einsum("kij,kj->ki", E, x[:-1])
    y[:-1] += np.einsum("kji,kj->ki", E, x[1:])
    return y


def test_twin_matches_jax_scan_at_a_long_horizon():
    """K=5001, w=3 (the flywheel at N=5000: 15,003 stage rows, where the
    TPU takes its chunked kernels): the twin against the JAX package's
    scan, inertia exactly and solutions to 1e-10."""
    D, E, b = _random_system(5001, 3, seed=5001)
    fac, x = _twin(D, E, b)
    jfac = jbt.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    xj = np.asarray(jbt.block_tridiag_solve(jfac, jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-10
    assert [int(t[0]) for t in tbt.block_tridiag_inertia(fac, EPS)] == [
        int(v) for v in jbt.block_tridiag_inertia(jfac, EPS)
    ]
    assert _rel(_matvec(D, E, x), b) <= 1e-10


def test_twin_matches_chunked_pallas_interpret():
    """The TPU's chunked kernels K3a/K3b in interpret mode, forced into
    three chunks as tests/ops/test_pallas_banded.py does it (K=150, w=4):
    inertia exactly, and their solution after two refinement passes
    against the exact matvec within 1e-10 of the twin's."""
    rng = np.random.default_rng(11)
    K, w = 150, 4
    D = rng.standard_normal((K, w, w))
    D = D + np.swapaxes(D, 1, 2) + 10 * np.eye(w)
    D[::4] -= 18 * np.eye(w)
    E = rng.standard_normal((K - 1, w, w))
    b = rng.standard_normal((K, w))
    fac, x = _twin(D, E, b)

    old_max, old_chunk = pb._SINGLE_SHOT_MAX_BYTES, pb._CHUNK
    pb._SINGLE_SHOT_MAX_BYTES, pb._CHUNK = 1, 64
    jax.clear_caches()
    try:
        assert pb.pallas_is_chunked(K, w)
        pfac = pb.pallas_banded_factor(jnp.asarray(D), jnp.asarray(E))
        assert pfac.LUh.shape[0] == 192  # three chunks of 64, padded
        xp = np.asarray(pb.pallas_banded_solve(pfac, jnp.asarray(b)))
        for _ in range(2):
            r = b - _matvec(D, E, xp)
            xp = xp + np.asarray(pb.pallas_banded_solve(pfac, jnp.asarray(r)))
        d = np.asarray(pb.pallas_pivots(pfac))
    finally:
        pb._SINGLE_SHOT_MAX_BYTES, pb._CHUNK = old_max, old_chunk
        jax.clear_caches()
    assert _rel(x, xp) <= 1e-10
    assert int((d > EPS).sum()) == int((fac.d > EPS).sum())
    assert int((d < -EPS).sum()) == int((fac.d < -EPS).sum())
