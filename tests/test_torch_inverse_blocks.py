"""The port's explicit-inverse factors (`_inv_pivots`, the chain
`block_tridiag_factor_inv`/`block_tridiag_solve_inv` and the partitioned
`block_tridiag_factor_part_inv`/`block_tridiag_solve_part_inv`, with
`inv_part_inertia` and `inv_part_pivots`) against the JAX package's
(sleipnir_tpu/ops/block_tridiag.py:552-914) on the inputs of
tests/solver/test_inverse_blocks.py: solutions and pivots within 1e-9
relative (that test's bound against the dense solve), inertia exactly.
A batch of three equals per-system calls, several right-hand sides equal
one column at a time, and float32 agrees with float64 within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sleipnir_tpu.ops import block_tridiag as jbt
from sleipnir_tpu_torch.ops import block_tridiag as tbt

torch.set_num_threads(1)

#: Pivot zero-threshold of the JAX test's inertia count.
EPS = 1e-12
TOL = 1e-9


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def _system(B, K, w, seed=42):
    """tests/solver/test_inverse_blocks.py's indefinite systems; B=1 gives
    its very numbers."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 10 * np.eye(w)
    D[:, ::3] -= 18 * np.eye(w)
    E = rng.standard_normal((B, K - 1, w, w))
    return D, E, rng.standard_normal((B, K, w))


def _pivots(pivots) -> np.ndarray:
    return np.concatenate([np.asarray(p).ravel() for p in pivots])


def _check_against_jax(fac, D, E, b, K):
    """The port's factor of the batch against the JAX package's per
    system: solution, pivots and inertia."""
    x = tbt.block_tridiag_solve_part_inv(fac, torch.tensor(b)).numpy()
    inertia = [t.tolist() for t in tbt.inv_part_inertia(fac, EPS, K)]
    pivots = torch.cat(tbt.inv_part_pivots(fac), dim=1).numpy()
    solve_j = jax.jit(jbt.block_tridiag_solve_part_inv)
    for i in range(D.shape[0]):
        fj = jbt.block_tridiag_factor_part_inv(jnp.asarray(D[i]), jnp.asarray(E[i]))
        assert type(fac).__name__ == type(fj).__name__
        xj = np.asarray(solve_j(fj, jnp.asarray(b[i])))
        assert _rel(x[i], xj) < TOL
        pj = _pivots(jbt.inv_part_pivots(fj))
        assert pivots[i].shape == pj.shape and _rel(pivots[i], pj) < TOL
        assert [v[i] for v in inertia] == [int(t) for t in jbt.inv_part_inertia(fj, EPS)]


@pytest.mark.parametrize("w", [1, 2, 3, 5, 13])
def test_inv_pivots_match_jax(w):
    """The adjugate for w ≤ 3, the sweep beyond, one Newton polish."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((w, w))
    A = A + A.T + 4.0 * np.eye(w)
    if w >= 3:
        A[1, 1] -= 9.0  # indefinite
    Tj, dj = jax.jit(jbt._inv_pivots)(jnp.asarray(A))
    T, d = tbt._inv_pivots(torch.tensor(A))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0, atol=1e-11)
    assert _rel(d.numpy(), np.asarray(dj)) < TOL
    np.testing.assert_allclose(T.numpy(), np.linalg.inv(A), rtol=0, atol=1e-11)
    # A batch of the block and its negative: each agrees with its own call.
    Tb, db = tbt._inv_pivots(torch.tensor(np.stack([A, -A])))
    Tn, dn = tbt._inv_pivots(torch.tensor(-A))
    for got, want in ((Tb[0], T), (db[0], d), (Tb[1], Tn), (db[1], dn)):
        assert _rel(got.numpy(), want.numpy()) < TOL


@pytest.mark.parametrize("K,w", [(5, 3), (23, 4), (101, 13)])
def test_chain_matches_jax(K, w):
    D, E, b = _system(1, K, w)
    fac = tbt.block_tridiag_factor_inv(torch.tensor(D), torch.tensor(E))
    assert fac.T.shape == (1, K, w, w) and fac.W.shape == (1, K - 1, w, w)
    x = tbt.block_tridiag_solve_inv(fac, torch.tensor(b)).numpy()
    fj = jax.jit(jbt.block_tridiag_factor_inv)(jnp.asarray(D[0]), jnp.asarray(E[0]))
    xj = np.asarray(jax.jit(jbt.block_tridiag_solve_inv)(fj, jnp.asarray(b[0])))
    assert _rel(x[0], xj) < TOL
    assert _rel(fac.d[0].numpy(), np.asarray(fj.d)) < TOL
    pos, neg, zero = (t.tolist() for t in tbt.inv_part_inertia(fac, EPS, K))
    assert (pos[0], neg[0], zero[0]) == tuple(int(t) for t in jbt.inv_part_inertia(fj, EPS))


@pytest.mark.parametrize("K,w", [(50, 3), (64, 5), (101, 13), (1000, 9)])
def test_partitioned_matches_jax(K, w):
    D, E, b = _system(1, K, w)
    fac = tbt.block_tridiag_factor_part_inv(torch.tensor(D), torch.tensor(E))
    assert isinstance(fac, tbt.PartitionedFactorInv)
    P, L = tbt.choose_partitions_inv(K)
    assert (P, L) == jbt._choose_partitions_inv(K)
    assert fac.int_T.shape == (1, L - 1, P, w, w)
    _check_against_jax(fac, D, E, b, K)


def test_multilevel_recursion_matches_jax():
    """K=5000 at w=3: the reduced system of 157 blocks partitions again,
    and the 13 blocks below it take the chain (the JAX test's system)."""
    rng = np.random.default_rng(0)
    K, w = 5000, 3
    D = rng.standard_normal((K, w, w))
    D = D + np.swapaxes(D, 1, 2) + 8 * np.eye(w)
    E = 0.1 * rng.standard_normal((K - 1, w, w))
    b = rng.standard_normal((K, w))
    fac = tbt.block_tridiag_factor_part_inv(torch.tensor(D[None]), torch.tensor(E[None]))
    assert isinstance(fac.red, tbt.PartitionedFactorInv)
    assert isinstance(fac.red.red, tbt.BlockTridiagFactorInv)
    _check_against_jax(fac, D[None], E[None], b[None], K)
    x = tbt.block_tridiag_solve_part_inv(fac, torch.tensor(b[None])).numpy()[0]
    r = np.einsum("kab,kb->ka", D, x)
    r[1:] += np.einsum("kab,kb->ka", E, x[:-1])
    r[:-1] += np.einsum("kba,kb->ka", E, x[1:])
    assert np.abs(r - b).max() / np.abs(b).max() < 1e-8


@pytest.mark.parametrize("K,w", [(23, 4), (77, 4), (101, 13)])
def test_batch_equals_per_system_calls(K, w):
    """B=3 through one call (the ladder's candidates, the lanes' systems)
    against one call per system, with r = 2w right-hand sides against
    one column at a time, and each system's inertia against the JAX
    package's."""
    D, E, b = _system(3, K, w, seed=7)
    fac = tbt.block_tridiag_factor_part_inv(torch.tensor(D), torch.tensor(E))
    rhs = np.random.default_rng(8).standard_normal((3, K, w, 2 * w))
    X = tbt.block_tridiag_solve_part_inv(fac, torch.tensor(rhs)).numpy()
    inertia = [t.tolist() for t in tbt.inv_part_inertia(fac, EPS, K)]
    pivots = torch.cat(tbt.inv_part_pivots(fac), dim=1).numpy()
    for i in range(3):
        fi = tbt.block_tridiag_factor_part_inv(torch.tensor(D[i:i + 1]), torch.tensor(E[i:i + 1]))
        for j in range(0, 2 * w, 5):
            xj = tbt.block_tridiag_solve_part_inv(fi, torch.tensor(rhs[i:i + 1, ..., j])).numpy()
            assert _rel(X[i, ..., j], xj[0]) < TOL
        assert _rel(pivots[i], torch.cat(tbt.inv_part_pivots(fi), dim=1).numpy()[0]) < TOL
        assert [v[i] for v in inertia] == [v[0] for v in (t.tolist() for t in
                                                          tbt.inv_part_inertia(fi, EPS, K))]
        fj = jbt.block_tridiag_factor_part_inv(jnp.asarray(D[i]), jnp.asarray(E[i]))
        assert [v[i] for v in inertia] == [int(t) for t in jbt.inv_part_inertia(fj, EPS)]


@pytest.mark.parametrize("K,w", [(23, 4), (101, 13)])
def test_float32_within_1e4_of_jax(K, w):
    """Well-conditioned stages in float32, in the solve's dtype
    throughout, against the JAX package's float64 solve; the inertia
    equals the JAX package's."""
    rng = np.random.default_rng(5)
    D = rng.standard_normal((2, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 30 * np.eye(w)
    D[:, ::2] -= 60 * np.eye(w)
    E = rng.standard_normal((2, K - 1, w, w))
    b = rng.standard_normal((2, K, w))
    f32 = tbt.block_tridiag_factor_part_inv(torch.tensor(D, dtype=torch.float32),
                                            torch.tensor(E, dtype=torch.float32))
    x32 = tbt.block_tridiag_solve_part_inv(f32, torch.tensor(b, dtype=torch.float32))
    assert x32.dtype == torch.float32
    inertia = [t.tolist() for t in tbt.inv_part_inertia(f32, 1e-5, K)]
    for i in range(2):
        fj = jbt.block_tridiag_factor_part_inv(jnp.asarray(D[i]), jnp.asarray(E[i]))
        xj = np.asarray(jbt.block_tridiag_solve_part_inv(fj, jnp.asarray(b[i])))
        assert _rel(x32[i].double().numpy(), xj) < 1e-4
        assert [v[i] for v in inertia] == [int(t) for t in jbt.inv_part_inertia(fj, EPS)]


def test_zero_pivot_is_graceful():
    """A singular block gives finite output and a zero pivot, not NaNs,
    in both packages."""
    A = np.diag([1.0, 0.0, 2.0, 3.0])
    T, d = tbt._inv_pivots_sweep(torch.tensor(A))
    Tj, dj = jbt._inv_pivots_sweep(jnp.asarray(A))
    assert torch.isfinite(T).all() and abs(float(d[1])) < 1e-12
    np.testing.assert_array_equal(T.numpy(), np.asarray(Tj))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    for w in (1, 2, 3):
        T, d = tbt._inv_pivots(torch.zeros(w, w, dtype=torch.float64))
        assert torch.isfinite(T).all() and torch.isfinite(d).all()
