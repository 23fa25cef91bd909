"""The port's block cyclic reduction (`bcr_factor`, `bcr_solve`,
`bcr_inertia`) against the JAX package's (sleipnir_tpu/ops/block_tridiag.py:
916-1066) on the systems of tests/solver/test_block_tridiag.py:71-150:
solutions within 1e-10 relative (that test's bound against the chain),
inertia exactly, at K = 1, 2 and counts that are not 2^L + 1. A batch of
three equals per-system calls, several right-hand sides equal one column
at a time, the coarsest system goes through the factor and solve it is
given, and float32 agrees with the JAX package's float64 within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sleipnir_tpu.ops import block_tridiag as jbt
from sleipnir_tpu_torch.ops import block_tridiag as tbt
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.optimization.solver.kkt_backend import take

torch.set_num_threads(1)

TOL = 1e-10
EPS = float(np.finfo(np.float64).eps)

#: tests/solver/test_block_tridiag.py's sizes: non-powers of 2 and the
#: 1-, 2- and 3-block edges.
SIZES = [(1, 3), (2, 2), (3, 4), (5, 3), (8, 2), (13, 5), (33, 3)]


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def _random(rng, B, K, w, shift=0.0):
    """test_block_tridiag.py's `random_block_tridiag(definite=True)`,
    batched, with its spectrum shifted by −shift for indefinite cases."""
    D = rng.standard_normal((B, K, w, w))
    D = (D + np.swapaxes(D, 2, 3)) / 2 + (w + 2 - shift) * np.eye(w)
    E = rng.standard_normal((B, max(K - 1, 0), w, w)) * 0.3
    return D, E


def _kkt_like(rng, K, m, p):
    """test_block_tridiag.py's saddle-point system shaped like an OCP's
    reduced KKT matrix: [H_k, A_kᵀ; A_k, −γI] with dynamics coupling."""
    w = m + p
    D = np.zeros((1, K, w, w))
    E = np.zeros((1, K - 1, w, w))
    for k in range(K):
        H = rng.standard_normal((m, m))
        A = rng.standard_normal((p, m))
        D[0, k, :m, :m] = H @ H.T + 0.5 * np.eye(m)
        D[0, k, m:, :m] = A
        D[0, k, :m, m:] = A.T
        D[0, k, m:, m:] = -1e-8 * np.eye(p)
    for k in range(K - 1):
        E[0, k, :m, m:] = rng.standard_normal((m, p))
    return D, E


_bcr_factor_j = jax.jit(jbt.bcr_factor)
_bcr_solve_j = jax.jit(jbt.bcr_solve)


def _jax(D, E, b, K):
    """The JAX package's BCR solution and inertia of one system."""
    fj = _bcr_factor_j(jnp.asarray(D), jnp.asarray(E))
    xj = np.asarray(_bcr_solve_j(fj, jnp.asarray(b)))
    return xj, [int(t) for t in jbt.bcr_inertia(fj, EPS, K)], fj


@pytest.mark.parametrize("K,w", SIZES)
@pytest.mark.parametrize("shift", [0.0, 2.0], ids=["definite", "indefinite"])
def test_bcr_matches_jax(K, w, shift):
    """Definite and indefinite (spectrum shifted by 2(w+2)) systems: the
    same solution and inertia as the JAX package's BCR, and the same
    pivots level by level."""
    rng = np.random.default_rng(K * 100 + w)
    D, E = _random(rng, 1, K, w, shift * (w + 2))
    b = rng.standard_normal((1, K, w))
    fac = tbt.bcr_factor(torch.tensor(D), torch.tensor(E))
    x = tbt.bcr_solve(fac, torch.tensor(b)).numpy()
    xj, ij, fj = _jax(D[0], E[0], b[0], K)
    assert _rel(x[0], xj) < TOL
    assert [t.tolist()[0] for t in tbt.bcr_inertia(fac, EPS, K)] == ij
    assert len(fac.levels) == len(fj.levels)
    pivots = tbt.bcr_pivots(fac)
    pj = [fj.final.d] + [lv.do for lv in fj.levels]
    for p, q in zip(pivots, pj):
        assert _rel(p[0].numpy(), np.asarray(q).ravel()) < TOL


@pytest.mark.parametrize("K,m,p", [(4, 3, 2), (7, 2, 2), (16, 4, 3)])
def test_kkt_saddle_point_matches_jax(K, m, p):
    """The shape the interior-point method factors: exactly K·p negative
    pivots, as the JAX package and eigvalsh count."""
    rng = np.random.default_rng(K * m + p)
    D, E = _kkt_like(rng, K, m, p)
    b = rng.standard_normal((1, K, m + p))
    fac = tbt.bcr_factor(torch.tensor(D), torch.tensor(E))
    x = tbt.bcr_solve(fac, torch.tensor(b)).numpy()
    xj, ij, _ = _jax(D[0], E[0], b[0], K)
    assert _rel(x[0], xj) < 1e-7  # that test's bound on this system
    assert [t.tolist()[0] for t in tbt.bcr_inertia(fac, EPS, K)] == ij == [K * m, K * p, 0]


@pytest.mark.parametrize("K", [3, 4, 6, 9, 17, 40, 101])
def test_bcr_matches_the_chain(K):
    """BCR against the chain, the plain twin of K1/K2, which
    tests/test_torch_banded.py holds against the JAX package's block-Thomas
    solve (the systems of test_block_tridiag.py:143-151), with the chain's
    inertia."""
    rng = np.random.default_rng(7 + K)
    D, E = _random(rng, 1, K, 3)
    b = rng.standard_normal((1, K, 3))
    Dt, Et, bt = torch.tensor(D), torch.tensor(E), torch.tensor(b)
    fac = tbt.bcr_factor(Dt, Et)
    x = tbt.bcr_solve(fac, bt).numpy()
    chain = tbt.block_tridiag_factor(Dt, Et)
    assert _rel(x, tbt.block_tridiag_solve(chain, bt).numpy()) < TOL
    assert ([t.tolist() for t in tbt.bcr_inertia(fac, EPS, K)]
            == [t.tolist() for t in tbt.block_tridiag_inertia(chain, EPS)])


@pytest.mark.parametrize("K,w", [(2, 4), (13, 5), (101, 13)])
def test_batch_and_columns_equal_single_calls(K, w):
    """B=3 through one call against one call per system, r = 2w
    right-hand sides against one column at a time, and each system's
    inertia against the JAX package's."""
    rng = np.random.default_rng(K + w)
    D, E = _random(rng, 3, K, w, 1.5 * (w + 2))
    rhs = rng.standard_normal((3, K, w, 2 * w))
    fac = tbt.bcr_factor(torch.tensor(D), torch.tensor(E))
    X = tbt.bcr_solve(fac, torch.tensor(rhs)).numpy()
    inertia = [t.tolist() for t in tbt.bcr_inertia(fac, EPS, K)]
    for i in range(3):
        fi = tbt.bcr_factor(torch.tensor(D[i:i + 1]), torch.tensor(E[i:i + 1]))
        for j in range(0, 2 * w, 3):
            xi = tbt.bcr_solve(fi, torch.tensor(rhs[i:i + 1, ..., j])).numpy()[0]
            assert _rel(X[i, ..., j], xi) < TOL
        xj, ij, _ = _jax(D[i], E[i], rhs[i, ..., 0], K)
        assert _rel(X[i, ..., 0], xj) < TOL
        assert [v[i] for v in inertia] == ij


def test_coarsest_system_takes_the_given_factor():
    """`bcr_factor`/`bcr_solve` hand the coarsest two blocks to the factor
    and solve they are given: K1/K2's wrappers, whose plain twin runs on
    CPU tensors, at (B, 2, w)."""
    rng = np.random.default_rng(3)
    D, E = _random(rng, 4, 101, 13)
    b = rng.standard_normal((1, 101, 13))
    cuda_banded.reset_counters()
    fac = tbt.bcr_factor(torch.tensor(D), torch.tensor(E), cuda_banded.banded_factor)
    # The ladder's pick: candidate 0 of the batch, as the backend takes it.
    x = tbt.bcr_solve(take(fac, 0), torch.tensor(b), cuda_banded.banded_solve).numpy()
    assert dict(cuda_banded.PLAIN_BY_SHAPE) == {("factor", 4, 2, 13): 1, ("solve", 1, 2, 13): 1}
    xj, _, _ = _jax(D[0], E[0], b[0], 101)
    assert _rel(x[0], xj) < TOL
    assert len(fac.levels) == 7  # 101 blocks pad to 2^7 + 1 = 129


@pytest.mark.parametrize("K,w", [(13, 5), (101, 13)])
def test_float32_within_1e4_of_jax(K, w):
    """The definite systems, whose condition keeps float32's rounding
    within 1e-4, in the solve's dtype throughout."""
    rng = np.random.default_rng(11)
    D, E = _random(rng, 2, K, w)
    b = rng.standard_normal((2, K, w))
    f32 = tbt.bcr_factor(torch.tensor(D, dtype=torch.float32),
                         torch.tensor(E, dtype=torch.float32))
    x32 = tbt.bcr_solve(f32, torch.tensor(b, dtype=torch.float32))
    assert x32.dtype == torch.float32
    inertia = [t.tolist() for t in tbt.bcr_inertia(f32, 1e-5, K)]
    for i in range(2):
        xj, ij, _ = _jax(D[i], E[i], b[i], K)
        assert _rel(x32[i].double().numpy(), xj) < 1e-4
        assert [v[i] for v in inertia] == ij
