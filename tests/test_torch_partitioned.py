"""The port's partitioned (SPIKE/Schur) block-tridiagonal factor, the
plain twin of `banded_factor_part`, against the JAX package's
`block_tridiag_factor_part`/`block_tridiag_solve_part`/`part_inertia`
(sleipnir_tpu/ops/block_tridiag.py:293-524), a dense numpy solve and
eigvalsh, on the systems of tests/solver/test_partitioned.py plus a
batch of three at a K that L does not divide. The port condenses each
part with two block columns (the form of the time-axis split) where the
JAX package scans its fill-in; both give the same reduced system."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sleipnir_tpu.ops import block_tridiag as jbt
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


def _system(B, K, w, seed=42):
    """tests/solver/test_partitioned.py's indefinite systems, batched."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 10 * np.eye(w)
    D[:, ::3] -= 18 * np.eye(w)
    E = rng.standard_normal((B, K - 1, w, w))
    return D, E, rng.standard_normal((B, K, w))


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


#: (B, K, w): the JAX package's four systems, and a batch of three at
#: K=77, which L=9 does not divide (4 identity blocks pad the last part).
CASES = [(1, 50, 3), (1, 64, 5), (1, 101, 13), (1, 1000, 9), (3, 77, 4)]


@pytest.mark.parametrize("B,K,w", CASES)
def test_twin_matches_jax_partitioned_and_dense(B, K, w):
    D, E, b = _system(B, K, w)
    fac = tbt.block_tridiag_factor_part(torch.tensor(D), torch.tensor(E))
    assert isinstance(fac, tbt.PartitionedFactor)
    x = tbt.block_tridiag_solve_part(fac, torch.tensor(b)).numpy()
    # Several right-hand sides at once: the same solution column by column.
    xr = tbt.block_tridiag_solve_part(fac, torch.tensor(np.stack([b, -2 * b], -1))).numpy()
    pos, neg, zero = (t.tolist() for t in tbt.part_inertia(fac, EPS, K))
    P, L = tbt.choose_partitions(K)
    assert (P, L) == jbt._choose_partitions(K)
    assert fac.cols.shape == (B, P, L - 1, w, 2 * w)
    solve_j = jax.jit(jbt.block_tridiag_solve_part)
    for i in range(B):
        fj = jbt.block_tridiag_factor_part(jnp.asarray(D[i]), jnp.asarray(E[i]))
        xj = np.asarray(solve_j(fj, jnp.asarray(b[i])))
        assert _rel(x[i], xj) < 1e-10
        assert _rel(xr[i, ..., 1], -2 * xj) < 1e-10
        jpos, jneg, jzero = (int(t) for t in jbt.part_inertia(fj, EPS))
        assert (pos[i], neg[i], zero[i]) == (jpos, jneg, jzero)
        if K * w <= 2000:
            M = _dense(D[i], E[i])
            assert _rel(x[i].reshape(-1), np.linalg.solve(M, b[i].reshape(-1))) < 1e-10
            ev = np.linalg.eigvalsh(M)
            assert (pos[i], neg[i], zero[i]) == (int((ev > 0).sum()), int((ev < 0).sum()), 0)
        else:
            # At K·w = 9000 the sequential chain stands in for the dense
            # solve and eigvalsh: its solution and its pivots' inertia.
            chain = tbt.block_tridiag_factor(torch.tensor(D[i:i + 1]), torch.tensor(E[i:i + 1]))
            xc = tbt.block_tridiag_solve(chain, torch.tensor(b[i:i + 1]))[0].numpy()
            assert _rel(x[i], xc) < 1e-10
            assert [t.item() for t in tbt.block_tridiag_inertia(chain, EPS)] == [
                pos[i], neg[i], zero[i]]


def test_interior_pivots_are_the_jax_packages():
    """The parts' interior chains are K1's chains: their pivots are the
    JAX package's int_d, part by part."""
    K, w = 101, 5
    D, E, _b = _system(1, K, w, seed=3)
    fac = tbt.block_tridiag_factor_part(torch.tensor(D), torch.tensor(E))
    fj = jbt.block_tridiag_factor_part(jnp.asarray(D[0]), jnp.asarray(E[0]))
    int_d = np.swapaxes(np.asarray(fj.int_d), 0, 1)  # (P, L-1, w)
    np.testing.assert_allclose(fac.interior.d[0].numpy(), int_d, rtol=1e-12, atol=1e-12)


def test_recursion_depth():
    """K=1000 takes about 32 parts of 32 blocks, and its 32-block reduced
    system the sequential chain, as in the JAX package
    (tests/solver/test_partitioned.py:55-64); K=2400 takes 49 parts, so
    its reduced system is partitioned again."""
    rng = np.random.default_rng(0)
    for K, w, nested in ((1000, 4, False), (2400, 2, True)):
        D = rng.standard_normal((1, K, w, w))
        D = D + np.swapaxes(D, 2, 3) + 8 * np.eye(w)
        E = 0.1 * rng.standard_normal((1, K - 1, w, w))
        fac = tbt.block_tridiag_factor_part(torch.tensor(D), torch.tensor(E))
        assert isinstance(fac, tbt.PartitionedFactor)
        if nested:
            assert isinstance(fac.red, tbt.PartitionedFactor)
            assert isinstance(fac.red.red, tbt.BlockTridiagFactor)
        else:
            assert isinstance(fac.red, tbt.BlockTridiagFactor)
            fj = jbt.block_tridiag_factor_part(jnp.asarray(D[0]), jnp.asarray(E[0]))
            assert isinstance(fj.red, jbt.BlockTridiagFactor)
            assert fac.red.d.shape[1] == fj.red.d.shape[0]
    # Below PART_MIN_BLOCKS the chain's own factor comes back.
    D, E, _b = _system(1, 40, 3)
    assert isinstance(tbt.block_tridiag_factor_part(torch.tensor(D), torch.tensor(E)),
                      tbt.BlockTridiagFactor)


def test_float32_within_1e_4():
    """A float32 factor and solve against the float64 one, on stages whose
    eigenvalues keep away from zero."""
    rng = np.random.default_rng(5)
    B, K, w = 2, 300, 4
    Q, _ = np.linalg.qr(rng.standard_normal((B, K, w, w)))
    lam = rng.choice([-1.0, 1.0], (B, K, w)) * rng.uniform(20.0, 40.0, (B, K, w))
    D = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    D = 0.5 * (D + np.swapaxes(D, 2, 3))
    E = 0.5 * rng.standard_normal((B, K - 1, w, w))
    b = rng.standard_normal((B, K, w))
    x64 = tbt.block_tridiag_solve_part(
        tbt.block_tridiag_factor_part(torch.tensor(D), torch.tensor(E)), torch.tensor(b))
    f32 = tbt.block_tridiag_factor_part(torch.tensor(D, dtype=torch.float32),
                                        torch.tensor(E, dtype=torch.float32))
    x32 = tbt.block_tridiag_solve_part(f32, torch.tensor(b, dtype=torch.float32))
    assert x32.dtype == torch.float32
    assert _rel(x32.double().numpy(), x64.numpy()) < 1e-4
    pos, neg, zero = tbt.part_inertia(f32, 2e-5, K)
    assert pos.tolist() == [int((lam[i] > 0).sum()) for i in range(B)]
    assert zero.tolist() == [0, 0]


def test_wrappers_run_the_twin_on_the_cpu():
    """On CPU tensors `banded_factor_part`/`banded_solve_part` run the
    twin through K1/K2's CPU side, and count the outer shape and the
    inner calls."""
    B, K, w = 2, 256, 3
    D, E, b = (torch.tensor(a) for a in _system(B, K, w))
    cuda_banded.reset_counters()
    fac = cuda_banded.banded_factor_part(D, E)
    x = cuda_banded.banded_solve_part(fac, b)
    ref = tbt.block_tridiag_solve_part(tbt.block_tridiag_factor_part(D, E), b)
    assert torch.equal(x, ref)
    P, L = tbt.choose_partitions(K)  # 16 parts of 16 blocks
    assert cuda_banded.PARTITIONED_BY_SHAPE == {("factor", B, K, w): 1, ("solve", B, K, w): 1}
    assert cuda_banded.PLAIN_BY_SHAPE == {
        ("factor", B * P, L - 1, w): 1, ("solve", B * P, L - 1, w): 2, ("factor", B, P, w): 1,
        ("solve", B, P, w): 1,
    }
    assert cuda_banded.PARTITIONED_LAUNCHES == {("factor", B, K, w): 3, ("solve", B, K, w): 2}
    assert cuda_banded.FACTOR_LAUNCHES == cuda_banded.SOLVE_LAUNCHES == 0
