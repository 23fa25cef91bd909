"""The Hopper kernels against their plain torch versions on the card: the
block-tridiagonal factor and solve (K1/K2, which also stand for the TPU's
chunked K3a/K3b at long horizons) and the double-float probe (P).

Needs a CUDA card (the kernels have no CPU mode); every case skips
without one. This file imports no JAX, so it also runs where only torch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sleipnir_tpu_torch.interop import banded_system_from_numpy
from sleipnir_tpu_torch.ops import block_tridiag as tbt
from sleipnir_tpu_torch.ops import cuda_banded, cuda_dd_probe
from sleipnir_tpu_torch.ops import dd as plain_dd
from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _random_system(rng, B, K, w, r):
    D = rng.standard_normal((B, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 10 * np.eye(w)
    D[:, ::3] -= 18 * np.eye(w)
    E = rng.standard_normal((B, K - 1, w, w))
    b = rng.standard_normal((B, K, w) if r is None else (B, K, w, r))
    return D, E, b


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,K,w,r",
    [
        (4, 101, 13, None), (1, 101, 13, 3), (2, 40, 37, None), (1, 7, 3, None), (3, 1, 4, None),
        # The batched solve's shapes at 8 lanes: K1 over all ladders, K2
        # over the lanes' step systems.
        (32, 101, 13, None), (8, 101, 13, None),
    ],
)
def test_kernels_match_twin_on_card(cuda_device, B, K, w, r):
    D, E, b = _random_system(np.random.default_rng(B * K + w), B, K, w, r)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    before = cuda_banded.FACTOR_LAUNCHES, cuda_banded.SOLVE_LAUNCHES
    fk = cuda_banded.banded_factor(Dg, Eg)
    xk = cuda_banded.banded_solve(fk, bg)
    torch.cuda.synchronize()
    assert (cuda_banded.FACTOR_LAUNCHES, cuda_banded.SOLVE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    fp = tbt.block_tridiag_factor(Dg, Eg)
    xp = tbt.block_tridiag_solve(fp, bg)
    assert ((xk - xp).abs().max() / xp.abs().max()).item() <= 1e-10
    for a, c in zip(tbt.block_tridiag_inertia(fk, EPS_INERTIA), tbt.block_tridiag_inertia(fp, EPS_INERTIA)):
        assert torch.equal(a, c)
    assert torch.equal(fk.perm, fp.perm)


def _rels(fk, fp, bg):
    """Unrefined relative differences from the plain solution: both kernels,
    K1 alone (the plain solve on its factor), K2 alone (on the plain
    factor)."""
    xp = tbt.block_tridiag_solve(fp, bg)
    return (_rel(cuda_banded.banded_solve(fk, bg), xp), _rel(tbt.block_tridiag_solve(fk, bg), xp),
            _rel(cuda_banded.banded_solve(fp, bg), xp))


def _assert_inertia_equal(fk, fp):
    for a, c in zip(tbt.block_tridiag_inertia(fk, EPS_INERTIA), tbt.block_tridiag_inertia(fp, EPS_INERTIA)):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("w", [1, 5, 6, 31, 32, 33, 37])
def test_kernels_match_twin_at_width_edges(cuda_device, B, w):
    """The edges of the kernels' width classes: one row per lane up to
    w=32, two rows per lane beyond; a butterfly of 1 to 32 lanes. On
    well-conditioned stages: random stages 31 to 37 wide amplify rounding
    past 1e-10 even over 9 stages."""
    D, E, b = _conditioned_system(np.random.default_rng(100 + w), B, 9, w)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    before = cuda_banded.FACTOR_LAUNCHES, cuda_banded.SOLVE_LAUNCHES
    fk = cuda_banded.banded_factor(Dg, Eg)
    assert (cuda_banded.FACTOR_LAUNCHES, cuda_banded.SOLVE_LAUNCHES) == (before[0] + 1, before[1])
    cuda_banded.banded_solve(fk, bg)
    torch.cuda.synchronize()
    assert (cuda_banded.FACTOR_LAUNCHES, cuda_banded.SOLVE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    fp = tbt.block_tridiag_factor(Dg, Eg)
    assert max(_rels(fk, fp, bg)) <= 1e-10
    _assert_inertia_equal(fk, fp)
    assert torch.equal(fk.perm, fp.perm)


def _tie_system(rng, B, K, w):
    """S_0 and S_3 have a tie in column 0: rows 2 and 4 hold ±7, the
    largest |entry|. E_2 = 0, so S_3 = D_3 exactly."""
    D, E, b = _random_system(rng, B, K, w, None)
    for k in (0, 3):
        D[:, k, :, 0] = D[:, k, 0, :] = 0.5
        D[:, k, 0, 0] = 1.0
        D[:, k, 2, 0] = D[:, k, 0, 2] = 7.0
        D[:, k, 4, 0] = D[:, k, 0, 4] = -7.0
    E[:, 2] = 0.0
    return D, E, b


@pytest.mark.cuda
@pytest.mark.parametrize("w", [5, 13, 33])
def test_tie_column_takes_the_first_row(cuda_device, w):
    D, E, b = _tie_system(np.random.default_rng(w), 2, 6, w)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    fk = cuda_banded.banded_factor(Dg, Eg)
    fp = tbt.block_tridiag_factor(Dg, Eg)
    assert fk.perm[:, 0, 0].tolist() == [2, 2] and fk.perm[:, 3, 0].tolist() == [2, 2]
    assert torch.equal(fk.perm, fp.perm)
    _assert_inertia_equal(fk, fp)
    assert max(_rels(fk, fp, bg)) <= 1e-10


@pytest.mark.cuda
def test_zero_pivot_column_is_kept_unscaled(cuda_device):
    """The last stage's S_k has an all-zero row and column 2, so its LU
    meets a zero pivot at column 2: the row at that position stays, nothing
    is scaled by it, the pivot d is 0 and the solve is not finite."""
    D, E, b = _random_system(np.random.default_rng(3), 2, 5, 6, None)
    D[:, 4, 2, :] = D[:, 4, :, 2] = 0.0
    E[:, 3] = 0.0
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    fk = cuda_banded.banded_factor(Dg, Eg)
    x = cuda_banded.banded_solve(fk, bg)
    torch.cuda.synchronize()
    fp = tbt.block_tridiag_factor(Dg, Eg)
    assert torch.equal(fk.perm, fp.perm)
    _assert_inertia_equal(fk, fp)
    assert tbt.block_tridiag_inertia(fk, EPS_INERTIA)[2].tolist() == [1, 1]
    assert fk.LU[:, 4, 2, 2].tolist() == [0.0, 0.0]
    assert torch.isfinite(fk.LU[:, :4]).all() and torch.isfinite(fk.X).all()
    assert not torch.isfinite(x).all()


@pytest.mark.cuda
def test_nan_in_d_gives_non_finite_pivots_and_returns(cuda_device):
    """A NaN in system 0's D_3: its inertia pivots come out non-finite (the
    ladder's `isfinite` check rejects it), the kernels return, and system 1
    of the same launch is untouched."""
    D, E, b = _random_system(np.random.default_rng(4), 2, 6, 5, None)
    D[0, 3, 1, 1] = np.nan
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    fk = cuda_banded.banded_factor(Dg, Eg)
    x = cuda_banded.banded_solve(fk, bg)
    torch.cuda.synchronize()
    assert torch.isfinite(fk.d).flatten(1).all(dim=1).tolist() == [False, True]
    assert not torch.isfinite(x[0]).all()
    fp = tbt.block_tridiag_factor(Dg[1:].contiguous(), Eg[1:].contiguous())
    f1 = tbt.BlockTridiagFactor(*(t[1:].contiguous() for t in fk))
    assert torch.equal(f1.perm, fp.perm)
    _assert_inertia_equal(f1, fp)
    assert max(_rels(f1, fp, bg[1:].contiguous())) <= 1e-10


def _conditioned_system(rng, B, K, w):
    """Stages Q diag(λ) Qᵀ with |λ| in [20, 40] of random sign, coupled by
    E = 0.5·randn: every Schur complement stays far from singular."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, K, w, w)))
    lam = rng.choice([-1.0, 1.0], (B, K, w)) * rng.uniform(20.0, 40.0, (B, K, w))
    D = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    D = 0.5 * (D + np.swapaxes(D, 2, 3))
    return D, 0.5 * rng.standard_normal((B, K - 1, w, w)), rng.standard_normal((B, K, w))


def _rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,K,w,conditioned",
    [(1, 5001, 3, False), (4, 5001, 4, False), (4, 1001, 13, False), (4, 2001, 37, True)],
)
def test_kernels_match_twin_at_long_horizons(cuda_device, B, K, w, conditioned):
    """Where the TPU takes its chunked kernels (K3a/K3b): the flywheel at
    N=5000 (its path factors (4, 5001, 4)), cart-pole at N=1000 and its
    restoration system at N=2000. Random 37-wide stages chained over 2001
    stages are so ill-conditioned that two correct f64 orderings differ
    near 1e-10, so that width takes well-conditioned stages. Each kernel
    is held alone and both together, unrefined."""
    if conditioned:
        D, E, b = _conditioned_system(np.random.default_rng(B * K + w), B, K, w)
    else:
        D, E, b = _random_system(np.random.default_rng(B * K + w), B, K, w, None)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    fk = cuda_banded.banded_factor(Dg, Eg)
    fp = tbt.block_tridiag_factor(Dg, Eg)
    xp = tbt.block_tridiag_solve(fp, bg)
    assert _rel(tbt.block_tridiag_solve(fk, bg), xp) <= 1e-10
    assert _rel(cuda_banded.banded_solve(fp, bg), xp) <= 1e-10
    assert _rel(cuda_banded.banded_solve(fk, bg), xp) <= 1e-10
    for a, c in zip(tbt.block_tridiag_inertia(fk, EPS_INERTIA), tbt.block_tridiag_inertia(fp, EPS_INERTIA)):
        assert torch.equal(a, c)
    assert torch.equal(fk.perm, fp.perm)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,w,r", [(4, 5001, 4, 1), (4, 101, 13, 2)])
def test_batched_multi_rhs_solve_at_the_border_shapes(cuda_device, B, K, w, r):
    """K2 over every ladder candidate with r right-hand sides each: the
    shape of the arrowhead border's T⁻¹·col (the minimum-time flywheel at
    N=5000 solves (4, 5001, 4) with its one border column), against the
    plain solve on the same factor, on the kernel factor and on the plain
    one, unrefined. One wrapper call launches it."""
    D, E, b = _random_system(np.random.default_rng(B * K + w + r), B, K, w, r)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    fk = cuda_banded.banded_factor(Dg, Eg)
    fp = tbt.block_tridiag_factor(Dg, Eg)
    before = cuda_banded.LAUNCHES_BY_SHAPE["solve", B, K, w]
    xk = cuda_banded.banded_solve(fk, bg)
    torch.cuda.synchronize()
    assert cuda_banded.LAUNCHES_BY_SHAPE["solve", B, K, w] == before + 1
    assert xk.shape == (B, K, w, r)
    assert _rel(xk, tbt.block_tridiag_solve(fk, bg)) <= 1e-10
    assert _rel(cuda_banded.banded_solve(fp, bg), tbt.block_tridiag_solve(fp, bg)) <= 1e-10


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    D, E, _ = _random_system(np.random.default_rng(0), 1, 5, 38, None)
    Dg, Eg, _ = banded_system_from_numpy(D, E, np.zeros((1, 5, 38)), cuda_device)
    with pytest.raises(ValueError, match="unsupported shape"):
        cuda_banded.banded_factor(Dg, Eg)
    with pytest.raises(ValueError, match="float64"):
        cuda_banded.banded_factor(Dg[..., :4, :4].float().contiguous(), Eg[..., :4, :4].float().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_banded.banded_factor(Dg[..., :4, :4], Eg[..., :4, :4])


@pytest.mark.cuda
def test_wrappers_reject_tensors_on_another_device(cuda_device):
    D, E, b = _random_system(np.random.default_rng(1), 1, 5, 4, None)
    Dg, Eg, bg = banded_system_from_numpy(D, E, b, cuda_device)
    with pytest.raises(ValueError, match="E must be on cuda"):
        cuda_banded.banded_factor(Dg, Eg.cpu())
    fac_cpu = tbt.block_tridiag_factor(Dg.cpu(), Eg.cpu())
    with pytest.raises(ValueError, match="LU must be on cuda"):
        cuda_banded.banded_solve(fac_cpu, bg)
    if torch.cuda.device_count() < 2:
        return
    other = torch.device("cuda", 1)
    with pytest.raises(ValueError, match="E must be on cuda:0"):
        cuda_banded.banded_factor(Dg, Eg.to(other))
    with pytest.raises(ValueError, match="LU must be on cuda:1"):
        cuda_banded.banded_solve(cuda_banded.banded_factor(Dg, Eg), bg.to(other))


@pytest.mark.cuda
def test_dd_probe_kernels_match_plain_bit_for_bit(cuda_device):
    from sleipnir_tpu_torch.tools import dd_probe

    x = dd_probe.probe_inputs(cuda_device)
    before = cuda_dd_probe.LAUNCHES
    out = dd_probe.run_probe(x, cuda_dd_probe.primitive, cuda_dd_probe.onehot_product)
    torch.cuda.synchronize()
    assert cuda_dd_probe.LAUNCHES == before + 6
    plain = dd_probe.run_probe(x, dd_probe.plain_primitive, plain_dd.onehot_product)
    assert dd_probe.bitwise_equal(out, plain), dd_probe.max_abs_diff(out, plain)
    lines = dict(dd_probe.error_lines(x, out))
    assert lines["two_sum max err"] == 0.0
    assert lines["two_prod max rel err"] == 0.0


@pytest.mark.cuda
def test_dd_probe_runs_in_one_launch_bit_for_bit(cuda_device):
    """The fused probe: one launch per run, every primitive equal to
    ops/dd.py bit for bit, the one-hot product equal to torch.matmul bit
    for bit (float32, TF32 off), and the single TF32 pass no better than
    X truncated to 11 bits allows."""
    from sleipnir_tpu_torch.tools import dd_probe

    x = dd_probe.probe_inputs(cuda_device)
    before = cuda_dd_probe.LAUNCHES
    out, single = dd_probe.run_fused(x)
    torch.cuda.synchronize()
    assert cuda_dd_probe.LAUNCHES == before + 1
    plain = dd_probe.run_probe(x, dd_probe.plain_primitive, plain_dd.onehot_product)
    assert dd_probe.bitwise_equal(out, plain), dd_probe.max_abs_diff(out, plain)
    assert not torch.backends.cuda.matmul.allow_tf32
    reference = torch.matmul(x["P"], x["Mh"])
    assert torch.equal(out["onehot"][0].view(torch.int32), reference.view(torch.int32))
    assert torch.equal(
        cuda_dd_probe.onehot_product(x["P"], x["Mh"]).view(torch.int32), reference.view(torch.int32)
    )
    # One TF32 pass keeps 11 significant bits: its error is at most one
    # unit in the 11th bit of the largest entry, and nonzero on these data.
    err = dd_probe.tf32_single_pass_error(x, single)
    assert 0.0 < err <= float(x["Mh"].abs().max()) * 2.0**-10


@pytest.mark.cuda
def test_dd_probe_onehot_product_exact_at_every_width(cuda_device):
    rng = np.random.default_rng(5)
    for w in (1, 7, 8, 9, 13, 16):
        P = np.zeros((w, w), np.float32)
        P[np.arange(w), rng.permutation(w)] = 1.0
        X = (rng.standard_normal((w, w)) * 10.0 ** rng.uniform(-30, 30, (w, w))).astype(np.float32)
        Pg, Xg = torch.as_tensor(P, device=cuda_device), torch.as_tensor(X, device=cuda_device)
        out = cuda_dd_probe.onehot_product(Pg, Xg).cpu().numpy()
        np.testing.assert_array_equal(out.view(np.int32), (P @ X).view(np.int32))
