"""The Hopper kernels K1/K2 against their plain torch twin on the card.

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
from sleipnir_tpu_torch.ops import cuda_banded
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
    "B,K,w,r", [(4, 101, 13, None), (1, 101, 13, 3), (2, 40, 37, None), (1, 7, 3, None), (3, 1, 4, None)]
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
