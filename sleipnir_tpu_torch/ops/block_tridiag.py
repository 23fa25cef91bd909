"""Block-tridiagonal symmetric factor, solve and inertia in plain torch.

The plain twin of the Hopper kernels in `ops/cuda_banded.py`: it computes
what `sleipnir_tpu/ops/block_tridiag.py:212-289` (the CPU scan) and
`sleipnir_tpu/ops/pallas_banded.py:233-352` (the TPU kernels) compute,
with a leading batch axis B, and stores the factor in the kernel's
layout:

    S_0 = D_0,   X_k = S_k⁻¹ E_kᵀ,   S_{k+1} = D_{k+1} − E_k X_k

  - `LU[b, k]`: S_k's row-pivoted LU, LAPACK-packed (strict-lower unit L
    plus upper U);
  - `perm[b, k]`: its row permutation as an index vector,
    (P S_k)[i] = S_k[perm[i]];
  - `d[b, k]`: the pivots of S_k's unpivoted LDLᵀ, for inertia;
  - `X[b, k]` = S_k⁻¹ E_kᵀ.

Pivots follow LAPACK's rule, the first maximal |entry| of the column,
which is also the kernel's rule. Inputs D (B, K, w, w) and E
(B, K-1, w, w) hold the diagonal blocks and the blocks below them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sleipnir_tpu_torch.ops.ldlt import ldlt_unblocked


class BlockTridiagFactor(NamedTuple):
    LU: torch.Tensor  # (B, K, w, w) packed LU of each S_k
    perm: torch.Tensor  # (B, K, w) int32 row permutations
    d: torch.Tensor  # (B, K, w) unpivoted-LDLᵀ pivots of each S_k
    X: torch.Tensor  # (B, K-1, w, w) S_k⁻¹ E_kᵀ


def _pivots_to_perm(piv: torch.Tensor) -> torch.Tensor:
    """LAPACK pivots (1-based, row k swapped with piv[k]-1 at step k) ->
    permutation index vectors, batched over leading axes."""
    w = piv.shape[-1]
    perm = torch.arange(w, device=piv.device).expand(piv.shape).clone()
    swap = (piv - 1).long()
    for k in range(w):
        pk = swap[..., k : k + 1]
        a = perm[..., k : k + 1].clone()
        b = torch.gather(perm, -1, pk)
        perm[..., k : k + 1] = b
        perm.scatter_(-1, pk, a)
    return perm.to(torch.int32)


def block_tridiag_factor(D: torch.Tensor, E: torch.Tensor) -> BlockTridiagFactor:
    """Factor a batch of block-tridiagonal systems (plain twin of K1)."""
    B, K, w, _ = D.shape
    Ss, lus, pivs, Xs = [], [], [], []
    S = D[:, 0]
    for k in range(K):
        Ss.append(S)
        lu, piv, _info = torch.linalg.lu_factor_ex(S)
        lus.append(lu)
        pivs.append(piv)
        if k + 1 < K:
            X = torch.linalg.lu_solve(lu, piv, E[:, k].transpose(-1, -2))
            Xs.append(X)
            S = D[:, k + 1] - E[:, k] @ X
    _L, d = ldlt_unblocked(torch.stack(Ss, dim=1))
    X = torch.stack(Xs, dim=1) if Xs else D.new_zeros((B, 0, w, w))
    return BlockTridiagFactor(
        LU=torch.stack(lus, dim=1),
        perm=_pivots_to_perm(torch.stack(pivs, dim=1)),
        d=d,
        X=X,
    )


def _lu_apply(LU: torch.Tensor, perm: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """S⁻¹ y for packed LU + permutation vector; y (..., w, r)."""
    idx = perm.long()[..., None].expand(y.shape)
    v = torch.gather(y, -2, idx)
    v = torch.linalg.solve_triangular(LU, v, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(LU, v, upper=True)


def block_tridiag_solve(fac: BlockTridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for b (B, K, w) or (B, K, w, r) (plain
    twin of K2)."""
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    K = b.shape[1]
    XT = fac.X.transpose(-1, -2)
    ys = [b[:, 0]]
    for k in range(K - 1):
        ys.append(b[:, k + 1] - XT[:, k] @ ys[-1])
    z = _lu_apply(fac.LU, fac.perm, torch.stack(ys, dim=1))
    xs = [z[:, K - 1]]
    for k in range(K - 2, -1, -1):
        xs.append(z[:, k] - fac.X[:, k] @ xs[-1])
    x = torch.stack(xs[::-1], dim=1)
    return x[..., 0] if vector else x


def block_tridiag_inertia(fac: BlockTridiagFactor, eps: float):
    """(positive, negative, zero) pivot counts per system, each (B,)."""
    d = fac.d.flatten(1)
    positive = (d > eps).sum(dim=1)
    negative = (d < -eps).sum(dim=1)
    zero = d.shape[1] - positive - negative
    return positive, negative, zero
