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

import math
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


# ---------------------------------------------------------------------------
# Partitioned (SPIKE/Schur) factorization
# ---------------------------------------------------------------------------
#
# The chain above has K dependent stages. The partitioned form cuts the
# horizon into P contiguous parts of L blocks; each part's last block is
# its interface, the L-1 blocks before it its interior. The interiors of
# all parts are independent chains, factored as one batch of B·P chains
# of L-1 stages; two block columns per part condense them onto the
# interfaces; the P-block interface system left over is factored again,
# partitioned while it has at least PART_MIN_BLOCKS blocks. The
# sequential depth falls from K to about 2·√K per level. Eliminating the
# interiors first is a symmetric congruence, so the interior pivots and
# the reduced system's pivots give the exact inertia (Sylvester).
#
# This is the JAX package's `block_tridiag_factor_part`
# (sleipnir_tpu/ops/block_tridiag.py:293-524) in the condensed-column form
# of its time-axis split (sleipnir_tpu/parallel/time_axis.py:150-187): per
# part, with T the interior chain, U₀ the coupling of its first block to
# the interface on its left and E_last that of its interface to its last
# interior block,
#
#   [Xl | Xr] = T⁻¹ [U₀ at the first block | E_lastᵀ at the last block],
#   S_own = D_ifc − E_last·Xr[L−2],  U_own = −E_last·Xl[L−2],
#   dDl = −U₀ᵀ·Xl[0],
#
# and the reduced system has D_red[p] = S_own[p] + dDl[p+1] and
# E_red[p−1] = U_own[p]. In exact arithmetic that is the JAX package's
# D_red/E_red, and the interior pivots are its int_d. The chain's own
# factor and solve run unchanged on the interiors (K1 and K2 on the card).

#: Below this many blocks a system takes the sequential chain.
PART_MIN_BLOCKS = 48


class PartitionedFactor(NamedTuple):
    """Factor of a batch of systems in the partitioned form. Every tensor
    has the batch axis B first, so `take` and `merge` slice it like a
    `BlockTridiagFactor`; the geometry (P parts of L blocks) is in the
    shapes, and the block count K is the caller's."""

    interior: BlockTridiagFactor  # leaves (B, P, L-1, ...): the parts' interior chains
    cols: torch.Tensor  # (B, P, L-1, w, 2w): [Xl | Xr], the condensation columns
    U0: torch.Tensor  # (B, P, w, w): first interior block -> left interface
    E_last: torch.Tensor  # (B, P, w, w): interface -> last interior block
    red: object  # factor of the reduced (B, P, w, w) interface system


def choose_partitions(nblocks: int) -> tuple[int, int]:
    """(P, L) with P·L ≥ nblocks and L ≈ √K, which makes L + P least."""
    L = max(2, math.ceil(math.sqrt(nblocks)))
    return math.ceil(nblocks / L), L


def _batch_flat(fac: BlockTridiagFactor, n: int) -> BlockTridiagFactor:
    """Merge the leading n axes of every tensor into one batch axis."""
    return BlockTridiagFactor(*(t.reshape(-1, *t.shape[n:]) for t in fac))


def block_tridiag_factor_part(D: torch.Tensor, E: torch.Tensor, factor=block_tridiag_factor,
                              solve=block_tridiag_solve):
    """Partitioned factor of a batch of block-tridiagonal systems, D
    (B, K, w, w) and E (B, K-1, w, w): a `PartitionedFactor`, or the
    chain's factor when K < PART_MIN_BLOCKS. `factor` and `solve` factor
    and solve the interior chains (the plain twin by default; the
    kernels' wrappers on the card)."""
    B, K, w, _ = D.shape
    if K < PART_MIN_BLOCKS:
        return factor(D, E)
    P, L = choose_partitions(K)
    Lint = L - 1
    pad = P * L - K
    # Identity blocks pad the horizon to P·L, and one zero block more lets
    # E reshape by part: Ep[:, p, j] couples block pL + j to the one after.
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    D = torch.cat([D, eye.expand(B, pad, w, w)], dim=1)
    Ep = torch.cat([E, D.new_zeros(B, pad + 1, w, w)], dim=1).reshape(B, P, L, w, w)
    Dp = D.reshape(B, P, L, w, w)
    E_last = Ep[:, :, Lint - 1]
    U0 = torch.cat([D.new_zeros(B, 1, w, w), Ep[:, :-1, Lint]], dim=1)

    interior = factor(
        Dp[:, :, :Lint].reshape(B * P, Lint, w, w).contiguous(),
        Ep[:, :, : Lint - 1].reshape(B * P, Lint - 1, w, w).contiguous(),
    )
    rhs = D.new_zeros(B, P, Lint, w, 2 * w)
    rhs[:, :, 0, :, :w] = U0
    rhs[:, :, Lint - 1, :, w:] = E_last.transpose(-1, -2)
    cols = solve(interior, rhs.reshape(B * P, Lint, w, 2 * w)).reshape(B, P, Lint, w, 2 * w)
    Xl, Xr = cols[..., :w], cols[..., w:]
    S_own = Dp[:, :, Lint] - E_last @ Xr[:, :, Lint - 1]
    U_own = -(E_last @ Xl[:, :, Lint - 1])
    dDl = -(U0.transpose(-1, -2) @ Xl[:, :, 0])
    D_red = S_own + torch.cat([dDl[:, 1:], D.new_zeros(B, 1, w, w)], dim=1)
    red = block_tridiag_factor_part(
        D_red.contiguous(), U_own[:, 1:].contiguous(), factor, solve
    )
    return PartitionedFactor(
        interior=BlockTridiagFactor(*(t.reshape(B, P, *t.shape[1:]) for t in interior)),
        cols=cols, U0=U0, E_last=E_last.contiguous(), red=red,
    )


def block_tridiag_solve_part(fac, b: torch.Tensor, solve=block_tridiag_solve) -> torch.Tensor:
    """Solve with a `block_tridiag_factor_part` result for b (B, K, w) or
    (B, K, w, r); `solve` solves the interior chains."""
    if not isinstance(fac, PartitionedFactor):
        return solve(fac, b)
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    B, K, w, r = b.shape
    P, Lint = fac.cols.shape[1:3]
    L = Lint + 1
    b = torch.cat([b, b.new_zeros(B, P * L - K, w, r)], dim=1).reshape(B, P, L, w, r)
    z = solve(
        _batch_flat(fac.interior, 2), b[:, :, :Lint].reshape(B * P, Lint, w, r).contiguous()
    ).reshape(B, P, Lint, w, r)
    dbl = -(fac.U0.transpose(-1, -2) @ z[:, :, 0])
    b_red = (b[:, :, Lint] - fac.E_last @ z[:, :, Lint - 1]
             + torch.cat([dbl[:, 1:], b.new_zeros(B, 1, w, r)], dim=1))
    x_ifc = block_tridiag_solve_part(fac.red, b_red.contiguous(), solve)  # (B, P, w, r)
    x_left = torch.cat([b.new_zeros(B, 1, w, r), x_ifc[:, :-1]], dim=1)
    x_int = z - fac.cols @ torch.cat([x_left, x_ifc], dim=-2)[:, :, None]
    x = torch.cat([x_int, x_ifc[:, :, None]], dim=2).reshape(B, P * L, w, r)[:, :K]
    return x[..., 0] if vector else x


def part_pivots(fac) -> list:
    """The pivot tensors of a (possibly recursive) partitioned factor,
    each (B, ·)."""
    if not isinstance(fac, PartitionedFactor):
        return [fac.d.flatten(1)]
    return [fac.interior.d.flatten(1)] + part_pivots(fac.red)


def part_inertia(fac, eps: float, nblocks: int):
    """Inertia per system, each (B,), of a partitioned factor of systems
    of `nblocks` blocks: interior and reduced pivots, less the padding's
    pivots, which are exactly +1 each."""
    d = torch.cat(part_pivots(fac), dim=1)
    w = (fac.interior.d if isinstance(fac, PartitionedFactor) else fac.d).shape[-1]
    pad = d.shape[1] - nblocks * w
    positive = (d > eps).sum(dim=1) - pad
    negative = (d < -eps).sum(dim=1)
    return positive, negative, nblocks * w - positive - negative
