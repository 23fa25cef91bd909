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

Below the chain are the JAX package's other factors of the same systems,
batch first: the partitioned form (on K1/K2 on the card), and the
opt-in explicit-inverse factors and block cyclic reduction, which are
plain torch on any device as they are plain JAX there.
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


# ---------------------------------------------------------------------------
# Explicit-inverse factors
# ---------------------------------------------------------------------------
#
# The JAX package's substitution-free variant of the chain and of the
# partitioned form (sleipnir_tpu/ops/block_tridiag.py:552-914): each Schur
# complement S_k is inverted explicitly (sweep operator, or the adjugate for
# w ≤ 3) with its unpivoted-LDLᵀ pivots, so solves are matrix products
# only. The inverse is only forward-stable: on an interior-point KKT chain
# whose blocks reach cond ~1e9 its residual grows to ~1e15
# (docs/tpu_numerics.md:144-155), so it suits well-conditioned systems. The
# operations are the JAX package's, in its order, with the batch axis B
# first; they are plain torch on the solve's device, as they are plain
# JAX there.


def _nonzero(a: torch.Tensor) -> torch.Tensor:
    """`jnp.where(a == 0.0, 1.0, a)`: a zero pivot divides by one."""
    return torch.where(a == 0.0, torch.ones_like(a), a)


def _inv_pivots_sweep(A: torch.Tensor):
    """Symmetric explicit inverse and unpivoted-LDLᵀ pivots of blocks A
    (..., w, w) by the sweep operator, one step per row: (A⁻¹, d)."""
    w = A.shape[-1]
    eye = torch.eye(w, dtype=A.dtype, device=A.device)
    ds = []
    for k in range(w):
        row = A[..., k, :]
        akk = row[..., k]
        ds.append(akk)
        akk_safe = _nonzero(akk)
        r = row / akk_safe[..., None]
        ek = eye[k]
        rk = row[..., k] / akk_safe
        corr = rk + rk + 1.0 / akk_safe
        A = (
            A
            - row[..., :, None] * r[..., None, :]
            + ek[:, None] * r[..., None, :]
            + r[..., :, None] * ek[None, :]
            - corr[..., None, None] * (ek[:, None] * ek[None, :])
        )
    return -A, torch.stack(ds, dim=-1)


def _inv_pivots_1(A: torch.Tensor):
    return 1.0 / _nonzero(A[..., 0, 0])[..., None, None], A[..., 0, :]


def _inv_pivots_2(A: torch.Tensor):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    det = a * c - b * b
    T = torch.stack([torch.stack([c, -b], -1), torch.stack([-b, a], -1)], -2)
    T = T / _nonzero(det)[..., None, None]
    return T, torch.stack([a, det / _nonzero(a)], -1)


def _inv_pivots_3(A: torch.Tensor):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    dd, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    C00 = dd * f - e * e
    C01 = -(b * f - c * e)
    C02 = b * e - c * dd
    C11 = a * f - c * c
    C12 = -(a * e - b * c)
    C22 = a * dd - b * b
    det = a * C00 + b * C01 + c * C02
    T = torch.stack([
        torch.stack([C00, C01, C02], -1),
        torch.stack([C01, C11, C12], -1),
        torch.stack([C02, C12, C22], -1),
    ], -2) / _nonzero(det)[..., None, None]
    m2 = C22
    return T, torch.stack([a, m2 / _nonzero(a), det / _nonzero(m2)], -1)


def _inv_pivots(A: torch.Tensor, polish: int = 1):
    """Explicit inverse and unpivoted-LDLᵀ pivots of symmetric blocks A
    (..., w, w): the adjugate for w ≤ 3, the sweep otherwise, then
    `polish` Newton steps T ← T + T(I − A T), each symmetrized."""
    w = A.shape[-1]
    if w <= 3:
        T, d = (_inv_pivots_1, _inv_pivots_2, _inv_pivots_3)[w - 1](A)
    else:
        T, d = _inv_pivots_sweep(A)
    eye = torch.eye(w, dtype=A.dtype, device=A.device)
    for _ in range(polish):
        T = T + T @ (eye - A @ T)
        T = 0.5 * (T + T.transpose(-1, -2))
    return T, d


class BlockTridiagFactorInv(NamedTuple):
    """Explicit-inverse chain: T[b, k] = S_k⁻¹, d[b, k] the unpivoted-LDLᵀ
    pivots of S_k (inertia), W[b, k] = E_k S_k⁻¹."""

    T: torch.Tensor  # (B, K, w, w)
    d: torch.Tensor  # (B, K, w)
    W: torch.Tensor  # (B, K-1, w, w)


def block_tridiag_factor_inv(D: torch.Tensor, E: torch.Tensor) -> BlockTridiagFactorInv:
    """The chain's recursion carrying explicit inverses, D (B, K, w, w)
    and E (B, K-1, w, w): per stage one inversion and two products."""
    B, K, w, _ = D.shape
    Ts, ds, Xs = [], [], []
    S = D[:, 0]
    for k in range(K):
        T, d = _inv_pivots(S)
        Ts.append(T)
        ds.append(d)
        if k + 1 < K:
            X = T @ E[:, k].transpose(-1, -2)  # S_k⁻¹ E_kᵀ
            Xs.append(X)
            S = D[:, k + 1] - E[:, k] @ X
    W = torch.stack(Xs, dim=1).transpose(-1, -2) if Xs else D.new_zeros((B, 0, w, w))
    return BlockTridiagFactorInv(T=torch.stack(Ts, dim=1), d=torch.stack(ds, dim=1), W=W)


def block_tridiag_solve_inv(fac: BlockTridiagFactorInv, b: torch.Tensor) -> torch.Tensor:
    """Solve with a `block_tridiag_factor_inv` result for b (B, K, w) or
    (B, K, w, r): one product per stage each way, and the diagonal solves
    as one batched product over all stages."""
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    K = b.shape[1]
    ys = [b[:, 0]]
    for k in range(K - 1):
        ys.append(b[:, k + 1] - fac.W[:, k] @ ys[-1])
    z = fac.T @ torch.stack(ys, dim=1)
    WT = fac.W.transpose(-1, -2)
    xs = [z[:, K - 1]]
    for k in range(K - 2, -1, -1):
        xs.append(z[:, k] - WT[:, k] @ xs[-1])
    x = torch.stack(xs[::-1], dim=1)
    return x[..., 0] if vector else x


#: Below this many blocks the explicit-inverse path takes the chain.
PART_INV_MIN_BLOCKS = 24

#: Longest part of the explicit-inverse partitioned form: the recursion
#: stays at 2-3 levels and K=5001 takes 31 + 12 + 13 batched steps.
PART_INV_MAX_L = 32


class PartitionedFactorInv(NamedTuple):
    """Partitioned factor carrying explicit interior inverses. Every
    tensor has the batch axis B first, then the interior step i < L-1,
    then the part p < P; `red` is the reduced system's factor, again a
    `PartitionedFactorInv` or a `BlockTridiagFactorInv`."""

    int_T: torch.Tensor  # (B, L-1, P, w, w) explicit interior inverses
    int_d: torch.Tensor  # (B, L-1, P, w) their LDLᵀ pivots (inertia)
    U: torch.Tensor  # (B, L-1, P, w, w) fill coupling to the left interface
    E_in: torch.Tensor  # (B, L-1, P, w, w) couplings within a part
    red: object


def choose_partitions_inv(nblocks: int) -> tuple[int, int]:
    """(P, L) of the explicit-inverse partitioned form: L ≈ √K, at most
    PART_INV_MAX_L."""
    L = max(2, min(math.ceil(math.sqrt(nblocks)), PART_INV_MAX_L))
    return math.ceil(nblocks / L), L


def block_tridiag_factor_part_inv(D: torch.Tensor, E: torch.Tensor):
    """Partitioned factor with explicit-inverse interiors of D
    (B, K, w, w) and E (B, K-1, w, w): a `PartitionedFactorInv`, or the
    explicit-inverse chain below PART_INV_MIN_BLOCKS blocks. Each batched
    step over the B·P parts is one inversion and five products."""
    B, K, w, _ = D.shape
    if K < PART_INV_MIN_BLOCKS:
        return block_tridiag_factor_inv(D, E)
    P, L = choose_partitions_inv(K)
    pad = P * L - K
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    D = torch.cat([D, eye.expand(B, pad, w, w)], dim=1)
    # One zero block more lets E reshape by part: Ep[:, p, j] couples block
    # pL + j to the one after it.
    Ep = torch.cat([E, D.new_zeros(B, pad + 1, w, w)], dim=1).reshape(B, P, L, w, w)
    Dp = D.reshape(B, P, L, w, w)
    D_int = Dp[:, :, : L - 1].transpose(1, 2)  # (B, L-1, P, w, w)
    D_ifc = Dp[:, :, L - 1]  # (B, P, w, w)
    E_in = Ep[:, :, : L - 1].transpose(1, 2)  # (B, L-1, P, w, w)
    U = torch.cat([D.new_zeros(B, 1, w, w), Ep[:, :-1, L - 1]], dim=1)  # (B, P, w, w)

    S, dDl = D_int[:, 0], D.new_zeros(B, P, w, w)
    Ts, dps, Us = [], [], []
    for i in range(L - 1):
        D_next = D_int[:, i + 1] if i + 1 < L - 1 else D_ifc
        E_i = E_in[:, i]
        T, dpiv = _inv_pivots(S)
        TEt = T @ E_i.transpose(-1, -2)  # S_i⁻¹ E_iᵀ
        TU = T @ U
        Ts.append(T)
        dps.append(dpiv)
        Us.append(U)
        S = D_next - E_i @ TEt
        dDl = dDl - U.transpose(-1, -2) @ TU
        U = -(E_i @ TU)
    D_red = S + torch.cat([dDl[:, 1:], D.new_zeros(B, 1, w, w)], dim=1)
    red = block_tridiag_factor_part_inv(D_red, U[:, 1:])
    return PartitionedFactorInv(
        int_T=torch.stack(Ts, dim=1), int_d=torch.stack(dps, dim=1),
        U=torch.stack(Us, dim=1), E_in=E_in, red=red,
    )


def block_tridiag_solve_part_inv(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve with a `block_tridiag_factor_part_inv` result for b (B, K, w)
    or (B, K, w, r): matrix products only."""
    if isinstance(fac, BlockTridiagFactorInv):
        return block_tridiag_solve_inv(fac, b)
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    B, K, w, r = b.shape
    Lint, P = fac.int_T.shape[1:3]
    L = Lint + 1
    b = torch.cat([b, b.new_zeros(B, P * L - K, w, r)], dim=1).reshape(B, P, L, w, r)
    y0 = b[:, :, :Lint].transpose(1, 2)  # (B, L-1, P, w, r)
    b_ifc = b[:, :, Lint]

    corr, dbl = b.new_zeros(B, P, w, r), b.new_zeros(B, P, w, r)
    ys = []
    for i in range(Lint):
        y = y0[:, i] + corr
        z = fac.int_T[:, i] @ y
        corr = -(fac.E_in[:, i] @ z)
        dbl = dbl - fac.U[:, i].transpose(-1, -2) @ z
        ys.append(y)
    b_red = b_ifc + corr + torch.cat([dbl[:, 1:], b.new_zeros(B, 1, w, r)], dim=1)
    x_ifc = block_tridiag_solve_part_inv(fac.red, b_red)  # (B, P, w, r)
    x_left = torch.cat([b.new_zeros(B, 1, w, r), x_ifc[:, :-1]], dim=1)

    x_next, xs = x_ifc, []
    for i in range(Lint - 1, -1, -1):
        rhs = (ys[i] - fac.E_in[:, i].transpose(-1, -2) @ x_next
               - fac.U[:, i] @ x_left)
        x_next = fac.int_T[:, i] @ rhs
        xs.append(x_next)
    x_int = torch.stack(xs[::-1], dim=2)  # (B, P, L-1, w, r)
    x = torch.cat([x_int, x_ifc[:, :, None]], dim=2).reshape(B, P * L, w, r)[:, :K]
    return x[..., 0] if vector else x


def inv_part_inertia(fac, eps: float, nblocks: int):
    """(positive, negative, zero) per system, each (B,), of an
    explicit-inverse factor (chain or partitioned) of systems of `nblocks`
    blocks, less each level's identity padding, whose pivots are +1."""
    if isinstance(fac, BlockTridiagFactorInv):
        d = fac.d.flatten(1)
        positive = (d > eps).sum(dim=1)
        negative = (d < -eps).sum(dim=1)
        return positive, negative, d.shape[1] - positive - negative
    d = fac.int_d.flatten(1)
    Lint, P, w = fac.int_d.shape[1:]
    rpos, rneg, rzero = inv_part_inertia(fac.red, eps, P)
    pos = (d > eps).sum(dim=1) + rpos
    neg = (d < -eps).sum(dim=1) + rneg
    total = d.shape[1] + rpos + rneg + rzero
    pad_pos = (P * (Lint + 1) - nblocks) * w
    pos = pos - pad_pos
    return pos, neg, (total - pad_pos) - pos - neg


def inv_part_pivots(fac) -> list:
    """The pivot tensors of an explicit-inverse factor, each (B, ·)."""
    if isinstance(fac, BlockTridiagFactorInv):
        return [fac.d.flatten(1)]
    return [fac.int_d.flatten(1)] + inv_part_pivots(fac.red)


# ---------------------------------------------------------------------------
# Block cyclic reduction
# ---------------------------------------------------------------------------
#
# The JAX package's depth-log(K) factor (sleipnir_tpu/ops/block_tridiag.py:
# 916-1066): the system is padded to 2^L + 1 blocks with identity
# diagonals and zero couplings, and each of the L levels eliminates every
# odd block at once, with one batch of small LDLᵀs and two triangular
# solves, leaving a system of about half the blocks. The coarsest system,
# of at most two blocks, takes the chain's factor (K1 on the card). Block
# elimination is a symmetric congruence, so the eliminated pivots and the
# coarsest factor's give the exact inertia.


class BCRLevel(NamedTuple):
    Lo: torch.Tensor  # (B, M, w, w) LDLᵀ factors of the eliminated odd blocks
    do: torch.Tensor  # (B, M, w)
    X: torch.Tensor  # (B, M, w, w) D_odd⁻¹ E_left
    Y: torch.Tensor  # (B, M, w, w) D_odd⁻¹ E_rightᵀ
    Eleft: torch.Tensor  # (B, M, w, w)
    Eright: torch.Tensor  # (B, M, w, w)


class BCRFactor(NamedTuple):
    levels: tuple  # of BCRLevel, finest to coarsest
    final: BlockTridiagFactor  # the chain's factor of the coarsest (≤ 2) blocks


def _bcr_padded_blocks(fac: BCRFactor) -> int:
    """The padded block count, from the level shapes."""
    if not fac.levels:
        return fac.final.d.shape[1]
    return 2 * fac.levels[0].do.shape[1] + 1


def _batched_ldlt_solve(L: torch.Tensor, d: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L diag(d) Lᵀ) X = rhs, batched over the leading axes."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    y = y / _nonzero(d)[..., :, None]
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def bcr_factor(D: torch.Tensor, E: torch.Tensor, factor=block_tridiag_factor) -> BCRFactor:
    """Block cyclic reduction of D (B, K, w, w) and E (B, K-1, w, w) in
    ⌈log₂(K-1)⌉ levels; `factor` factors the coarsest system (the plain
    twin by default, K1's wrapper on the card)."""
    B, K, w, _ = D.shape
    if K <= 2:
        return BCRFactor(levels=(), final=factor(D, E))
    P = 2 ** math.ceil(math.log2(K - 1)) + 1
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    D = torch.cat([D, eye.expand(B, P - K, w, w)], dim=1)
    E = torch.cat([E, D.new_zeros(B, P - K, w, w)], dim=1)

    levels = []
    while D.shape[1] >= 3:
        Dodd, Eleft, Eright = D[:, 1::2], E[:, 0::2], E[:, 1::2]
        Lo, do = ldlt_unblocked(Dodd)
        X = _batched_ldlt_solve(Lo, do, Eleft)
        Y = _batched_ldlt_solve(Lo, do, Eright.transpose(-1, -2))
        # An even block loses its right odd neighbour's E_{2k}ᵀ X_k and its
        # left one's E_{2k-1} Y_{k-1}.
        zero = D.new_zeros(B, 1, w, w)
        Dnew = (D[:, 0::2] - torch.cat([Eleft.transpose(-1, -2) @ X, zero], dim=1)
                - torch.cat([zero, Eright @ Y], dim=1))
        levels.append(BCRLevel(Lo=Lo, do=do, X=X, Y=Y, Eleft=Eleft, Eright=Eright))
        D, E = Dnew, -(Eright @ X)
    return BCRFactor(levels=tuple(levels), final=factor(D.contiguous(), E.contiguous()))


def bcr_solve(fac: BCRFactor, b: torch.Tensor, solve=block_tridiag_solve) -> torch.Tensor:
    """Solve with a `bcr_factor` result for b (B, K, w) or (B, K, w, r);
    `solve` solves the coarsest system."""
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    B, K, w, r = b.shape
    b = torch.cat([b, b.new_zeros(B, _bcr_padded_blocks(fac) - K, w, r)], dim=1)
    zero = b.new_zeros(B, 1, w, r)

    # Forward reduction
    stack = [b]
    for lv in fac.levels:
        z = _batched_ldlt_solve(lv.Lo, lv.do, b[:, 1::2])
        b = (b[:, 0::2] - torch.cat([lv.Eleft.transpose(-1, -2) @ z, zero], dim=1)
             - torch.cat([zero, lv.Eright @ z], dim=1))
        stack.append(b)

    x = solve(fac.final, b.contiguous())

    # Back substitution: x_odd_k = z_k − X_k x_even[k] − Y_k x_even[k+1]
    for lv, b_l in zip(reversed(fac.levels), reversed(stack[:-1])):
        z = _batched_ldlt_solve(lv.Lo, lv.do, b_l[:, 1::2])
        x_odd = z - lv.X @ x[:, :-1] - lv.Y @ x[:, 1:]
        out = b.new_zeros(B, x.shape[1] + x_odd.shape[1], w, r)
        out[:, 0::2] = x
        out[:, 1::2] = x_odd
        x = out
    x = x[:, :K]
    return x[..., 0] if vector else x


def bcr_pivots(fac: BCRFactor) -> list:
    """The pivot tensors of a BCR factor, each (B, ·): the coarsest
    system's, then each level's."""
    return [fac.final.d.flatten(1)] + [lv.do.flatten(1) for lv in fac.levels]


def bcr_inertia(fac: BCRFactor, eps: float, num_blocks: int):
    """(positive, negative, zero) per system, each (B,), from every
    eliminated pivot and the coarsest factor's, less the identity padding's
    +1 pivots."""
    d = torch.cat(bcr_pivots(fac), dim=1)
    w = fac.final.d.shape[-1]
    pad_pos = (_bcr_padded_blocks(fac) - num_blocks) * w
    pos = (d > eps).sum(dim=1) - pad_pos
    neg = (d < -eps).sum(dim=1)
    return pos, neg, (d.shape[1] - pad_pos) - pos - neg
