"""KKT backends: how derivatives are stored and the Newton-KKT system
is factored and solved (reference solver/util/regularized_ldlt.hpp:19-136).

Port of `sleipnir_tpu/optimization/solver/kkt_backend.py`:
`regularization_loop`, the δ/γ inertia correction both backends share
(reference solver/util/sparse_regularized_ldlt.hpp:64-151), and
`DenseBackend`, dense derivative matrices and the blocked dense LDLᵀ of
`ops/ldlt.py`, the default for problems without OCP stage structure. The
banded backend is `kkt_banded.BandedBackend`. The interior-point, SQP and
Newton solvers are generic over the two.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from sleipnir_tpu_torch.ops.ldlt import inertia, ldlt_factor, ldlt_solve
from sleipnir_tpu_torch.optimization.solver.util.cuda_graph import Graphs
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs


class RegLoopResult(NamedTuple):
    fac: object  # backend-specific factor, batch axis of size 1
    delta: torch.Tensor
    gamma: torch.Tensor
    ok: bool


#: δ-candidates factored at once in the regularization ladder, the
#: unregularized candidate included. The batch axis is the kernel's grid:
#: one thread block per candidate.
LADDER = 4


def eps_of(dtype: torch.dtype) -> float:
    """Machine epsilon of the solve's dtype."""
    return float(torch.finfo(dtype).eps)


def eps_inertia(dtype: torch.dtype) -> float:
    """Pivot zero-threshold for inertia on an equilibrated system, whose
    legitimate pivots are O(1): eps^0.75, ~1e-12 in float64 and ~2e-5 in
    float32 (JAX package kkt_banded.py:739-743)."""
    return eps_of(dtype) ** 0.75


def ladder_depth(dtype: torch.dtype) -> int:
    """Rungs of the ladder. float32 pivots near the inertia threshold are
    noisy enough that a 4-rung smallest-ideal pick jumps between rungs and
    can stall the solve; 2 rungs still spare the sequential (0, 0)
    attempt (JAX package kkt_backend.py:53-65)."""
    return 2 if dtype == torch.float32 else LADDER


def take(tree, i: int):
    """Candidate i of a batched factor (tensors or nested tuples of them),
    keeping a batch axis of size 1."""
    if isinstance(tree, torch.Tensor):
        return tree[i : i + 1]
    parts = [take(t, i) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def regularization_loop(
    factor_with: Callable,
    ideal_pos: int,
    ideal_neg: int,
    prev_delta: torch.Tensor,
    gamma_min: float,
    syncs: HostSyncs,
) -> RegLoopResult:
    """Inertia-correction escalation as a batched candidate ladder, in the
    dtype of `prev_delta`, the solve's.

    `factor_with(deltas, gammas)` factors one system per (δ, γ) pair (both
    (B,) tensors) and returns (fac, pos, neg, zero, failed), each with a
    leading batch axis B.

    One call factors {(0, 0), (δ₀, γ_min), (10δ₀, γ_min), (100δ₀, γ_min)}
    (in float32 the first two) and the SMALLEST candidate with ideal
    inertia wins. If none has it, a sequential host loop takes over one
    decade above the top rung and reproduces the reference's
    diagnosis-dependent δ/γ escalation (sparse_regularized_ldlt.hpp:118-143)
    exactly, its host scalars rounded to the dtype as the JAX package's
    device scalars are.
    """
    device, dtype = prev_delta.device, prev_delta.dtype
    ladder = ladder_depth(dtype)
    scalar = np.float32 if dtype == torch.float32 else np.float64
    delta0 = torch.where(
        prev_delta == 0.0,
        torch.full_like(prev_delta, 1e-4),
        torch.clamp(prev_delta / 2.0, min=eps_of(dtype)),
    )
    zero1 = torch.zeros(1, dtype=dtype, device=device)
    deltas = torch.cat(
        [zero1, delta0 * 10.0 ** torch.arange(ladder - 1, dtype=dtype, device=device)]
    )
    gammas = torch.cat([zero1, torch.full((ladder - 1,), gamma_min, dtype=dtype, device=device)])

    lfac, lpos, lneg, lzero, lfailed = factor_with(deltas, gammas)
    lideal = (lpos == ideal_pos) & (lneg == ideal_neg) & (lzero == 0) & ~lfailed
    ranks = torch.arange(ladder, device=device)
    pick = int(syncs.read(torch.min(torch.where(lideal, ranks, ladder))))
    if pick < ladder:
        return RegLoopResult(take(lfac, pick), deltas[pick], gammas[pick], True)

    # Sequential fallback, on host scalars: the branch needs them anyway.
    ten = scalar(10.0)
    delta = scalar(syncs.read(delta0)) * scalar(10.0 ** (ladder - 1))
    gamma = scalar(gamma_min)

    def tensor(v):
        return torch.tensor(v, dtype=dtype, device=device)

    while True:
        fac, pos, neg, zero, failed = factor_with(tensor([delta]), tensor([gamma]))
        pos, neg, zero, failed = syncs.read(pos[0], neg[0], zero[0], failed[0])
        failed = bool(failed)
        if pos == ideal_pos and neg == ideal_neg and zero == 0 and not failed:
            return RegLoopResult(take(fac, 0), tensor(delta), tensor(gamma), True)
        has_zero = zero > 0 and not failed
        too_negative = neg > ideal_neg and not failed and not has_zero
        too_positive = pos > ideal_pos and not failed and not has_zero and not too_negative
        if has_zero:
            if gamma == 0.0:
                gamma = scalar(1e-10)
            else:
                delta, gamma = delta * ten, gamma * ten
        elif too_negative:
            delta = delta * ten
        else:
            # Too positive keeps δ; a failed factorization raises both.
            if not too_positive:
                delta = delta * ten
            gamma = scalar(1e-10) if gamma == 0.0 else gamma * ten
        if delta > 1e20 or gamma > 1e20:
            return RegLoopResult(take(lfac, ladder - 1), tensor(delta), tensor(gamma), False)


# ---------------------------------------------------------------------------
# Dense backend
# ---------------------------------------------------------------------------

#: The float64 inertia threshold, and the reference's small-pivot gate for
#: the unregularized attempt (sparse_regularized_ldlt.hpp:82-83) in every
#: dtype, as in the banded backend.
EPS_INERTIA = eps_inertia(torch.float64)
SMALL_PIVOT = 1e-4


class DenseDerivs(NamedTuple):
    """Scaled dense derivative matrices."""

    H: torch.Tensor  # (n, n)
    A_e: torch.Tensor  # (me, n)
    A_i: torch.Tensor  # (mi, n)


def _equilibrate_dense(A: torch.Tensor, rounds: int = 2):
    """Symmetric Ruiz equilibration of a batch of matrices A (B, N, N):
    returns (S A S, s). A congruence, so the inertia is exactly preserved
    while row and column magnitudes compress to O(1)."""
    s = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(rounds):
        rn = torch.amax(torch.abs(A), dim=-1)
        f = torch.where(rn > 0.0, 1.0 / torch.sqrt(rn), 1.0)
        A = A * f[..., :, None] * f[..., None, :]
        s = s * f
    return A, s


class DenseFactor(NamedTuple):
    L: torch.Tensor  # (N, N)
    d: torch.Tensor  # (N,)
    #: Ruiz scale: the factor is of S·KKT·S, so solves are
    #: x = S · ldlt_solve(L, d, S · b).
    s: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    ok: bool


class DenseBackend:
    """Dense derivative storage and the blocked dense LDLᵀ, in the solve's
    dtype."""

    def __init__(self, n: int, me: int, mi: int, device: torch.device, syncs: HostSyncs,
                 dtype: torch.dtype = torch.float64) -> None:
        self.n, self.me, self.mi = n, me, mi
        self.device = device
        self.dtype = dtype
        self.syncs = syncs
        #: The CUDA graphs of the solver built on this backend.
        self.graphs = Graphs()

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- derivative evaluation --------------------------------------------

    def eval_derivs(self, F, x, y, z) -> DenseDerivs:
        return DenseDerivs(H=F.H(x, y, z), A_e=F.A_e(x), A_i=F.A_i(x))

    def all_finite(self, d: DenseDerivs) -> torch.Tensor:
        return torch.isfinite(d.H).all() & torch.isfinite(d.A_e).all() & torch.isfinite(d.A_i).all()

    # -- matvecs -----------------------------------------------------------

    def AeT(self, d: DenseDerivs, v: torch.Tensor) -> torch.Tensor:
        return d.A_e.T @ v if self.me > 0 else self._zeros(self.n)

    def Ae(self, d: DenseDerivs, v: torch.Tensor) -> torch.Tensor:
        return d.A_e @ v

    def AiT(self, d: DenseDerivs, v: torch.Tensor) -> torch.Tensor:
        return d.A_i.T @ v if self.mi > 0 else self._zeros(self.n)

    def Ai(self, d: DenseDerivs, v: torch.Tensor) -> torch.Tensor:
        return d.A_i @ v

    # -- factorization -----------------------------------------------------

    def kkt_lhs(self, d: DenseDerivs, sigma) -> torch.Tensor:
        """The unregularized [H + AᵢᵀΣAᵢ, Aₑᵀ; Aₑ, 0], built from whole
        blocks so that it also runs under `vmap` over lanes."""
        me = self.me
        top_left = d.H + (d.A_i.T @ (sigma[:, None] * d.A_i) if self.mi > 0 else 0.0)
        return torch.cat([
            torch.cat([top_left, d.A_e.T], dim=1),
            torch.cat([d.A_e, self._zeros(me, me)], dim=1),
        ], dim=0)

    def regularization_diagonals(self):
        """The diagonals δ and γ scale: (1 on x, 0 on y) and (0, −1)."""
        n, me = self.n, self.me
        ones = torch.ones(n, dtype=self.dtype, device=self.device)
        return (torch.cat([ones, self._zeros(me)]),
                torch.cat([self._zeros(n), -torch.ones(me, dtype=self.dtype, device=self.device)]))

    def factor_candidates(self, A, deltas, gammas):
        """Equilibrate and factor B regularized systems A (B, N, N) at
        once and count each one's inertia. Returns ((L, d, s), pos, neg,
        zero, failed), each with the leading axis B."""
        A, s = _equilibrate_dense(A)
        L, dd = ldlt_factor(A)
        pos, neg, zero = inertia(dd, eps_inertia(self.dtype))
        small = (torch.abs(dd) < SMALL_PIVOT).any(dim=-1) & (deltas == 0.0) & (gammas == 0.0)
        failed = ~torch.isfinite(dd).all(dim=-1) | small
        return (L, dd, s), pos, neg, zero, failed

    def factor(self, d: DenseDerivs, sigma, prev_delta, gamma_min) -> DenseFactor:
        """Assemble [H + AᵢᵀΣAᵢ, Aₑᵀ; Aₑ, −γI] and factor it with inertia
        correction (reference interior_point.hpp:426-465), the ladder's
        candidates as one batch."""
        lhs = self.kkt_lhs(d, sigma)
        reg_pos, reg_neg = self.regularization_diagonals()

        def factor_with(deltas, gammas):
            diag = deltas[:, None] * reg_pos + gammas[:, None] * reg_neg
            return self.factor_candidates(lhs + torch.diag_embed(diag), deltas, gammas)

        out = regularization_loop(factor_with, self.n, self.me, prev_delta, gamma_min, self.syncs)
        L, dd, s = (t[0] for t in out.fac)
        return DenseFactor(L=L, d=dd, s=s, delta=out.delta, gamma=out.gamma, ok=out.ok)

    def _scaled_solve(self, fac: DenseFactor, b: torch.Tensor) -> torch.Tensor:
        return fac.s * ldlt_solve(fac.L, fac.d, fac.s * b)

    def solve(self, fac: DenseFactor, rhs_top, rhs_bottom):
        """Solve for (p_x, p_y): [·][pˣ; −pʸ] = [rhs_top; rhs_bottom]."""
        p = self._scaled_solve(fac, torch.cat([rhs_top, rhs_bottom]))
        return p[: self.n], -p[self.n :]

    def _kkt_matvec(self, d: DenseDerivs, sigma, delta, gamma, u, v):
        """The regularized KKT matrix [H + AᵢᵀΣAᵢ + δI, Aₑᵀ; Aₑ, −γI]
        applied to (u, v)."""
        top = d.H @ u + delta * u
        if self.mi > 0:
            top = top + d.A_i.T @ (sigma * (d.A_i @ u))
        if self.me > 0:
            top = top + d.A_e.T @ v
            bot = d.A_e @ u - gamma * v
        else:
            bot = v
        return top, bot

    def solve_refined(self, d: DenseDerivs, sigma, fac: DenseFactor, rhs_top, rhs_bottom,
                      iterations: int = 2):
        """Solve plus a fixed count of iterative-refinement passes against
        the regularized KKT matrix: the unpivoted LDLᵀ loses digits on
        ill-conditioned saddle-point systems, and refinement restores
        backward stability."""
        rhs = torch.cat([rhs_top, rhs_bottom])
        p = self._scaled_solve(fac, rhs)
        for _ in range(iterations):
            t, b = self._kkt_matvec(d, sigma, fac.delta, fac.gamma, p[: self.n], p[self.n :])
            p = p + self._scaled_solve(fac, rhs - torch.cat([t, b]))
        return p[: self.n], -p[self.n :]

    # -- observability -----------------------------------------------------

    def dense(self, d: DenseDerivs):
        return d.H.cpu().numpy(), d.A_e.cpu().numpy(), d.A_i.cpu().numpy()
