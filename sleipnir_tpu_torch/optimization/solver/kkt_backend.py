"""Inertia-correcting regularization of the KKT factorization
(reference solver/util/sparse_regularized_ldlt.hpp:64-151).

Port of `regularization_loop` from
`sleipnir_tpu/optimization/solver/kkt_backend.py`. The dense backend is
not ported yet (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

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

_EPS = float(torch.finfo(torch.float64).eps)


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
    """Inertia-correction escalation as a batched candidate ladder.

    `factor_with(deltas, gammas)` factors one system per (δ, γ) pair (both
    (B,) tensors) and returns (fac, pos, neg, zero, failed), each with a
    leading batch axis B.

    One call factors {(0, 0), (δ₀, γ_min), (10δ₀, γ_min), (100δ₀, γ_min)}
    and the SMALLEST candidate with ideal inertia wins. If none has it, a
    sequential host loop takes over one decade above the top rung and
    reproduces the reference's diagnosis-dependent δ/γ escalation
    (sparse_regularized_ldlt.hpp:118-143) exactly.
    """
    device = prev_delta.device
    delta0 = torch.where(
        prev_delta == 0.0,
        torch.full_like(prev_delta, 1e-4),
        torch.clamp(prev_delta / 2.0, min=_EPS),
    )
    zero1 = torch.zeros(1, dtype=torch.float64, device=device)
    deltas = torch.cat(
        [zero1, delta0 * 10.0 ** torch.arange(LADDER - 1, dtype=torch.float64, device=device)]
    )
    gammas = torch.cat([zero1, torch.full((LADDER - 1,), gamma_min, dtype=torch.float64, device=device)])

    lfac, lpos, lneg, lzero, lfailed = factor_with(deltas, gammas)
    lideal = (lpos == ideal_pos) & (lneg == ideal_neg) & (lzero == 0) & ~lfailed
    ranks = torch.arange(LADDER, device=device)
    pick = int(syncs.read(torch.min(torch.where(lideal, ranks, LADDER))))
    if pick < LADDER:
        return RegLoopResult(take(lfac, pick), deltas[pick], gammas[pick], True)

    # Sequential fallback, on host scalars: the branch needs them anyway.
    delta = syncs.read(delta0) * 10.0 ** (LADDER - 1)
    gamma = float(gamma_min)
    while True:
        fac, pos, neg, zero, failed = factor_with(
            torch.tensor([delta], dtype=torch.float64, device=device),
            torch.tensor([gamma], dtype=torch.float64, device=device),
        )
        pos, neg, zero, failed = syncs.read(pos[0], neg[0], zero[0], failed[0])
        failed = bool(failed)
        if pos == ideal_pos and neg == ideal_neg and zero == 0 and not failed:
            return RegLoopResult(
                take(fac, 0),
                torch.tensor(delta, dtype=torch.float64, device=device),
                torch.tensor(gamma, dtype=torch.float64, device=device),
                True,
            )
        has_zero = zero > 0 and not failed
        too_negative = neg > ideal_neg and not failed and not has_zero
        too_positive = pos > ideal_pos and not failed and not has_zero and not too_negative
        if has_zero:
            if gamma == 0.0:
                gamma = 1e-10
            else:
                delta, gamma = delta * 10.0, gamma * 10.0
        elif too_negative:
            delta = delta * 10.0
        else:
            # Too positive keeps δ; a failed factorization raises both.
            if not too_positive:
                delta = delta * 10.0
            gamma = 1e-10 if gamma == 0.0 else gamma * 10.0
        if delta > 1e20 or gamma > 1e20:
            return RegLoopResult(
                take(lfac, LADDER - 1),
                torch.tensor(delta, dtype=torch.float64, device=device),
                torch.tensor(gamma, dtype=torch.float64, device=device),
                False,
            )
