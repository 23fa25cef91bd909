"""Inertia-corrected regularized LDLᵀ factorization of a KKT system.

Port of `sleipnir_tpu/optimization/solver/util/regularized_ldlt.py`, the
behaviour of reference solver/util/sparse_regularized_ldlt.hpp:64-151:
factor the saddle system, check the inertia of D against the ideal
(n⁺ = decision variables, n⁻ = equality constraints, n⁰ = 0) and, on a
mismatch, retry with the regularization [δI, 0; 0, −γI], escalating δ and
γ tenfold per failure mode until the inertia is ideal or δ or γ passes
1e20 (ill-conditioning, a failure).

The JAX package runs the escalation as a `lax.while_loop` on the device;
here it is a host loop over `ops/ldlt.py`, reading each attempt's pivots.
Everything runs in the dtype of `lhs`, machine epsilon included, and the
host's δ and γ are rounded to that dtype as the JAX package's device
scalars are. No kernel stands behind it: the solvers factor through
`kkt_backend.regularization_loop`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sleipnir_tpu_torch.ops.ldlt import inertia, ldlt_factor, ldlt_solve


class RegularizedFactor(NamedTuple):
    """Result of a regularized LDLᵀ factorization."""

    L: torch.Tensor
    d: torch.Tensor
    #: Hessian regularization δ used (0 if none was needed).
    delta: torch.Tensor
    #: Constraint Jacobian regularization γ used.
    gamma: torch.Tensor
    #: Whether a factorization with ideal inertia was obtained.
    ok: bool


def regularized_ldlt(
    lhs: torch.Tensor,
    num_decision_variables: int,
    num_equality_constraints: int,
    prev_delta,
    gamma_min: float,
) -> RegularizedFactor:
    """Factor the KKT lhs with inertia correction.

    `lhs` is the full symmetric (n+mₑ)×(n+mₑ) system. `prev_delta` is δ
    from the previous solver iteration (δ trends downward across
    iterations: reference sparse_regularized_ldlt.hpp:95-98). `gamma_min`
    is the minimum constraint regularization (forced to 0 in feasibility
    restoration: reference interior_point.hpp:352).
    """
    n, me = num_decision_variables, num_equality_constraints
    dtype, device = lhs.dtype, lhs.device
    scalar = np.float32 if dtype == torch.float32 else np.float64
    eps = scalar(torch.finfo(dtype).eps)
    reg_x = torch.cat([torch.ones(n, dtype=dtype, device=device),
                       torch.zeros(me, dtype=dtype, device=device)])
    reg_y = torch.cat([torch.zeros(n, dtype=dtype, device=device),
                       -torch.ones(me, dtype=dtype, device=device)])

    def tensor(v):
        return torch.tensor(v, dtype=dtype, device=device)

    def factor_with(delta, gamma):
        return ldlt_factor(lhs + torch.diag(tensor(delta) * reg_x + tensor(gamma) * reg_y))

    def counts(d):
        pos, neg, zero = inertia(d, float(eps))
        return int(pos), int(neg), int(zero), not bool(torch.isfinite(d).all())

    # First attempt without regularization
    # (reference sparse_regularized_ldlt.hpp:67-87)
    L0, d0 = factor_with(0.0, 0.0)
    pos, neg, zero, failed = counts(d0)
    if (pos == n and neg == me and zero == 0 and not failed
            and bool((torch.abs(d0) >= 1e-4).all())):
        return RegularizedFactor(L0, d0, tensor(0.0), tensor(0.0), True)

    # Starting values for the escalation (reference
    # sparse_regularized_ldlt.hpp:95-102)
    prev, ten = scalar(float(prev_delta)), scalar(10.0)
    delta = scalar(1e-4) if prev == 0.0 else max(prev / scalar(2.0), eps)
    gamma = scalar(gamma_min)
    while True:
        Lc, dc = factor_with(delta, gamma)
        pos, neg, zero, failed = counts(dc)
        if pos == n and neg == me and zero == 0 and not failed:
            return RegularizedFactor(Lc, dc, tensor(delta), tensor(gamma), True)
        # Escalation policy (reference sparse_regularized_ldlt.hpp:116-141)
        has_zero = zero > 0 and not failed
        too_negative = neg > me and not failed and not has_zero
        too_positive = pos > n and not failed and not has_zero and not too_negative
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
            # The JAX loop's carry keeps the unregularized factor on failure.
            return RegularizedFactor(L0, d0, tensor(delta), tensor(gamma), False)


def regularized_solve(factor: RegularizedFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve with a `regularized_ldlt` factor."""
    return ldlt_solve(factor.L, factor.d, rhs)
