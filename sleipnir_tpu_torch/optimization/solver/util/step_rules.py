"""Small step-rule utilities: fraction-to-the-boundary and local
infeasibility detection (port of
`sleipnir_tpu/optimization/solver/util/step_rules.py`)."""

from __future__ import annotations

import torch


def fraction_to_the_boundary(x: torch.Tensor, p: torch.Tensor, tau) -> torch.Tensor:
    """α = max(α ∈ (0, 1] : x + αp ≥ (1−τ)x) for positive x
    (reference solver/util/fraction_to_the_boundary_rule.hpp:20-43)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return one
    neg = p < 0.0
    ratios = torch.where(neg, -tau * x / torch.where(neg, p, -one), torch.inf)
    return torch.minimum(one, torch.min(ratios))


def is_equality_locally_infeasible(A_e: torch.Tensor, c_e: torch.Tensor) -> torch.Tensor:
    """Aₑᵀcₑ → 0 while ‖cₑ‖ > ε
    (reference solver/util/is_locally_infeasible.hpp:18-30)."""
    if c_e.shape[0] == 0:
        return torch.zeros((), dtype=torch.bool, device=c_e.device)
    return (torch.linalg.norm(A_e.T @ c_e) < 1e-6) & (torch.linalg.norm(c_e) > 1e-2)


def is_inequality_locally_infeasible(A_i: torch.Tensor, c_i: torch.Tensor) -> torch.Tensor:
    """Aᵢᵀcᵢ⁺ → 0 while ‖cᵢ⁺‖ > ε where cᵢ⁺ = min(cᵢ, 0)
    (reference solver/util/is_locally_infeasible.hpp:33-61)."""
    if c_i.shape[0] == 0:
        return torch.zeros((), dtype=torch.bool, device=c_i.device)
    c_i_plus = torch.clamp(c_i, max=0.0)
    return (torch.linalg.norm(A_i.T @ c_i_plus) < 1e-6) & (torch.linalg.norm(c_i_plus) > 1e-6)
