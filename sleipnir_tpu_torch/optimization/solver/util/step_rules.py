"""Fraction-to-the-boundary rule (port of
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
