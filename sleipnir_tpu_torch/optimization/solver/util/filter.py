"""Step filter (Wächter–Biegler) on device tensors.

Port of `sleipnir_tpu/optimization/solver/util/filter.py` (reference
solver/util/filter.hpp:19-212): a fixed-size array of (cost, violation)
entries with a validity mask in place of the reference's growing vector.
All decisions are tensor expressions; callers read the booleans they
branch on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_FILTER_ENTRIES = 128

# Reference filter.hpp:184-185
GAMMA_COST = 1e-8
GAMMA_CONSTRAINT = 1e-5
# Reference filter.hpp:121-122
S_PHI = 2.3
S_THETA = 1.1
# Reference filter.hpp:128
ETA_PHI = 1e-8


class FilterState(NamedTuple):
    """Filter entries plus bookkeeping scalars."""

    costs: torch.Tensor  # (MAX,)
    viols: torch.Tensor  # (MAX,)
    valid: torch.Tensor  # (MAX,) bool
    min_viol: torch.Tensor  # scalar
    max_viol: torch.Tensor  # scalar
    last_rejection_due_to_filter: torch.Tensor  # scalar bool


def make_filter(initial_constraint_violation: torch.Tensor) -> FilterState:
    """Construct an empty filter (reference filter.hpp:87-94)."""
    v0 = torch.clamp(initial_constraint_violation, min=1.0)
    zeros = v0.new_zeros((MAX_FILTER_ENTRIES,))
    return FilterState(
        costs=zeros,
        viols=zeros,
        valid=torch.zeros(MAX_FILTER_ENTRIES, dtype=torch.bool, device=v0.device),
        min_viol=1e-4 * v0,
        max_viol=1e4 * v0,
        last_rejection_due_to_filter=torch.zeros((), dtype=torch.bool, device=v0.device),
    )


def reset_filter(f: FilterState) -> FilterState:
    """Clear all entries (reference filter.hpp:97-100)."""
    return f._replace(
        valid=torch.zeros_like(f.valid),
        last_rejection_due_to_filter=torch.zeros_like(f.last_rejection_due_to_filter),
    )


def _add_entry(f: FilterState, cost, viol) -> FilterState:
    """Add an entry, evicting entries it dominates
    (reference filter.hpp:194-200). When the array is full the entry with
    the largest violation is overwritten; the filter only blocks cycling,
    so that is benign."""
    dominated = f.valid & (f.costs >= cost) & (f.viols >= viol)
    valid = f.valid & ~dominated
    free = ~valid
    first_free = torch.argmax(free.to(torch.int8))
    worst = torch.argmax(torch.where(valid, f.viols, -torch.inf))
    slot = torch.where(free.any(), first_free, worst)
    onehot = torch.arange(MAX_FILTER_ENTRIES, device=slot.device) == slot
    return f._replace(
        costs=torch.where(onehot, cost, f.costs),
        viols=torch.where(onehot, viol, f.viols),
        valid=valid | onehot,
    )


def check_acceptance(f: FilterState, current_cost, current_viol, trial_cost,
                     trial_viol, D_phi, alpha):
    """Acceptance predicate for trial iterates against this filter, with no
    state change (reference filter.hpp:109-158). Trial values and α may
    carry a leading batch axis (the batched line-search ladder). Returns
    (accepted, rejected_pre_filter, in_filter, finite, switching, armijo).
    """
    finite = torch.isfinite(trial_cost) & (trial_viol <= f.max_viol)

    # Switching condition (reference filter.hpp:121-125)
    switching = (D_phi < 0.0) & (alpha * (-D_phi) ** S_PHI > current_viol**S_THETA)

    # Armijo condition (reference filter.hpp:128-130)
    armijo = trial_cost <= current_cost + ETA_PHI * alpha * D_phi

    # Sufficient decrease (reference filter.hpp:133-141, eq (2.13) of Gu&Zhu)
    phi = alpha**1.5
    sufficient_decrease = (trial_cost <= current_cost - phi * GAMMA_COST * current_viol) | (
        trial_viol <= (1.0 - phi * GAMMA_CONSTRAINT) * current_viol
    )

    # Rejection causes (reference filter.hpp:146-155)
    use_armijo_path = (current_viol <= f.min_viol) & switching
    rejected_pre_filter = torch.where(use_armijo_path, ~armijo, ~sufficient_decrease)

    # In-filter check: dominated by any valid entry (reference filter.hpp:206-211)
    in_filter = (
        f.valid
        & (f.costs <= trial_cost[..., None])
        & (f.viols <= trial_viol[..., None])
    ).any(-1)

    accepted = finite & ~rejected_pre_filter & ~in_filter
    return accepted, rejected_pre_filter, in_filter, finite, switching, armijo


def try_add(f: FilterState, current_cost, current_viol, trial_cost, trial_viol,
            D_phi, alpha):
    """Check whether the trial iterate is acceptable, adding a filter entry
    when appropriate (reference filter.hpp:109-172). Returns
    (accepted, new_filter_state)."""
    accepted, rejected_pre_filter, in_filter, finite, switching, armijo = (
        check_acceptance(
            f, current_cost, current_viol, trial_cost, trial_viol, D_phi, alpha
        )
    )
    phi = alpha**1.5

    # Augment filter if switching or Armijo condition are false
    # (reference filter.hpp:163-169)
    augment = accepted & (~switching | ~armijo)
    augmented = _add_entry(
        f,
        current_cost - phi * GAMMA_COST * current_viol,
        (1.0 - phi * GAMMA_CONSTRAINT) * current_viol,
    )
    new_f = FilterState(
        costs=torch.where(augment, augmented.costs, f.costs),
        viols=torch.where(augment, augmented.viols, f.viols),
        valid=torch.where(augment, augmented.valid, f.valid),
        min_viol=f.min_viol,
        max_viol=f.max_viol,
        # The reference leaves the flag untouched on nonfinite rejection
        # (filter.hpp:114-118) and on acceptance.
        last_rejection_due_to_filter=torch.where(
            accepted | ~finite,
            f.last_rejection_due_to_filter,
            ~rejected_pre_filter & in_filter,
        ),
    )
    return accepted, new_f
