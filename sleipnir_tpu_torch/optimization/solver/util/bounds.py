"""Bound-constraint detection and projection
(reference solver/util/bounds.hpp:55-231).

A "bound constraint" is any linear inequality constraint in one scalar
variable. Detection runs host-side at setup (structure/trace time, per
SURVEY.md §7 "hard parts"), using the constraint Jacobian at the starting
point plus per-row linearity tags from the expression DAG.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Bounds:
    """Bound constraint metadata (reference bounds.hpp:26-37)."""

    #: Which inequality constraint rows are bound constraints.
    bound_constraint_mask: np.ndarray
    #: (lower, upper) for each decision variable.
    lower: np.ndarray
    upper: np.ndarray
    #: Pairs of conflicting bound constraint row indices (empty = feasible).
    conflicting_bound_indices: list


def get_bounds(
    x0: np.ndarray,
    c_i0: np.ndarray,
    A_i0: np.ndarray,
    row_is_linear: np.ndarray,
) -> Bounds:
    """Detect bound constraints among the inequality rows.

    `c_i0`/`A_i0` are the inequality constraints and their Jacobian at `x0`;
    `row_is_linear` marks rows whose expressions are LINEAR. For a linear
    single-variable row c(x) = a·xⱼ + b ≥ 0, the bound is −b/a with
    b = c(x₀) − a·x₀ⱼ (reference bounds.hpp:114-167).
    """
    n = x0.shape[0]
    mi = c_i0.shape[0]
    lower = np.full(n, -math.inf)
    upper = np.full(n, math.inf)
    lower_idx = np.full(n, -1, dtype=np.int64)
    upper_idx = np.full(n, -1, dtype=np.int64)
    mask = np.zeros(mi, dtype=bool)
    conflicts: list[tuple[int, int]] = []

    nnz_per_row = np.count_nonzero(A_i0, axis=1) if mi else np.zeros(0)

    for row in range(mi):
        if not row_is_linear[row] or nnz_per_row[row] != 1:
            continue
        j = int(np.nonzero(A_i0[row])[0][0])
        a = A_i0[row, j]
        b = c_i0[row] - a * x0[j]
        if not (np.isfinite(a) and np.isfinite(b)) or a == 0.0:
            continue
        detected = -b / a
        if a < 0.0 and detected < upper[j]:
            upper[j] = detected
            upper_idx[j] = row
        elif a > 0.0 and detected > lower[j]:
            lower[j] = detected
            lower_idx[j] = row
        if lower[j] > upper[j]:
            conflicts.append((int(lower_idx[j]), int(upper_idx[j])))
        mask[row] = True

    return Bounds(
        bound_constraint_mask=mask,
        lower=lower,
        upper=upper,
        conflicting_bound_indices=conflicts,
    )


def get_bounds_rows(
    x0: np.ndarray,
    c_i0: np.ndarray,
    ci_cols: np.ndarray,
    ci_vals: np.ndarray,
    row_is_linear: np.ndarray,
) -> Bounds:
    """Bound detection from per-row sparse Jacobian data — the matrix-free
    setup path for stage-structured problems. `ci_cols`/`ci_vals` are
    (mi, w) arrays giving each inequality row's candidate column indices
    and coefficients (reference bounds.hpp:55-184 works off sparse row
    iterators the same way)."""
    n = x0.shape[0]
    mi = c_i0.shape[0]
    lower = np.full(n, -math.inf)
    upper = np.full(n, math.inf)
    lower_idx = np.full(n, -1, dtype=np.int64)
    upper_idx = np.full(n, -1, dtype=np.int64)
    mask = np.zeros(mi, dtype=bool)
    conflicts: list[tuple[int, int]] = []

    for row in range(mi):
        if not row_is_linear[row]:
            continue
        nz = np.nonzero(ci_vals[row])[0]
        if nz.shape[0] != 1:
            continue
        j = int(ci_cols[row, nz[0]])
        a = ci_vals[row, nz[0]]
        b = c_i0[row] - a * x0[j]
        if not (np.isfinite(a) and np.isfinite(b)) or a == 0.0:
            continue
        detected = -b / a
        if a < 0.0 and detected < upper[j]:
            upper[j] = detected
            upper_idx[j] = row
        elif a > 0.0 and detected > lower[j]:
            lower[j] = detected
            lower_idx[j] = row
        if lower[j] > upper[j]:
            conflicts.append((int(lower_idx[j]), int(upper_idx[j])))
        mask[row] = True

    return Bounds(
        bound_constraint_mask=mask,
        lower=lower,
        upper=upper,
        conflicting_bound_indices=conflicts,
    )


def project_onto_bounds(
    x: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    kappa_1: float = 1e-2,
    kappa_2: float = 1e-2,
) -> np.ndarray:
    """Project x into [lower, upper] with a margin (Ipopt §3.6; reference
    bounds.hpp:195-231)."""
    out = np.array(x, dtype=np.float64)
    for i in range(out.shape[0]):
        lo, hi = lower[i], upper[i]
        if np.isfinite(lo) and np.isfinite(hi):
            p_l = min(kappa_1 * max(1.0, abs(lo)), kappa_2 * (hi - lo))
            p_u = min(kappa_1 * max(1.0, abs(hi)), kappa_2 * (hi - lo))
            out[i] = min(max(lo + p_l, out[i]), hi - p_u)
        elif np.isfinite(lo):
            out[i] = max(out[i], lo + kappa_1 * max(1.0, abs(lo)))
        elif np.isfinite(hi):
            out[i] = min(out[i], hi - kappa_1 * max(1.0, abs(hi)))
    return out
