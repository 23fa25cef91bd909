"""Unpivoted LDLᵀ of symmetric matrices, batched over leading axes.

Port of `sleipnir_tpu/ops/ldlt.py`: `ldlt_unblocked` for small blocks
(the banded backend's inertia pivots and the diagonal blocks here),
`ldlt_factor`, the blocked right-looking factorization the dense KKT
backend uses, `ldlt_solve` and `inertia`. The factorization is
*unpivoted*: its D vector exposes the matrix's inertia by Sylvester's law
(reference solver/util/inertia.hpp:40-50), which the δ/γ regularization
reads; the callers regularize toward quasi-definiteness whenever the
inertia is wrong, the regime in which unpivoted LDLᵀ is well posed.
`torch.linalg.ldl_factor` pivots (Bunch-Kaufman), which gives other d
and so other inertia decisions, and is not used.

The blocked algorithm is the JAX package's: each 128-column diagonal
block by 128 rank-1 updates, the panel below it by a triangular solve,
and the trailing matrix by one matrix product per block. The triangular
solves and products are torch calls, as they are XLA calls there.
"""

from __future__ import annotations

import torch

#: Columns per diagonal block of the blocked factorization.
BLOCK = 128


def ldlt_unblocked(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted LDLᵀ of symmetric blocks A (..., b, b).

    Returns (L unit-lower (..., b, b), d (..., b)). A zero pivot leaves
    its column of L at zero, as in the JAX version.
    """
    b = A.shape[-1]
    idx = torch.arange(b, device=A.device)
    L = torch.zeros_like(A)
    d = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    for j in range(b):
        dj = A[..., j, j]
        dj_safe = torch.where(dj == 0.0, torch.ones_like(dj), dj)
        lcol = torch.where(
            idx > j, A[..., :, j] / dj_safe[..., None], torch.zeros_like(A[..., :, j])
        )
        L[..., :, j] = lcol + (idx == j).to(A.dtype)
        d[..., j] = dj
        A = A - dj[..., None, None] * (lcol[..., :, None] * lcol[..., None, :])
    return L, d


def ldlt_factor(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor symmetric A (..., n, n) = L·diag(d)·Lᵀ with L unit lower
    triangular. Returns (L, d); no pivoting (see the module docstring)."""
    n = A.shape[-1]
    if n <= BLOCK:
        return ldlt_unblocked(A)
    L = torch.zeros_like(A)
    d = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    trailing = A
    for k in range(0, n, BLOCK):
        kb = min(BLOCK, n - k)
        Lkk, dk = ldlt_unblocked(trailing[..., :kb, :kb])
        d[..., k : k + kb] = dk
        L[..., k : k + kb, k : k + kb] = Lkk
        if k + kb < n:
            panel = trailing[..., kb:, :kb]
            # L_kk Xᵀ = panelᵀ, so X = panel L_kk⁻ᵀ; L21 = X D⁻¹
            X = torch.linalg.solve_triangular(Lkk, panel.transpose(-1, -2), upper=False)
            X = X.transpose(-1, -2)
            dk_safe = torch.where(dk == 0.0, torch.ones_like(dk), dk)
            L21 = X / dk_safe[..., None, :]
            L[..., k + kb :, k : k + kb] = L21
            trailing = trailing[..., kb:, kb:] - (L21 * dk[..., None, :]) @ L21.transpose(-1, -2)
    return L, d


def ldlt_solve(L: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L·diag(d)·Lᵀ x = b for b (n,) or (n, r), given an
    `ldlt_factor` result of one matrix."""
    if L.shape[-1] == 0:
        return b
    vector = b.dim() == 1
    rhs = b[:, None] if vector else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    d_safe = torch.where(d == 0.0, torch.ones_like(d), d)
    y = y / d_safe[:, None]
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[:, 0] if vector else x


def inertia(d: torch.Tensor, eps: float):
    """Count (positive, negative, zero) entries of the LDLᵀ D vector over
    its last axis (reference solver/util/inertia.hpp:40-50)."""
    positive = torch.sum(d > eps, dim=-1)
    negative = torch.sum(d < -eps, dim=-1)
    zero = d.shape[-1] - positive - negative
    return positive, negative, zero
