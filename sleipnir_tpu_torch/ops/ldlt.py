"""Unpivoted LDLᵀ of small symmetric blocks, batched over leading axes.

Port of `sleipnir_tpu/ops/ldlt.py:_ldlt_unblocked`. The factorization is
*unpivoted*: its D vector exposes the block's inertia by Sylvester's law
(reference solver/util/inertia.hpp:40-50), which is all the banded
backend needs it for.
"""

from __future__ import annotations

import torch


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
