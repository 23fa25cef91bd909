"""Automatic problem scaling (reference solver/util/problem_scaling.hpp:21-115,
math in reference docs/algorithms.md:386-437).

Computed once at the starting point, host-side:
    d_f    = min(1, gₘₐₓ / ‖∇f(x₀)‖_∞)
    d_c[j] = min(1, gₘₐₓ / ‖∇cⱼ(x₀)‖_∞)
with gₘₐₓ = 100. Applied inside the Problem's matrix callbacks and un-applied
for the convergence test (reference problem.hpp:616-660, kkt_error.hpp).
"""

from __future__ import annotations

import dataclasses

import numpy as np

G_MAX = 100.0


@dataclasses.dataclass
class ProblemScaling:
    """Cost and constraint scaling factors."""

    f: float = 1.0
    c_e: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    c_i: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )

    @staticmethod
    def _row_scale(a: np.ndarray) -> np.ndarray:
        if a.shape[0] == 0:
            return np.zeros(0)
        return ProblemScaling._scale_from_inf(np.max(np.abs(a), axis=1))

    @staticmethod
    def _scale_from_inf(inf_norms: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.minimum(1.0, G_MAX / inf_norms)

    @classmethod
    def for_newton(cls, g: np.ndarray) -> "ProblemScaling":
        gn = np.max(np.abs(g)) if g.shape[0] else 0.0
        with np.errstate(divide="ignore"):
            f = min(1.0, G_MAX / gn) if gn > 0 else 1.0
        return cls(f=f)

    @classmethod
    def for_sqp(cls, g: np.ndarray, A_e: np.ndarray) -> "ProblemScaling":
        out = cls.for_newton(g)
        out.c_e = cls._row_scale(A_e)
        return out

    @classmethod
    def for_ipm(
        cls, g: np.ndarray, A_e: np.ndarray, A_i: np.ndarray
    ) -> "ProblemScaling":
        out = cls.for_sqp(g, A_e)
        out.c_i = cls._row_scale(A_i)
        return out

    @classmethod
    def from_row_norms(
        cls, g: np.ndarray, ce_inf: np.ndarray, ci_inf: np.ndarray
    ) -> "ProblemScaling":
        """Build scaling from precomputed per-row Jacobian ∞-norms — the
        matrix-free setup path (reference problem_scaling.hpp:58-110
        computes the same quantities from sparse triplets)."""
        out = cls.for_newton(g)
        out.c_e = cls._scale_from_inf(np.asarray(ce_inf))
        out.c_i = cls._scale_from_inf(np.asarray(ci_inf))
        return out

    def is_identity(self) -> bool:
        return (
            self.f == 1.0 and self.c_e.shape[0] == 0 and self.c_i.shape[0] == 0
        )
