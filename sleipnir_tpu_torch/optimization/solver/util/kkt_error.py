"""KKT error measures of the Newton, SQP and interior-point solvers (port
of `sleipnir_tpu/optimization/solver/util/kkt_error.py`; reference
solver/util/kkt_error.hpp:30-251).

Scaled ∞-norm errors follow equation (5) of Wächter-Biegler (s_d, s_c
normalizers with s_max = 100); the 1-norm variants serve the line search's
accept-if-KKT-error-reduced fallback. The banded backend never builds Aₑ
or Aᵢ, so the solvers call the `_products` variants, which take the
products Aₑᵀy and Aᵢᵀz; the others take the dense Jacobians, as the JAX
package's do, and form the products for them.
"""

from __future__ import annotations

import torch

S_MAX = 100.0


def _inf_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(v)) if v.shape[0] > 0 else v.new_zeros(())


def _one_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(v)) if v.shape[0] > 0 else v.new_zeros(())


def _clamp_low(v: torch.Tensor, low: float) -> torch.Tensor:
    return torch.clamp(v, min=low)


def kkt_error_newton_inf(g):
    return _inf_norm(g)


def kkt_error_newton_one(g):
    return _one_norm(g)


def kkt_error_sqp_inf(g, A_e, c_e, y):
    if c_e.shape[0] == 0:
        return _inf_norm(g)
    s_d = _clamp_low(_one_norm(y) / c_e.shape[0], S_MAX) / S_MAX
    return torch.maximum(_inf_norm(g - A_e.T @ y) / s_d, _inf_norm(c_e))


def kkt_error_sqp_one(g, A_e, c_e, y):
    return kkt_error_sqp_one_products(g, A_e.T @ y, c_e, y)


def kkt_error_ipm_inf(g, A_e, c_e, A_i, c_i, s, y, z, mu):
    return kkt_error_ipm_inf_products(g, A_e.T @ y, A_i.T @ z, c_e, c_i, s, y, z, mu)


def kkt_error_ipm_one(g, A_e, c_e, A_i, c_i, s, y, z, mu):
    return kkt_error_ipm_one_products(g, A_e.T @ y, A_i.T @ z, c_e, c_i, s, y, z, mu)


# -- Unscaled variants (un-apply the problem scaling before measuring:
#    reference kkt_error.hpp:155-251) --------------------------------------


def unscaled_kkt_error_newton(scaling, g):
    return kkt_error_newton_inf(g / scaling.f)


def unscaled_kkt_error_sqp(scaling, g, A_e, c_e, y):
    if c_e.shape[0] == 0:
        return unscaled_kkt_error_newton(scaling, g)
    inv_d_f = 1.0 / scaling.f
    inv_d_c_e = 1.0 / scaling.c_e
    return kkt_error_sqp_inf(
        inv_d_f * g,
        inv_d_c_e[:, None] * A_e,
        inv_d_c_e * c_e,
        scaling.c_e * y * inv_d_f,
    )


def unscaled_kkt_error_ipm(scaling, g, A_e, c_e, A_i, c_i, s, y, z, mu):
    inv_d_f = 1.0 / scaling.f
    inv_d_c_e = 1.0 / scaling.c_e
    inv_d_c_i = 1.0 / scaling.c_i
    return kkt_error_ipm_inf(
        inv_d_f * g,
        inv_d_c_e[:, None] * A_e if c_e.shape[0] > 0 else A_e,
        inv_d_c_e * c_e,
        inv_d_c_i[:, None] * A_i if c_i.shape[0] > 0 else A_i,
        inv_d_c_i * c_i,
        inv_d_c_i * s,
        scaling.c_e * y * inv_d_f,
        scaling.c_i * z * inv_d_f,
        inv_d_f * mu,
    )


# -- Product-based variants ------------------------------------------------


def kkt_error_sqp_one_products(g, AeT_y, c_e, y):
    """1-norm SQP error from the precomputed Aₑᵀy product."""
    if c_e.shape[0] == 0:
        return _one_norm(g)
    return _one_norm(g - AeT_y) + _one_norm(c_e)


def unscaled_kkt_error_sqp_products(scaling, g, AeT_y, c_e, y):
    """Unscaled ∞-norm SQP error from transpose products (the rescaling of
    `unscaled_kkt_error_ipm_products` without inequalities)."""
    if c_e.shape[0] == 0:
        return unscaled_kkt_error_newton(scaling, g)
    inv_d_f = 1.0 / scaling.f
    grad = (g - AeT_y) * inv_d_f
    c_e_u = c_e / scaling.c_e
    y_u = scaling.c_e * y * inv_d_f
    s_d = _clamp_low(_one_norm(y_u) / c_e.shape[0], S_MAX) / S_MAX
    return torch.maximum(_inf_norm(grad) / s_d, _inf_norm(c_e_u))


def kkt_error_ipm_inf_products(g, AeT_y, AiT_z, c_e, c_i, s, y, z, mu):
    m = c_e.shape[0] + c_i.shape[0]
    s_d = _clamp_low((_one_norm(y) + _one_norm(z)) / max(m, 1), S_MAX) / S_MAX
    s_c = _clamp_low(_one_norm(z) / max(c_i.shape[0], 1), S_MAX) / S_MAX
    grad = g - AeT_y - AiT_z
    terms = [_inf_norm(grad) / s_d]
    if c_i.shape[0] > 0:
        terms.append(_inf_norm(s * z - mu) / s_c)
    if c_e.shape[0] > 0:
        terms.append(_inf_norm(c_e))
    if c_i.shape[0] > 0:
        terms.append(_inf_norm(c_i - s))
    return torch.max(torch.stack(terms))


def kkt_error_ipm_one_products(g, AeT_y, AiT_z, c_e, c_i, s, y, z, mu):
    total = _one_norm(g - AeT_y - AiT_z)
    if c_i.shape[0] > 0:
        total = total + _one_norm(s * z - mu)
    if c_e.shape[0] > 0:
        total = total + _one_norm(c_e)
    if c_i.shape[0] > 0:
        total = total + _one_norm(c_i - s)
    return total


def unscaled_kkt_error_ipm_products(scaling, g, AeT_y, AiT_z, c_e, c_i, s, y, z, mu):
    """Unscaled ∞-norm error from transpose products.

    With A stored row-scaled (A_scaled = D_c A), every unscaled component
    is a row rescale of the scaled vectors: the stationarity term is
    (g − Aₑᵀy − Aᵢᵀz)/d_f, complementarity (sz − μ)/d_f, constraints
    c/d_c (reference kkt_error.hpp:216-251 algebra).
    """
    inv_d_f = 1.0 / scaling.f
    grad = (g - AeT_y - AiT_z) * inv_d_f
    c_e_u = c_e / scaling.c_e if c_e.shape[0] > 0 else c_e
    c_i_u = c_i / scaling.c_i if c_i.shape[0] > 0 else c_i
    s_u = s / scaling.c_i if c_i.shape[0] > 0 else s
    y_u = scaling.c_e * y * inv_d_f if c_e.shape[0] > 0 else y
    z_u = scaling.c_i * z * inv_d_f if c_i.shape[0] > 0 else z
    mu_u = mu * inv_d_f

    m = c_e.shape[0] + c_i.shape[0]
    s_d = _clamp_low((_one_norm(y_u) + _one_norm(z_u)) / max(m, 1), S_MAX) / S_MAX
    s_c = _clamp_low(_one_norm(z_u) / max(c_i.shape[0], 1), S_MAX) / S_MAX

    terms = [_inf_norm(grad) / s_d]
    if c_i.shape[0] > 0:
        terms.append(_inf_norm(s_u * z_u - mu_u) / s_c)
    if c_e.shape[0] > 0:
        terms.append(_inf_norm(c_e_u))
    if c_i.shape[0] > 0:
        terms.append(_inf_norm(c_i_u - s_u))
    return torch.max(torch.stack(terms))
