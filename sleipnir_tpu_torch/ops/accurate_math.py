"""fdlibm sine, cosine and tangent in plain torch ops.

Port of `sleipnir_tpu/ops/accurate_math.py`: Cody-Waite argument reduction
plus the fdlibm kernel polynomials. The JAX CPU reference evaluates
cart-pole's trig through these, so the port does too, and its trajectories
round the same way. Accuracy is ~1 ulp for |x| ≤ ~2^20.

`sin` and `cos` are `torch.autograd.Function`s whose derivative rules call
each other (the JAX version's `custom_jvp`), with `jvp` for forward mode
and a generated vmap rule, so they compose under `torch.func.grad`, `jvp`,
`jacfwd` and `vmap`. Both `torch.round` and `jnp.round` round half to even.
"""

from __future__ import annotations

import torch

# 2/π and the Cody-Waite split of π/2 (fdlibm constants)
_INV_PIO2 = 6.36619772367581382433e-01
_PIO2_1 = 1.57079632673412561417e00  # first 33 bits of π/2
_PIO2_1T = 6.07710050650619224932e-11  # π/2 − PIO2_1
_PIO2_2T = 2.02226624879595063154e-21  # next correction term

# fdlibm __kernel_sin coefficients on [-π/4, π/4]
_S1 = -1.66666666666666324348e-01
_S2 = 8.33333333332248946124e-03
_S3 = -1.98412698298579493134e-04
_S4 = 2.75573137070700676789e-06
_S5 = -2.50507602534068634195e-08
_S6 = 1.58969099521155010221e-10

# fdlibm __kernel_cos coefficients
_C1 = 4.16666666666666019037e-02
_C2 = -1.38888888888741095749e-03
_C3 = 2.48015872894767294178e-05
_C4 = -2.75573143513906633035e-07
_C5 = 2.08757232129817482790e-09
_C6 = -1.13596475577881948265e-11


def _reduce(x):
    """x = k·(π/2) + r with |r| ≤ π/4 + ulp; returns (r, n=k mod 4)."""
    k = torch.round(x * _INV_PIO2)
    # Three-term compensated subtraction: exact while |k| < 2^27.
    r = x - k * _PIO2_1
    r = r - k * _PIO2_1T
    r = r - k * _PIO2_2T
    n = k - 4.0 * torch.floor(k * 0.25)
    return r, n


def _kernel_sin(r):
    z = r * r
    p = _S6
    for c in (_S5, _S4, _S3, _S2, _S1):
        p = p * z + c
    return r + r * z * p


def _kernel_cos(r):
    z = r * r
    p = _C6
    for c in (_C5, _C4, _C3, _C2, _C1):
        p = p * z + c
    return 1.0 - 0.5 * z + z * z * p


def _quadrant(n, q0, q1, q2, q3):
    return torch.where(
        n == 0.0, q0, torch.where(n == 1.0, q1, torch.where(n == 2.0, q2, q3))
    )


def _sin_impl(x):
    if x.dtype != torch.float64:
        return torch.sin(x)
    r, n = _reduce(x)
    s, c = _kernel_sin(r), _kernel_cos(r)
    return _quadrant(n, s, c, -s, -c)


def _cos_impl(x):
    if x.dtype != torch.float64:
        return torch.cos(x)
    r, n = _reduce(x)
    s, c = _kernel_sin(r), _kernel_cos(r)
    return _quadrant(n, c, -s, -c, s)


class _Sin(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _sin_impl(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return cos(x) * grad

    @staticmethod
    def jvp(ctx, x_t):
        (x,) = ctx.saved_tensors
        return cos(x) * x_t


class _Cos(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _cos_impl(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return -sin(x) * grad

    @staticmethod
    def jvp(ctx, x_t):
        (x,) = ctx.saved_tensors
        return -sin(x) * x_t


def sin(x):
    """f64-accurate sine (plain torch.sin for other dtypes)."""
    return _Sin.apply(torch.as_tensor(x, dtype=torch.float64))


def cos(x):
    """f64-accurate cosine (plain torch.cos for other dtypes)."""
    return _Cos.apply(torch.as_tensor(x, dtype=torch.float64))


def tan(x):
    """Tangent via the accurate sin/cos pair (≤2 ulp)."""
    return sin(x) / cos(x)
