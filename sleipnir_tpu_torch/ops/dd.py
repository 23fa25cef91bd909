"""Double-float ("double-double" on f32) arithmetic in plain torch ops.

A copy of `sleipnir_tpu/ops/dd.py` on torch tensors, operation for
operation: the error-free transforms (Knuth's two_sum, Dekker's two_prod
with splitting) and the QD library's add/mul/div compositions. A value is
a pair (hi, lo) of float32 tensors with x = hi + lo.

The TPU kernels compute in this arithmetic because the TPU has no f64;
the port's solver runs in native f64 and does not use it. Here it is the
plain version of the precision probe (`ops/cuda_dd_probe.py`,
`csrc/dd_probe.cu`), which runs the same primitives in a CUDA kernel
built without FMA contraction: every step below is one IEEE float32
operation, so the kernel must agree with this module bit for bit.
"""

from __future__ import annotations

import torch

#: Dekker split constant for f32 (24-bit mantissa, split at 12 bits).
_SPLIT = 4097.0


def two_sum(a, b):
    """s + err = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err = a + b exactly, assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err = a * b exactly (Dekker product with splitting)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add2(xh, xl, yh, yl):
    """Accurate double-float addition (QD ieee_add)."""
    s1, s2 = two_sum(xh, yh)
    t1, t2 = two_sum(xl, yl)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def sub2(xh, xl, yh, yl):
    return add2(xh, xl, -yh, -yl)


def mul2(xh, xl, yh, yl):
    """Double-float multiplication (QD mul)."""
    p1, p2 = two_prod(xh, yh)
    p2 = p2 + (xh * yl + xl * yh)
    return quick_two_sum(p1, p2)


def div2(xh, xl, yh, yl):
    """Double-float division: two Newton corrections of the f32 quotient
    (QD accurate div). y == 0 is guarded to 1."""
    yh_safe = torch.where(yh == 0.0, 1.0, yh)
    yl_safe = torch.where(yh == 0.0, 0.0, yl)
    q1 = xh / yh_safe
    # r = x - q1*y
    th, tl = mul2(q1, torch.zeros_like(q1), yh_safe, yl_safe)
    rh, rl = sub2(xh, xl, th, tl)
    q2 = rh / yh_safe
    th, tl = mul2(q2, torch.zeros_like(q2), yh_safe, yl_safe)
    rh, _rl = sub2(rh, rl, th, tl)
    q3 = rh / yh_safe
    q1, q2 = quick_two_sum(q1, q2)
    return add2(q1, q2, q3, torch.zeros_like(q3))


def from_f64(x):
    """Split an f64 tensor into an exact (hi, lo) f32 pair."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def to_f64(hi, lo):
    """Recombine a (hi, lo) pair into f64."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def tf32_truncate(x):
    """float32 x truncated to its 11 leading significant bits, the
    precision of a TF32 operand: the low 13 bits of a normal number's
    field cleared, or of a subnormal's every bit 11 or more below its
    leading one (the probe kernel's `trunc11`)."""
    bits = x.view(torch.int32)
    field = bits & 0x7FFFFF
    # frexp of a positive integer below 2^23 is exact: lead = exponent - 1
    lead = torch.frexp(field.to(torch.float32)).exponent - 1
    shift = torch.clamp(lead - 10, min=0)
    subnormal_low = torch.bitwise_left_shift(torch.ones_like(bits), shift) - 1
    clear = torch.where((bits & 0x7F800000) != 0, 0x1FFF, subnormal_low)
    return (bits & ~clear).view(torch.float32)


def tf32_split(x):
    """x = x1 + x2 + x3 with each part of at most 11 significant bits: the
    three TF32 passes of the probe kernel's exact one-hot product."""
    x1 = tf32_truncate(x)
    r = x - x1
    x2 = tf32_truncate(r)
    return x1, x2, r - x2


def onehot_product(P, X):
    """P @ X for (w, w) float32 matrices, summed over the inner index in
    order, one multiply and one add at a time (the probe kernel's order)."""
    acc = torch.zeros((P.shape[0], X.shape[1]), dtype=torch.float32, device=X.device)
    for j in range(P.shape[1]):
        acc = acc + P[:, j : j + 1] * X[j : j + 1, :]
    return acc
