"""The port's double-float primitives (`ops/dd.py`, the plain version of
the precision-probe kernels) against the JAX package's `ops/dd.py`, and
the probe's entry point on the CPU. The kernels themselves are held bit
for bit against this plain version on the card
(tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sleipnir_tpu.ops import dd as jdd
from sleipnir_tpu_torch.ops import cuda_dd_probe
from sleipnir_tpu_torch.ops import dd as tdd
from sleipnir_tpu_torch.tools import dd_probe


def _inputs():
    """The inputs of tests/ops/test_pallas_banded.py::test_dd_arithmetic_vs_f64."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000)
    b = rng.standard_normal(1000) * 10.0 ** rng.uniform(-6, 6, 1000)
    return a, b


@pytest.mark.parametrize("name,ref", [
    ("add2", np.add), ("sub2", np.subtract), ("mul2", np.multiply), ("div2", np.divide),
])
def test_dd_ops_match_jax_and_f64(name, ref):
    a, b = _inputs()
    ah, al = tdd.from_f64(torch.as_tensor(a))
    bh, bl = tdd.from_f64(torch.as_tensor(b))
    jah, jal = jdd.from_f64(jnp.asarray(a))
    jbh, jbl = jdd.from_f64(jnp.asarray(b))
    # The split into (hi, lo) is exact and the same in both packages.
    np.testing.assert_array_equal(ah.numpy(), np.asarray(jah))
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))

    out = tdd.to_f64(*getattr(tdd, name)(ah, al, bh, bl)).numpy()
    jout = np.asarray(jdd.to_f64(*getattr(jdd, name)(jah, jal, jbh, jbl)))
    exact = ref(a, b)
    # The tolerance of the JAX package's own test of these primitives.
    for value in (out, jout):
        rel = np.max(np.abs(value - exact) / np.maximum(np.abs(exact), 1e-30))
        assert rel < 1e-11, rel
    assert np.max(np.abs(out - jout) / np.maximum(np.abs(exact), 1e-30)) < 1e-11


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_error_free_transforms_are_exact(name):
    a, b = _inputs()
    a32 = torch.as_tensor(a, dtype=torch.float32)
    b32 = torch.as_tensor(b, dtype=torch.float32)
    hi, lo = getattr(tdd, name)(a32, b32)
    x, y = a32.double().numpy(), b32.double().numpy()
    exact = x + y if name == "two_sum" else x * y
    np.testing.assert_array_equal(hi.double().numpy() + lo.double().numpy(), exact)
    jhi, jlo = getattr(jdd, name)(jnp.asarray(a32.numpy()), jnp.asarray(b32.numpy()))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_onehot_product_is_exact():
    rng = np.random.default_rng(1)
    w = 13
    P = np.zeros((w, w), np.float32)
    P[np.arange(w), rng.permutation(w)] = 1.0
    X = rng.standard_normal((w, w)).astype(np.float32)
    out = tdd.onehot_product(torch.as_tensor(P), torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(out, P @ X)


def test_probe_entry_point_on_cpu_runs_the_plain_version():
    cuda_dd_probe.reset_counters()
    x = dd_probe.probe_inputs("cpu")
    out = dd_probe.run_probe(x, cuda_dd_probe.primitive, cuda_dd_probe.onehot_product)
    plain = dd_probe.run_probe(x, dd_probe.plain_primitive, tdd.onehot_product)
    assert cuda_dd_probe.LAUNCHES == 0
    assert dd_probe.bitwise_equal(out, plain)
    lines = dict(dd_probe.error_lines(x, out))
    assert list(lines) == [
        "two_sum max err", "two_prod max rel err", "add2 max rel err",
        "mul2 max rel err", "div2 max rel err", "one-hot dot max err",
    ]
    assert lines["two_sum max err"] == 0.0
    assert lines["two_prod max rel err"] == 0.0
    assert lines["one-hot dot max err"] == 0.0
    for name in ("add2", "mul2", "div2"):
        assert lines[f"{name} max rel err"] < 1e-12


def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        cuda_dd_probe.primitive("two_sum", a, a)
    with pytest.raises(ValueError, match="takes 4"):
        cuda_dd_probe.primitive("add2", a.float(), a.float())
    with pytest.raises(ValueError, match="w <= 16"):
        cuda_dd_probe.onehot_product(torch.zeros(17, 17), torch.zeros(17, 17))


def _significant_bits(values: np.ndarray) -> np.ndarray:
    """Significant bits of each float32 value: from its leading to its
    last set bit (0 for a zero)."""
    out = []
    for v in np.abs(values.astype(np.float64)):
        if v == 0.0:
            out.append(0)
            continue
        mantissa = int(np.ldexp(np.frexp(v)[0], 60))
        while mantissa % 2 == 0:
            mantissa //= 2
        out.append(mantissa.bit_length())
    return np.array(out)


def _split_cases(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    f32 = np.finfo(np.float32)
    if kind == "random":
        return (rng.standard_normal(2000) * 10.0 ** rng.uniform(-44, 37, 2000)).astype(np.float32)
    if kind == "bit-patterns":
        values = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32).view(np.float32)
        return values[np.isfinite(values)]
    return np.array(
        [0.0, -0.0, f32.max, -f32.max, f32.tiny, -f32.tiny, f32.smallest_subnormal,
         -f32.smallest_subnormal, np.nextafter(f32.tiny, np.float32(0.0)), 3e-39, -2.9e-40,
         1.0, -1.0, np.nextafter(np.float32(1.0), np.float32(2.0)), 8191.0, -16777215.0],
        np.float32,
    )


@pytest.mark.parametrize("kind", ["random", "bit-patterns", "edge"])
def test_tf32_split_parts_have_11_bits_and_sum_exactly(kind):
    """The plain version of the probe kernel's three TF32 parts: each part
    keeps at most 11 significant bits (a TF32 operand's precision), a
    normal part is a TF32 register value (its low 13 field bits are 0),
    and the parts sum back to x exactly, also in float32 in the kernel's
    order (x1 + x2) + x3. Compared by value: the sum turns -0 into +0."""
    x = _split_cases(kind)
    parts = [p.numpy() for p in tdd.tf32_split(torch.as_tensor(x))]
    for part in parts:
        assert _significant_bits(part).max() <= 11
        bits = part.view(np.uint32)
        normal = (bits & 0x7F800000) != 0
        assert np.all(bits[normal] & 0x1FFF == 0)
    x1, x2, x3 = parts
    np.testing.assert_array_equal(x1.astype(np.float64) + x2 + x3, x.astype(np.float64))
    np.testing.assert_array_equal((x1 + x2) + x3, x)
    assert np.all(np.abs(x1) <= np.abs(x))


def test_fused_probe_on_cpu_runs_the_plain_version():
    cuda_dd_probe.reset_counters()
    x = dd_probe.probe_inputs("cpu")
    out, single = dd_probe.run_fused(x)
    plain = dd_probe.run_probe(x, dd_probe.plain_primitive, tdd.onehot_product)
    assert cuda_dd_probe.LAUNCHES == 0
    assert list(out) == list(plain)
    assert dd_probe.bitwise_equal(out, plain)
    truncated = tdd.onehot_product(x["P"], tdd.tf32_truncate(x["Mh"]))
    assert torch.equal(single, truncated)
    assert 0.0 < dd_probe.tf32_single_pass_error(x, single) <= float(x["Mh"].abs().max()) * 2.0**-10
