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
    with pytest.raises(ValueError, match="w\\*w <= 1024"):
        cuda_dd_probe.onehot_product(torch.zeros(33, 33), torch.zeros(33, 33))
