"""The port's solver utilities against the JAX package on the same random
inputs: the step filter (acceptance, augmentation, eviction, reset), the
KKT error measures and the fraction-to-the-boundary rule."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sleipnir_tpu.optimization.solver.funcs import ScalingArrays as JScaling
from sleipnir_tpu.optimization.solver.util import filter as jfl
from sleipnir_tpu.optimization.solver.util import kkt_error as jke
from sleipnir_tpu.optimization.solver.util import step_rules as jsr
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays as TScaling
from sleipnir_tpu_torch.optimization.solver.util import filter as tfl
from sleipnir_tpu_torch.optimization.solver.util import kkt_error as tke
from sleipnir_tpu_torch.optimization.solver.util import step_rules as tsr

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_filters_equal(tf, jf):
    for name in tf._fields:
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_filter_sequence_matches_jax(seed):
    """A random sequence of trials, with filter resets and nonfinite
    trials."""
    rng = np.random.default_rng(seed)
    v0 = float(rng.uniform(0.1, 10.0))
    jf, tf = jfl.make_filter(jnp.asarray(v0), jnp.float64), tfl.make_filter(_t(v0))
    _assert_filters_equal(tf, jf)
    accepted = 0
    for step in range(400):
        cost, viol = rng.normal(0.0, 5.0), abs(rng.normal(0.0, 2.0))
        trial_cost = cost + rng.normal(0.0, 1.0) * 10.0 ** rng.uniform(-8, 0)
        trial_viol = abs(viol + rng.normal(0.0, 1.0) * 10.0 ** rng.uniform(-8, 0))
        if step % 37 == 5:
            trial_cost = np.nan
        D_phi = rng.normal(0.0, 1.0) * 10.0 ** rng.uniform(-6, 2)
        alpha = 0.5 ** rng.integers(0, 10)
        args = (cost, viol, trial_cost, trial_viol, D_phi, alpha)
        ja, jf = jfl.try_add(jf, *(jnp.asarray(a) for a in args))
        ta, tf = tfl.try_add(tf, *(_t(a) for a in args))
        assert bool(ta) == bool(ja)
        _assert_filters_equal(tf, jf)
        accepted += bool(ta)
        if step % 101 == 100:
            jf, tf = jfl.reset_filter(jf), tfl.reset_filter(tf)
            _assert_filters_equal(tf, jf)
    assert accepted > 0


def test_filter_eviction_matches_jax():
    """More mutually non-dominated entries than the filter holds: the
    worst-violation slot is overwritten, as in the JAX package."""
    jf = jfl.make_filter(jnp.asarray(1.0), jnp.float64)
    tf = tfl.make_filter(_t(1.0))
    n = tfl.MAX_FILTER_ENTRIES + 20
    costs = np.linspace(-5.0, 5.0, n)
    viols = np.linspace(3.0, 0.1, n)
    for c, v in zip(costs, viols):
        jf = jfl._add_entry(jf, jnp.asarray(c), jnp.asarray(v))
        tf = tfl._add_entry(tf, _t(c), _t(v))
        _assert_filters_equal(tf, jf)
    assert bool(tf.valid.all())
    # An entry that dominates everything evicts all the others.
    jf = jfl._add_entry(jf, jnp.asarray(-10.0), jnp.asarray(0.0))
    tf = tfl._add_entry(tf, _t(-10.0), _t(0.0))
    _assert_filters_equal(tf, jf)
    assert int(tf.valid.sum()) == 1


def test_batched_acceptance_matches_jax_scalar_calls():
    """check_acceptance over a batch of α (the line-search ladder) equals
    the JAX package's predicate applied one trial at a time."""
    rng = np.random.default_rng(7)
    jf = jfl.make_filter(jnp.asarray(2.0), jnp.float64)
    tf = tfl.make_filter(_t(2.0))
    for _ in range(20):  # fill some entries
        c, v = rng.normal(), abs(rng.normal())
        args = (c, v, c - 1e-3, v * 0.5, -1.0, 1.0)
        _, jf = jfl.try_add(jf, *(jnp.asarray(a) for a in args))
        _, tf = tfl.try_add(tf, *(_t(a) for a in args))
    alphas = 0.5 ** np.arange(1, 25)
    tcosts = rng.normal(0.0, 1.0, 24)
    tviols = np.abs(rng.normal(0.0, 1.0, 24))
    got = tfl.check_acceptance(tf, _t(0.3), _t(0.8), _t(tcosts), _t(tviols), _t(-0.2), _t(alphas))
    for j in range(24):
        want = jfl.check_acceptance(
            jf, jnp.asarray(0.3), jnp.asarray(0.8), jnp.asarray(tcosts[j]),
            jnp.asarray(tviols[j]), jnp.asarray(-0.2), jnp.asarray(alphas[j]),
        )
        assert [bool(g[j]) for g in got] == [bool(w) for w in want]


@pytest.mark.parametrize("me,mi", [(0, 7), (5, 0), (6, 9)])
def test_kkt_errors_match_jax(me, mi):
    rng = np.random.default_rng(me * 10 + mi)
    n = 8
    g, AeT_y, AiT_z = rng.normal(size=(3, n))
    c_e, y = rng.normal(size=(2, me))
    c_i = rng.normal(size=mi)
    s, z = rng.uniform(0.1, 2.0, size=(2, mi))
    mu = 0.03
    sc = (1.7, rng.uniform(0.5, 2.0, me), rng.uniform(0.5, 2.0, mi))
    vals = (g, AeT_y, AiT_z, c_e, c_i, s, y, z, mu)
    for tfn, jfn in [
        (tke.kkt_error_ipm_inf_products, jke.kkt_error_ipm_inf_products),
        (tke.kkt_error_ipm_one_products, jke.kkt_error_ipm_one_products),
    ]:
        got = float(tfn(*(_t(v) for v in vals)))
        want = float(jfn(*(jnp.asarray(v) for v in vals)))
        assert got == pytest.approx(want, rel=1e-15, abs=0.0)
    got = float(tke.unscaled_kkt_error_ipm_products(TScaling(*(_t(a) for a in sc)), *(_t(v) for v in vals)))
    want = float(jke.unscaled_kkt_error_ipm_products(JScaling(*(jnp.asarray(a) for a in sc)), *(jnp.asarray(v) for v in vals)))
    assert got == pytest.approx(want, rel=1e-15, abs=0.0)


def test_fraction_to_the_boundary_matches_jax():
    rng = np.random.default_rng(2)
    for size in (0, 1, 50):
        x = rng.uniform(0.01, 3.0, size)
        p = rng.normal(0.0, 3.0, size)
        for tau in (0.99, 0.995):
            got = float(tsr.fraction_to_the_boundary(_t(x), _t(p), tau))
            want = float(jsr.fraction_to_the_boundary(jnp.asarray(x), jnp.asarray(p), tau))
            assert got == want
    # A step that never decreases x allows the full step.
    assert float(tsr.fraction_to_the_boundary(_t(np.ones(3)), _t(np.ones(3)), 0.99)) == 1.0
