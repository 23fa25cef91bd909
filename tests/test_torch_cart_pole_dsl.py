"""Cart-pole's DSL dynamics and `fast=False` in the port against its tensor
dynamics and the JAX package's `dynamics_dsl`
(sleipnir_tpu/models/cart_pole.py:61-78, 108-130), and the port's copies
of the JAX package's remaining KKT-error and local-infeasibility helpers
(sleipnir_tpu/optimization/solver/util/kkt_error.py, step_rules.py)
against them on seeded inputs, within 1e-12."""

import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models import cart_pole as jcp
from sleipnir_tpu.optimization.solver.util import kkt_error as jke
from sleipnir_tpu.optimization.solver.util import step_rules as jsr
from sleipnir_tpu_torch.models import cart_pole as tcp
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend
from sleipnir_tpu_torch.optimization.solver.util import kkt_error as tke
from sleipnir_tpu_torch.optimization.solver.util import step_rules as tsr

torch.set_num_threads(1)

TOL = 1e-12


def _states(count=20):
    rng = np.random.default_rng(20)
    xs = rng.uniform(-4.0, 4.0, (count, 4, 1))
    us = rng.uniform(-20.0, 20.0, (count, 1, 1))
    return xs, us


def _dsl_value(slp, model, xv, uv):
    """`dynamics_dsl` built on decision variables of a fresh problem of
    `slp`, evaluated through that package's expression graph."""
    problem = slp.Problem()
    x, u = problem.decision_variable(4, 1), problem.decision_variable(1, 1)
    x.set_value(xv)
    u.set_value(uv)
    out = model.dynamics_dsl(x, u)
    assert out.shape == (4, 1)
    return np.asarray(out.value(), dtype=np.float64).reshape(4, 1)


def test_dynamics_dsl_matches_the_tensor_dynamics():
    for xv, uv in zip(*_states()):
        want = tcp.dynamics(torch.tensor(xv), torch.tensor(uv)).numpy()
        np.testing.assert_allclose(_dsl_value(tslp, tcp, xv, uv), want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))


def test_dynamics_dsl_matches_jax():
    for xv, uv in zip(*_states()):
        want = _dsl_value(jslp, jcp, xv, uv)
        np.testing.assert_allclose(_dsl_value(tslp, tcp, xv, uv), want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))


def _solve(fast: bool):
    problem, X, U = tcp.cart_pole_problem(N=20, fast=fast)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        status = problem.solve(device="cpu")
    [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    notes = [str(w.message) for w in caught if "block-tridiagonal" in str(w.message)]
    return status, problem.last_solve_stats.iterations, X.value(), U.value(), cached[-1], notes


def test_dsl_problem_takes_the_dense_backend_and_the_fast_solution():
    """`fast=False` builds the symbolic dynamics, which the stage analysis
    cannot place: the dense backend with the JAX package's warning
    (sleipnir_tpu/optimization/problem.py:799), SUCCESS, and the same NLP's
    solution as `fast=True` on the banded backend (both 22 iterations on a
    CPU). N=20: at N=10 the problem is infeasible."""
    status, iterations, X, U, backend, notes = _solve(fast=False)
    fstatus, fiterations, fX, fU, fbackend, fnotes = _solve(fast=True)
    assert status == fstatus == tslp.ExitStatus.SUCCESS
    assert isinstance(backend, DenseBackend) and isinstance(fbackend, BandedBackend)
    assert notes == ["OCP does not fit the block-tridiagonal KKT structure (a constraint row "
                     "couples non-adjacent stages); using the dense factorization, which does "
                     "not scale with the horizon length"]
    assert fnotes == []
    assert (iterations, fiterations) == (22, 22)
    assert np.abs(X - fX).max() < 1e-6 and np.abs(U - fU).max() < 1e-6
    assert np.abs(X[:, -1] - [1.0, np.pi, 0.0, 0.0]).max() < 1e-6


# -- the helper functions ---------------------------------------------------


def _inputs(n, me, mi, seed):
    rng = np.random.default_rng(seed)
    a = {
        "g": rng.standard_normal(n), "A_e": rng.standard_normal((me, n)),
        "c_e": rng.standard_normal(me), "A_i": rng.standard_normal((mi, n)),
        "c_i": rng.standard_normal(mi), "s": rng.uniform(0.1, 2.0, mi),
        "y": 300.0 * rng.standard_normal(me), "z": rng.uniform(0.1, 500.0, mi),
        "mu": np.float64(0.3),
    }
    scaling = {"f": np.float64(0.25), "c_e": rng.uniform(0.1, 1.0, me),
               "c_i": rng.uniform(0.1, 1.0, mi)}
    return a, scaling


def _both(args, scaling):
    jax_args = {k: jnp.asarray(v) for k, v in args.items()}
    port_args = {k: torch.tensor(v) for k, v in args.items()}
    js = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in scaling.items()})
    ts = types.SimpleNamespace(**{k: torch.tensor(v) for k, v in scaling.items()})
    return jax_args, port_args, js, ts


_IPM = ("g", "A_e", "c_e", "A_i", "c_i", "s", "y", "z", "mu")
_SQP = ("g", "A_e", "c_e", "y")


@pytest.mark.parametrize("n,me,mi", [(7, 3, 4), (6, 0, 5), (5, 2, 0), (4, 0, 0)])
def test_kkt_error_helpers_match_jax(n, me, mi):
    jargs, targs, js, ts = _both(*_inputs(n, me, mi, n + 10 * me + 100 * mi))
    cases = [
        ("kkt_error_newton_inf", ("g",), False),
        ("kkt_error_sqp_inf", _SQP, False),
        ("kkt_error_sqp_one", _SQP, False),
        ("kkt_error_ipm_inf", _IPM, False),
        ("kkt_error_ipm_one", _IPM, False),
        ("unscaled_kkt_error_sqp", _SQP, True),
        ("unscaled_kkt_error_ipm", _IPM, True),
    ]
    for name, keys, scaled in cases:
        jf, tf = getattr(jke, name), getattr(tke, name)
        want = float(jf(*([js] if scaled else []), *(jargs[k] for k in keys)))
        got = tf(*([ts] if scaled else []), *(targs[k] for k in keys))
        assert got.dtype == torch.float64 and got.dim() == 0
        assert abs(float(got) - want) <= TOL * max(1.0, abs(want)), name


@pytest.mark.parametrize("case", ["random", "empty", "infeasible"])
def test_local_infeasibility_helpers_match_jax(case):
    """Both verdicts on random rows, on no rows, and where they hold: Aᵀc
    vanishes (zero Jacobians) while the violation does not."""
    rng = np.random.default_rng(4)
    rows = 0 if case == "empty" else 3
    A_e, A_i = rng.standard_normal((rows, 5)), rng.standard_normal((rows, 5))
    c_e, c_i = rng.standard_normal(rows), -np.abs(rng.standard_normal(rows))
    if case == "infeasible":
        A_e, A_i = np.zeros_like(A_e), np.zeros_like(A_i)
    for name, A, c in (("is_equality_locally_infeasible", A_e, c_e),
                       ("is_inequality_locally_infeasible", A_i, c_i)):
        want = bool(getattr(jsr, name)(jnp.asarray(A), jnp.asarray(c)))
        got = getattr(tsr, name)(torch.tensor(A), torch.tensor(c))
        assert got.dtype == torch.bool and bool(got) == want == (case == "infeasible"), name
