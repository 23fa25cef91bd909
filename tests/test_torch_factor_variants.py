"""The banded backend's opt-in factor forms, SLEIPNIR_TPU_BCR (block
cyclic reduction) and SLEIPNIR_TPU_INV (the explicit-inverse partitioned
factor), in whole solves against the JAX package's under the same
variable: the flywheel at N=40 under each (JAX: SUCCESS, 12 iterations;
cart-pole under BCR is in test_torch_factor_variants_cart_pole.py). Each
variant is a fresh problem in both packages. The gates: the JAX
package's status, iterations within ±2, the solution within 1e-6, host
syncs per iteration equal to the default path's, and the factor calls of
the selected form only. Cart-pole at N=20 under SLEIPNIR_TPU_INV costs
the JAX package about two minutes, so it stays out of the tests."""

import contextlib

import numpy as np
import pytest
import torch

import sleipnir_tpu_torch as tslp
from sleipnir_tpu.models.flywheel import flywheel_problem as jax_flywheel
from sleipnir_tpu_torch.models.flywheel import flywheel_problem, oracle_failures
from sleipnir_tpu_torch.ops import cuda_banded

torch.set_num_threads(1)

FLYWHEEL_N = 40
TOTAL_TIME = 5.0
VARIABLES = {"bcr": "SLEIPNIR_TPU_BCR", "inv": "SLEIPNIR_TPU_INV"}


def _trajectory(X, U) -> np.ndarray:
    return np.concatenate([np.ravel(X.value()), np.ravel(U.value())])


@contextlib.contextmanager
def _unset():
    """Neither variable set, until the block ends."""
    with pytest.MonkeyPatch.context() as mp:
        for name in VARIABLES.values():
            mp.delenv(name, raising=False)
        yield mp


def port_solve(problem, X, U):
    """The port's solve of a fresh problem under the environment as it
    stands: (status, iterations, host syncs per iteration, trajectory,
    backend, K1/K2 twin calls by shape)."""
    cuda_banded.reset_counters()
    status = problem.solve(device="cpu")
    [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    stats = problem.last_solve_stats
    return (status, stats.iterations, stats.host_syncs_per_iteration, _trajectory(X, U),
            cached[-1], dict(cuda_banded.PLAIN_BY_SHAPE))


def jax_solve(problem, X, U):
    """The JAX package's solve: (status, iterations, trajectory)."""
    status = problem.solve()
    return int(status), int(problem._last_state.iterations), _trajectory(X, U)


def check_default(default, iterations):
    """With neither variable set the CPU backend keeps the chain (the
    twin of K1/K2 at the whole horizon), as before the variants."""
    status, its, _syncs, _x, backend, calls = default
    assert status == tslp.ExitStatus.SUCCESS and its == iterations
    assert (backend.use_bcr, backend.use_inv, backend.use_partitioned) == (False,) * 3
    K, w = backend.K, backend.w
    assert calls[("factor", 4, K, w)] > 0 and calls[("solve", 1, K, w)] > 0


def check_variant(form, port, jax, default):
    """The port's solve under `form` against the JAX package's and the
    port's default path."""
    status, iterations, syncs, x, backend, calls = port
    jstatus, jiterations, jx = jax
    assert int(status) == jstatus == int(tslp.ExitStatus.SUCCESS)
    assert abs(iterations - jiterations) <= 2
    assert np.abs(x - jx).max() < 1e-6
    # No host read inside the factor: the same syncs per iteration as the
    # default path, which takes the same iterations.
    assert iterations == default[1]
    assert syncs == default[2]
    assert (backend.use_bcr, backend.use_inv) == (form == "bcr", form == "inv")
    if form == "bcr":
        # Only the coarsest two blocks reach K1/K2 (their twin here).
        assert calls[("factor", 4, 2, backend.w)] > 0 and calls[("solve", 1, 2, backend.w)] > 0
        assert {K for _kind, _B, K, _w in calls} == {2}
    else:
        assert calls == {}  # the explicit inverse is plain torch throughout


def _flywheels():
    return (jax_flywheel(N=FLYWHEEL_N, total_time=TOTAL_TIME),
            flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME))


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's flywheel under each variable, solved once."""
    out = {}
    for form, name in VARIABLES.items():
        with _unset() as mp:
            mp.setenv(name, "1")
            out[form] = jax_solve(*_flywheels()[0])
    return out


@pytest.fixture(scope="module")
def port_default():
    with _unset():
        return port_solve(*_flywheels()[1])


def test_default_path_takes_the_chain(port_default):
    check_default(port_default, 12)


@pytest.mark.parametrize("form", ["bcr", "inv"])
def test_variant_matches_jax(form, jax_solves, port_default, monkeypatch):
    for name in VARIABLES.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(VARIABLES[form], "1")
    port = port_solve(*_flywheels()[1])
    check_variant(form, port, jax_solves[form], port_default)
    x = port[3]
    assert oracle_failures(x[: FLYWHEEL_N + 1], x[FLYWHEEL_N + 1:], TOTAL_TIME) == []


def test_a_change_of_variable_builds_a_new_backend(monkeypatch):
    """The selected form is part of the solver cache's key: a re-solve of
    the same problem after the variable changes builds a backend of the
    new form and gives the same solution."""
    for name in VARIABLES.values():
        monkeypatch.delenv(name, raising=False)
    problem, X, U = flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)
    assert problem.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    first = _trajectory(X, U)
    monkeypatch.setenv("SLEIPNIR_TPU_BCR", "1")
    X.set_value(np.zeros(X.shape))
    U.set_value(np.zeros(U.shape))
    assert problem.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    backends = [v[-1] for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    assert [b.use_bcr for b in backends] == [False, True]
    assert np.abs(_trajectory(X, U) - first).max() < 1e-6
    monkeypatch.setenv("SLEIPNIR_TPU_BCR", "0")
    monkeypatch.setenv("SLEIPNIR_TPU_INV", "yes")
    assert problem.solve(device="cpu") == tslp.ExitStatus.SUCCESS
    backends = [v[-1] for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    assert [(b.use_bcr, b.use_inv) for b in backends] == [(False, False), (True, False),
                                                          (False, True)]


@pytest.mark.parametrize("form", ["bcr", "inv"])
def test_lanes_take_the_selected_form(form, monkeypatch):
    """The lane batch factors through the backend's `_chain_factor` and
    `chain_solve`, so it takes the selected form unchanged: three
    flywheel lanes under each variable end as under neither."""
    from sleipnir_tpu_torch import Options
    from sleipnir_tpu_torch.parallel import solve_ipm_batched

    def lanes():
        problem, _X, _U = flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)
        rng = np.random.default_rng(0)
        guesses = [0.01 * k * rng.standard_normal(problem._compile()["n"]) for k in range(3)]
        cuda_banded.reset_counters()
        statuses, _costs, xs, final = solve_ipm_batched(problem, guesses, Options(device="cpu"))
        return statuses.tolist(), final.iterations.tolist(), xs, dict(cuda_banded.PLAIN_BY_SHAPE)

    for name in VARIABLES.values():
        monkeypatch.delenv(name, raising=False)
    default = lanes()
    monkeypatch.setenv(VARIABLES[form], "1")
    statuses, iterations, xs, calls = lanes()
    assert statuses == default[0] == [0, 0, 0]
    assert iterations == default[1]
    assert np.abs(xs - default[2]).max() < 1e-6
    assert {K for _kind, _B, K, _w in calls} == ({2} if form == "bcr" else set())
