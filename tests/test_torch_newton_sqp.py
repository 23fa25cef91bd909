"""Newton's method, SQP and the dense interior-point path of the port
against the JAX package: whole solves of the problems of the JAX
package's tests/optimization/test_{linear,quadratic,nonlinear,trivial}_problem.py
through both packages (exit status equal, x to 1e-8, iterations equal),
and one Newton step and one dense SQP step from the same state, field by
field to 1e-12."""

import numpy as np
import pytest
import torch

import jax

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.interop import state_from_numpy
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.newton import NewtonState
from sleipnir_tpu_torch.optimization.solver.sqp import SQPState

torch.set_num_threads(1)


def _build(slp, case):
    """One problem of the JAX package's tests, built through `slp`;
    returns (problem, variables whose values are compared)."""
    kind, start = case
    p = slp.Problem()
    if kind == "unconstrained_1d":  # test_quadratic_problem.py:9
        x = p.decision_variable()
        x.set_value(2.0)
        p.minimize(x * x - 6.0 * x)
        return p, [x]
    if kind == "unconstrained_2d":  # test_quadratic_problem.py:21
        x, y = p.decision_variable(2)
        x.set_value(1.0)
        y.set_value(2.0)
        p.minimize(x * x + y * y)
        return p, [x, y]
    if kind == "unconstrained_2d_matrix":  # test_quadratic_problem.py:34
        x = p.decision_variable(2)
        x[0].set_value(1.0)
        x[1].set_value(2.0)
        p.minimize(x.T @ x)
        return p, [x]
    if kind == "readme":  # test_quadratic_problem.py:48, README.md:13-26
        x, y = p.decision_variable(), p.decision_variable()
        x.set_value(1.0)
        y.set_value(2.0)
        p.maximize(x * y)
        p.subject_to(x + 3 * y == 36)
        return p, [x, y]
    if kind == "equality_matrix":  # test_quadratic_problem.py:67
        x = p.decision_variable(2)
        x[0].set_value(1.0)
        x[1].set_value(2.0)
        p.minimize(x.T @ x)
        p.subject_to(x == [[3.0], [3.0]])
        return p, [x]
    if kind == "distance_with_line":  # test_nonlinear_problem.py:77
        x, y = p.decision_variable(2)
        x.set_value(20.0)
        y.set_value(50.0)
        p.minimize(slp.sqrt(x * x + y * y))
        p.subject_to(y == -x + 5.0)
        return p, [x, y]
    if kind == "quartic":  # test_nonlinear_problem.py:13
        x = p.decision_variable()
        x.set_value(20.0)
        p.minimize(slp.pow(x, 4))
        p.subject_to(x >= 1)
        return p, [x]
    if kind in ("rosenbrock_disk", "rosenbrock_cubic_line"):  # :28, :52
        x, y = p.decision_variable(2)
        x.set_value(start[0])
        y.set_value(start[1])
        p.minimize(100 * slp.pow(y - slp.pow(x, 2), 2) + slp.pow(1 - x, 2))
        if kind == "rosenbrock_disk":
            p.subject_to(slp.pow(x, 2) + slp.pow(y, 2) <= 2)
        else:
            p.subject_to(y >= slp.pow(x - 1, 3) + 1)
            p.subject_to(y <= -x + 2)
        return p, [x, y]
    if kind == "line_search_failure":  # test_nonlinear_problem.py:125, restores
        x, s1, s2 = p.decision_variable(3)
        x.set_value(-2)
        s1.set_value(3)
        s2.set_value(1)
        p.minimize(x)
        p.subject_to(x**2 - s1 - 1 == 0)
        p.subject_to(x - s2 - 0.5 == 0)
        p.subject_to(s1 >= 0)
        p.subject_to(s2 >= 0)
        return p, [x, s1, s2]
    if kind == "linear_maximize":  # test_linear_problem.py:9
        x, y = p.decision_variable(2)
        x.set_value(1.0)
        y.set_value(1.0)
        p.maximize(50 * x + 40 * y)
        p.subject_to(x + 1.5 * y <= 750)
        p.subject_to(2 * x + 3 * y <= 1500)
        p.subject_to(2 * x + y <= 1000)
        p.subject_to(x >= 0)
        p.subject_to(y >= 0)
        return p, [x, y]
    if kind == "free_variable":  # test_linear_problem.py:35
        x = p.decision_variable(2)
        x[0].set_value(1.0)
        x[1].set_value(2.0)
        p.subject_to(x[0] == 0)
        return p, [x]
    if kind == "no_cost":  # test_trivial_problem.py
        X = p.decision_variable(2, 3)
        if start:
            X.set_value(np.ones((2, 3)))
        return p, [X]
    raise ValueError(kind)


def _values(variables) -> np.ndarray:
    return np.concatenate([np.ravel(v.value()) for v in variables])


CASES = [
    ("unconstrained_1d", None), ("unconstrained_2d", None), ("unconstrained_2d_matrix", None),
    ("readme", None), ("equality_matrix", None), ("distance_with_line", None),
    ("quartic", None),
    ("rosenbrock_disk", (-1.5, -1.5)), ("rosenbrock_disk", (-1.0, 0.5)),
    ("rosenbrock_disk", (1.0, -1.0)),
    ("rosenbrock_cubic_line", (-1.5, -0.5)), ("rosenbrock_cubic_line", (-1.0, 1.5)),
    ("rosenbrock_cubic_line", (1.0, 2.0)),
    ("line_search_failure", None),
    ("linear_maximize", None), ("free_variable", None),
    ("no_cost", False), ("no_cost", True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_solve_matches_jax(case):
    """Whole solves through both packages: the same dispatch (Newton, SQP
    or the dense interior-point method), exit status equal, the solution
    to 1e-8 and the iteration count equal."""
    jp, jv = _build(jslp, case)
    tp, tv = _build(tslp, case)
    assert tp.cost_function_type() == jp.cost_function_type()
    assert tp.equality_constraint_type() == jp.equality_constraint_type()
    assert tp.inequality_constraint_type() == jp.inequality_constraint_type()
    jstatus = jp.solve()
    tstatus = tp.solve(device="cpu")
    assert int(tstatus) == int(jstatus)
    assert tstatus == tslp.ExitStatus.SUCCESS
    np.testing.assert_allclose(_values(tv), _values(jv), rtol=0, atol=1e-8)
    if jp._last_state is not None:
        assert tp.last_solve_stats.iterations == int(jp._last_state.iterations)
    if case[0] == "readme":
        np.testing.assert_allclose(_values(tv), [18.0, 6.0], atol=1e-8)


def test_dense_paths_take_the_dense_backend():
    """Without OCP structure every solver runs on the dense backend."""
    for kind, solver in (("unconstrained_2d", "newton"), ("readme", "sqp"), ("quartic", "ipm")):
        p, _ = _build(tslp, (kind, None))
        assert p.solve(device="cpu") == tslp.ExitStatus.SUCCESS
        [cached] = [v for k, v in p._solver_cache.items() if k[0] == solver]
        assert isinstance(cached[-1], DenseBackend)


def _to_numpy(value):
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _assert_states_close(port, ref, rtol, path="state"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k, v in ref.items():
            _assert_states_close(port[k], v, rtol, f"{path}.{k}")
        return
    a, b = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.size:
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= rtol, (path, err)


def _steps_match(jp, tp, kind, state_cls, steps):
    """Start both packages from the JAX package's initial state and take
    `steps` steps, comparing every field after each."""
    jp.solve(max_iterations=0)
    tp.solve(max_iterations=0, device="cpu")
    _assert_states_close(_to_numpy(tp._last_state), _to_numpy(jp._last_state), 1e-12)
    [jcached] = [v for k, v in jp._solver_cache.items() if k[0] == kind]
    [tcached] = [v for k, v in tp._solver_cache.items() if k[0] == kind]
    jstep, tstep = jax.jit(jcached[1]), tcached[1]
    jstate = jp._last_state
    for _ in range(steps):
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(state_from_numpy(state_cls, start, "cpu"))
        assert port.status == int(jstate.status)
        _assert_states_close(_to_numpy(port), _to_numpy(jstate), 1e-12)


def test_newton_step_matches_jax():
    """Rosenbrock from (−1.2, 1): the Hessian is indefinite on the way, so
    the steps exercise the δ ladder."""

    def build(slp):
        p = slp.Problem()
        x, y = p.decision_variable(2)
        x.set_value(-1.2)
        y.set_value(1.0)
        p.minimize(100 * slp.pow(y - slp.pow(x, 2), 2) + slp.pow(1 - x, 2))
        return p

    _steps_match(build(jslp), build(tslp), "newton", NewtonState, 4)


def test_dense_sqp_step_matches_jax():
    """A nonlinear equality: minimize ‖v‖² subject to xyz = 1 from
    (2, 0.3, 1.5)."""

    def build(slp):
        p = slp.Problem()
        x, y, z = p.decision_variable(3)
        x.set_value(2.0)
        y.set_value(0.3)
        z.set_value(1.5)
        p.minimize(x * x + y * y + z * z)
        p.subject_to(x * y * z == 1.0)
        return p

    _steps_match(build(jslp), build(tslp), "sqp", SQPState, 4)
