"""CUDA graphs of the solvers' problem evaluations
(`sleipnir_tpu_torch/optimization/solver/util/cuda_graph.py`).

On this CPU every graphed function runs eagerly, so the CPU cases run
each one under a sync trap: a dispatch mode that raises on the operations
a CUDA graph cannot capture (a device-to-host read, a data-dependent
shape, a host-to-device copy of host data). Each case solves a small
problem of one path and names the graphed functions it must reach. The
`cuda` cases need the card and skip here: graphed outputs against eager
ones bit for bit, a cached solver re-solved with changed parameters
against a fresh problem, replays whose earlier outputs stay intact, and a
capture that fails loudly.

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import sleipnir_tpu_torch as tslp
from sleipnir_tpu_torch.examples import constrained_multitag
from sleipnir_tpu_torch.models import cart_pole, differential_drive, double_integrator, flywheel
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
from sleipnir_tpu_torch.optimization.solver.util import cuda_graph
from sleipnir_tpu_torch.optimization.solver.util import feasibility_restoration as tfr
from sleipnir_tpu_torch.parallel import solve_ipm_batched

torch.set_num_threads(1)

#: What a CUDA graph cannot hold: `.item()` and `bool(tensor)` (a host
#: read), `nonzero` and boolean-mask selection (a data-dependent shape),
#: `torch.tensor`/`torch.as_tensor` of host data (a host-to-device copy
#: whose value the replay would keep), and the error check of a linalg
#: library call (`torch.linalg.solve`), which reads its info on the card.
TRAPPED = {
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::is_nonzero", "aten::lift_fresh", "aten::lift_fresh_copy",
    "aten::_linalg_check_errors",
}


class SyncTrap(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in TRAPPED:
            raise AssertionError(f"{func._schema.name} inside a graphed function")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def trapped(monkeypatch):
    """Run every graphed function under the trap; count the calls by
    function name."""
    ran = collections.Counter()

    def call(self, *args):
        ran[self.name] += 1
        with SyncTrap():
            return self.eager(*args)

    monkeypatch.setattr(cuda_graph.Graphed, "__call__", call)
    return ran


def _small(build, x0):
    p = tslp.Problem()
    v = [p.decision_variable() for _ in x0]
    for vi, xi in zip(v, x0):
        vi.set_value(xi)
    build(p, *v)
    return p


def _abs_cost(p, x):
    # A kink at the optimum: second-order corrections, the α ladder and
    # the KKT-error fallback within 16 iterations.
    p.minimize(tslp.abs(x - 1.0))
    p.subject_to(x >= 0.0)


def _restoring_ipm(p, x):
    # Infeasible: restoration entries that resume the parent.
    p.minimize(x)
    p.subject_to(x * x >= 1.0)
    p.subject_to(x <= 0.5)
    p.subject_to(x >= -0.5)


def _restoring_sqp(p, x, y):
    p.minimize(x + y)
    p.subject_to(x * x + y * y == 1.0)
    p.subject_to(x * y == 0.4)


def _newton_kink(p, x):
    p.minimize(tslp.abs(x))


def _readme(p, x, y):
    p.maximize(x * y)
    p.subject_to(x + 3 * y == 36)


def _shooting():
    ocp = tslp.OCP(1, 1, 0.1, 5, lambda x, u: -x + u, tslp.DynamicsType.EXPLICIT_ODE,
                   tslp.TimestepMethod.FIXED, tslp.TranscriptionMethod.SINGLE_SHOOTING)
    ocp.set_lower_input_bound(-12)
    ocp.set_upper_input_bound(12)
    ocp.minimize(((10.0 - ocp.X()) ** 2).sum())
    return ocp


def _solve(problem, **kwargs):
    return problem.solve(device="cpu", **kwargs)


def _cart_pole_restoration():
    problem, _, _ = cart_pole.cart_pole_problem(N=12, total_time=1.0)
    options = tslp.Options(device="cpu")
    comp = problem._compile()
    init, _step, _resume, funcs, g_fn, backend = problem._prepare_ipm(
        comp, options, torch.device("cpu")
    )
    params = comp["compiled"].gather_params()
    x0 = 0.5 * np.random.default_rng(7).standard_normal(comp["n"])
    scaling, _, _ = problem._ipm_scaling(g_fn, backend, x0, params)
    state = init(x0, np.ones(comp["mi"]), np.zeros(comp["me"]), np.ones(comp["mi"]),
                 0.1 * scaling.f, 0, params,
                 ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=scaling.c_i))
    outcome = tfr.restore(funcs, state, options, parent_backend=backend)[0]
    assert outcome == "resume"


def _lanes(problem, guesses, iterations):
    solve_ipm_batched(problem, guesses, tslp.Options(device="cpu"), max_iterations=iterations)


def _cart_pole_lanes():
    problem = cart_pole.cart_pole_problem(N=12)[0]
    rng = np.random.default_rng(0)
    n = problem._compile()["n"]
    _lanes(problem, [0.01 * k * rng.standard_normal(n) for k in range(3)], 3)


CASES = {
    # The paths the chip runs, at a small size.
    "cart-pole N=12 (IPM)": (
        lambda: _solve(cart_pole.cart_pole_problem(N=12)[0], max_iterations=3),
        {"evaluate", "trip", "refresh"},
    ),
    "flywheel N=20 (IPM)": (
        lambda: _solve(flywheel.flywheel_problem(N=20)[0]), {"evaluate", "trip", "refresh"},
    ),
    "flywheel N=20 without input bounds (banded SQP)": (
        lambda: _solve(flywheel.flywheel_unbounded_problem(N=20)[0]),
        {"evaluate", "trial_at", "refresh"},
    ),
    "minimum-time flywheel N=20 (border)": (
        lambda: _solve(flywheel.flywheel_min_time_problem(N=20)[0]),
        {"evaluate", "trip", "refresh"},
    ),
    "cart-pole restoration N=12": (
        _cart_pole_restoration, {"evaluate", "trip", "refresh", "stop_check"},
    ),
    "lanes L=3 at cart-pole N=12": (_cart_pole_lanes, {"lane_init", "trip", "refresh"}),
    "differential drive N=10": (
        lambda: _solve(differential_drive.differential_drive_problem(N=10, total_time=1.0)[0],
                       max_iterations=3),
        {"evaluate", "trip", "refresh"},
    ),
    "double integrator N=10": (
        lambda: _solve(double_integrator.double_integrator_problem(N=10, total_time=0.5)[0],
                       max_iterations=3),
        {"evaluate", "trip", "refresh"},
    ),
    "single shooting N=5 (dense)": (
        lambda: _solve(_shooting(), max_iterations=3), {"evaluate", "trip", "refresh"},
    ),
    "README example (dense SQP)": (
        lambda: _solve(_small(_readme, [1.0, 2.0])), {"evaluate", "trial_at", "refresh"},
    ),
    "multi-tag pose example (Newton through the DSL's solve)": (
        lambda: constrained_multitag.main(verbose=False, device="cpu"), {"evaluate", "cost_at"},
    ),
    # The rarer branches, on small dense problems that reach them.
    "IPM second-order corrections, α ladder, KKT fallback": (
        lambda: _solve(_small(_abs_cost, [3.0]), max_iterations=16),
        {"soc_trial", "jump", "kkt_fallback"},
    ),
    "IPM restoration and resume": (
        lambda: _solve(_small(_restoring_ipm, [0.0]), max_iterations=40),
        {"stop_check", "values"},
    ),
    "SQP restoration and resume": (
        lambda: _solve(_small(_restoring_sqp, [0.0, 0.0])),
        {"jump", "stop_check", "values"},
    ),
    "Newton line search and fallback": (
        lambda: _solve(_small(_newton_kink, [1.0])), {"evaluate", "cost_at", "values"},
    ),
    "lanes: second-order corrections, α ladder, KKT fallback": (
        lambda: _lanes(_small(_abs_cost, [3.0]),
                       [np.array([3.0]), np.array([2.0]), np.array([-1.0])], 16),
        {"soc_trial", "jump", "kkt_fallback"},
    ),
    # The float32 solve (`Options.dtype`): its own evaluations, in float32.
    "flywheel N=20 in float32 (banded IPM)": (
        lambda: _solve(flywheel.flywheel_problem(N=20)[0], dtype="float32", tolerance=1e-2,
                       max_iterations=20),
        {"evaluate", "trip", "refresh"},
    ),
    "README example in float32 (dense SQP)": (
        lambda: _solve(_small(_readme, [1.0, 2.0]), dtype="float32", tolerance=1e-4),
        {"evaluate", "trial_at", "refresh"},
    ),
    "lanes L=3 at cart-pole N=12 in float32": (
        lambda: solve_ipm_batched(
            cart_pole.cart_pole_problem(N=12)[0],
            [0.01 * k * np.ones(5 * 13) for k in range(3)],
            tslp.Options(device="cpu", dtype="float32", tolerance=1e-2), max_iterations=3,
        ),
        {"lane_init", "trip", "refresh"},
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_functions_hold_no_host_sync(case, trapped):
    run, expected = CASES[case]
    run()
    assert expected <= set(trapped), f"not reached: {expected - set(trapped)}"


def test_cpu_calls_run_eagerly_and_capture_nothing():
    seen = []

    def double(x, pair, flag: bool):
        seen.append(flag)
        return 2 * x, (pair[0] + 1, pair[1])

    g = cuda_graph.Graphs().wrap(double)
    cuda_graph.reset_counters()
    out = g(torch.ones(3), (torch.zeros(2), torch.arange(2)), True)
    assert g.eager is double and g.name == "double"
    torch.testing.assert_close(out[0], torch.full((3,), 2.0))
    assert seen == [True] and not g._entries
    assert (cuda_graph.CAPTURES, cuda_graph.REPLAYS) == (0, 0)
    assert cuda_graph.at(torch.arange(5.0), torch.tensor(3)).item() == 3.0


def test_cached_solver_takes_new_parameters_on_the_cpu():
    """The parameters reach the cached solver's evaluations as inputs (on
    the card, as the graphs' copied inputs): a re-solve with new values
    gives what a fresh problem gives, bit for bit."""
    problem, X, U, x0, r = flywheel.flywheel_mpc_problem(N=30)
    assert _solve(problem) == tslp.ExitStatus.SUCCESS
    # From the fresh problem's starting point, not the last solution.
    X.set_value(np.zeros((1, 31)))
    U.set_value(np.zeros((1, 31)))
    x0.set_value(3.0)
    r.set_value(5.0)
    assert _solve(problem) == tslp.ExitStatus.SUCCESS and len(problem._solver_cache) == 1
    fresh, X2, _U2, x02, r2 = flywheel.flywheel_mpc_problem(N=30)
    x02.set_value(3.0)
    r2.set_value(5.0)
    assert _solve(fresh) == tslp.ExitStatus.SUCCESS
    np.testing.assert_array_equal(X.value(), X2.value())
    assert abs(X.value()[0, 0] - 3.0) < 1e-9 and abs(X.value()[0, -1] - 5.0) < 1e-6


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _bitwise_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif x.shape != y.shape or x.dtype != y.dtype:
            return False
        else:
            eq = x == y
            if x.is_floating_point():
                eq = eq | (torch.isnan(x) & torch.isnan(y))
            if not bool(eq.all()):
                return False
    return True


@pytest.mark.cuda
def test_graphed_outputs_equal_eager_ones_bit_for_bit(cuda_device, monkeypatch):
    """Every replay of a solve's graphed functions against the eager
    function on the same inputs; a capture against its own replay."""
    call = cuda_graph.Graphed.__call__
    held = collections.Counter()
    differ = []

    def checked(self, *args):
        before = len(self._entries)
        out = call(self, *args)
        eager = call(self, *args) if len(self._entries) > before else self.eager(*args)
        held[self.name] += 1
        if not _bitwise_equal(out, eager):
            differ.append(self.name)
        return out

    monkeypatch.setattr(cuda_graph.Graphed, "__call__", checked)
    problem, _, _ = cart_pole.cart_pole_problem(N=30)
    problem.solve(device="cuda", max_iterations=30)
    fly, _, _ = flywheel.flywheel_problem(N=200)
    assert fly.solve(device="cuda") == tslp.ExitStatus.SUCCESS
    assert {"evaluate", "trip", "refresh"} <= set(held)
    assert not differ, differ


@pytest.mark.cuda
def test_cached_solver_resolves_changed_parameters(cuda_device):
    """A model-predictive re-solve: new parameter values reach the
    captured graphs, which give what a fresh problem gives."""
    problem, X, U, x0, r = flywheel.flywheel_mpc_problem(N=200)
    assert problem.solve(device="cuda") == tslp.ExitStatus.SUCCESS
    cuda_graph.reset_counters()
    X.set_value(np.zeros((1, 201)))
    U.set_value(np.zeros((1, 201)))
    x0.set_value(3.0)
    r.set_value(5.0)
    assert problem.solve(device="cuda") == tslp.ExitStatus.SUCCESS
    assert len(problem._solver_cache) == 1 and cuda_graph.CAPTURES == 0
    assert cuda_graph.REPLAYS > 0
    fresh, X2, _U2, x02, r2 = flywheel.flywheel_mpc_problem(N=200)
    x02.set_value(3.0)
    r2.set_value(5.0)
    assert fresh.solve(device="cuda") == tslp.ExitStatus.SUCCESS
    np.testing.assert_array_equal(X.value(), X2.value())
    assert abs(X.value()[0, 0] - 3.0) < 1e-9 and abs(X.value()[0, -1] - 5.0) < 1e-6


@pytest.mark.cuda
def test_earlier_outputs_survive_later_replays(cuda_device):
    graphs = cuda_graph.Graphs()
    g = graphs.wrap(lambda x, p: (torch.sin(x * p).cumsum(0), x.sum() * p), "f")
    x = torch.linspace(0.0, 1.0, 1000, device=cuda_device, dtype=torch.float64)
    p = torch.tensor(2.0, device=cuda_device, dtype=torch.float64)
    g(x, p)  # captures
    first = g(x + 1.0, p)
    second = g(x - 1.0, 3.0 * p)
    assert _bitwise_equal(first, g.eager(x + 1.0, p))
    assert _bitwise_equal(second, g.eager(x - 1.0, 3.0 * p))
    assert first[0].data_ptr() != second[0].data_ptr()


@pytest.mark.cuda
def test_failed_capture_raises_naming_the_function(cuda_device):
    g = cuda_graph.Graphs().wrap(lambda x: x * x.sum().item(), "reads_the_host")
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="reads_the_host"):
        g(x)
