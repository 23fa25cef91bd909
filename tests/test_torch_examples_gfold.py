"""The port's G-FOLD example against the JAX package's, on the CPU.

G-FOLD at its published N=25 is infeasible (a descent from 2,400 m in
12.5 s against a 90 m/s speed limit), and both packages end without
SUCCESS: the JAX package LOCALLY_INFEASIBLE, the port LOCALLY_INFEASIBLE
or FEASIBILITY_RESTORATION_FAILED depending on the order of its floating
point sums (torch's thread count decides it on a CPU). From the same
iterate the two packages take the same step: the same regularization rung,
γ and status at every one of the first fifty, the iterates agreeing to
rounding amplified by the KKT system's conditioning (δ near 1e-11). Where
the ladder jumps by ten decades (iteration 44), one LDLᵀ pivot of every
regularized rung lies at 0.68 of the inertia threshold eps^0.75, and the
two packages' pivots of the same matrix differ by up to 12% there: a
trajectory that drifts by rounding lands that pivot on either side of the
threshold, which sends the solves apart. Restoration from the same entry
state gives the same verdict in both packages.

So this file holds, at the published N=25, the port's steps from the JAX
package's iterates around the split; and at N=10, the smallest horizon
at which restoration ends LOCALLY_INFEASIBLE, the port's restoration
verdict from each of the JAX package's entry states and the class of the
whole solve's status."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import sleipnir_tpu as jslp
import sleipnir_tpu.optimization.problem as jax_problem_module
import sleipnir_tpu_torch as tslp
import sleipnir_tpu_torch.optimization.problem as torch_problem_module
from sleipnir_tpu_torch.examples import g_fold
from sleipnir_tpu_torch.interop import ipm_state_from_numpy
from sleipnir_tpu_torch.optimization.solver.kkt_backend import eps_inertia
from sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration import restore

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
#: The published horizon, and the JAX package's iterations around the
#: split: its ladder jumps from δ ≈ 1e-10 to 0.57 at step 44.
SPLIT_N, SPLIT_STEPS = 25, range(40, 46)
#: The smallest horizon whose restoration ends LOCALLY_INFEASIBLE in the
#: JAX package (at N = 4 and 6 it fails).
VERDICT_N = 10
#: Relative difference of the port's iterate from the JAX package's after
#: one step from the same state: rounding of a KKT system regularized by
#: δ ≈ 1e-11 (measured up to 1.3e-6 over the first fifty steps).
STEP_RTOL = 1e-4
INFEASIBLE = {int(tslp.ExitStatus.LOCALLY_INFEASIBLE),
              int(tslp.ExitStatus.FEASIBILITY_RESTORATION_FAILED)}


def jax_g_fold():
    spec = importlib.util.spec_from_file_location("jax_example_g_fold", EXAMPLES / "g_fold.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _to_numpy(value):
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.array(value)


def _built(main, problem_cls, N, **kwargs):
    """The Problem that `main` builds at horizon N, with its initial state
    (its solve capped at zero iterations)."""
    seen = {}
    solve = problem_cls.solve

    def capture(self, *args, **options):
        seen["problem"] = self
        return solve(self, *args, **{**options, "max_iterations": 0})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(problem_cls, "solve", capture)
        main(N=N, verbose=False, **kwargs)
    return seen["problem"]


def test_steps_from_jax_iterates_take_the_jax_rungs():
    jp = _built(jax_g_fold().main, jax_problem_module.Problem, SPLIT_N)
    tp = _built(g_fold.main, torch_problem_module.Problem, SPLIT_N, device="cpu")
    jstep = jax.jit(jp.prepare_ipm(jslp.Options())[1][1])
    tstep = tp.prepare_ipm(tslp.Options(device="cpu"))[1][1]
    np.testing.assert_array_equal(_to_numpy(tp._last_state)["x"], _to_numpy(jp._last_state)["x"])

    jstate = jp._last_state
    for _ in range(SPLIT_STEPS.start):
        jstate = jstep(jstate)
    for k in SPLIT_STEPS:
        start = _to_numpy(jstate)
        jstate = jstep(jstate)
        port = tstep(ipm_state_from_numpy(start, "cpu"))
        assert port.iterations == int(jstate.iterations) == k + 1
        assert port.status == int(jstate.status), k
        assert float(port.delta) == pytest.approx(float(jstate.delta), rel=1e-12), k
        assert float(port.gamma) == float(jstate.gamma), k
        ref = np.asarray(jstate.x)
        err = np.abs(port.x.numpy() - ref).max() / np.abs(ref).max()
        assert err <= STEP_RTOL, (k, err)
    # The ten-decade jump: step 44 escalates past every rung of the ladder.
    assert float(jstate.delta) > 0.1
    assert eps_inertia(torch.float64) == pytest.approx(1.819e-12, rel=1e-3)


@pytest.fixture(scope="module")
def jax_verdicts():
    """The JAX example at N=10: its status, and each restoration entry's
    state (numpy) with the outcome the JAX package's `restore` gave."""
    entries = []
    inner = jax_problem_module.restore

    def recording(funcs, state, options, **kwargs):
        out = inner(funcs, state, options, **kwargs)
        outcome = out[0] if isinstance(out[0], str) else int(out[0])
        entries.append((_to_numpy(state), outcome, int(out[-1])))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_problem_module, "restore", recording)
        status, _cost = jax_g_fold().main(N=VERDICT_N, verbose=False)
    return int(status), entries


def test_restoration_verdict_from_the_same_entry_matches_jax(jax_verdicts):
    _status, entries = jax_verdicts
    assert entries and entries[-1][1] == int(tslp.ExitStatus.LOCALLY_INFEASIBLE)
    tp = _built(g_fold.main, torch_problem_module.Problem, VERDICT_N, device="cpu")
    funcs = tp.prepare_ipm(tslp.Options(device="cpu"))[1][3]
    for state, outcome, iterations in entries:
        port = restore(funcs, ipm_state_from_numpy(state, "cpu"), tslp.Options(device="cpu"))
        got = port[0] if isinstance(port[0], str) else int(port[0])
        print(f"entry at {int(state['iterations'])}: JAX {outcome} at {iterations}, "
              f"port {got} at {port[-1]}")
        assert got == outcome, (int(state["iterations"]), got, outcome)


def test_whole_solve_ends_in_the_jax_status_class(jax_verdicts):
    jstatus, _entries = jax_verdicts
    tstatus, tcost = g_fold.main(N=VERDICT_N, verbose=False, device="cpu")
    assert jstatus in INFEASIBLE and int(tstatus) in INFEASIBLE
    assert tcost == float("inf")
