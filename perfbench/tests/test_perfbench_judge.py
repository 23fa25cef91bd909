"""The comparison that decides `correct`, at sizes a CPU holds: the plain
reference accepts the port's float64 solves and rejects its float32 path
(the control), and a run whose timed path is broken underneath comes out
not correct, once for each fault a cell can have.

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from perfbench import control, generator, harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
#: Small sizes of each configuration: cart-pole reaches SUCCESS from its
#: guesses at N=24 (not at N=10, with dt = 0.5 s).
SMALL = {"cartpole-n100": {"N": 24}}


def program_for(config, **kwargs):
    sizes, build_path, reference = harness.config_files(config)
    cfg = {**json.loads(sizes.read_text()), **SMALL[config]}
    return cfg, harness.Program(harness.load_module(build_path), cfg, "solve", "cpu", **kwargs), \
        harness.load_module(reference)


def passes(reference, numbers):
    return all(numbers[name] <= limit for name, limit in reference.LIMITS.items())


@pytest.mark.parametrize("cell, lane", [("cartpole-n100-resolve", 0),
                                        ("cartpole-n100-multistart8", 5)])
def test_the_reference_accepts_float64_and_rejects_the_float32_control(cell, lane):
    """One request of the cell's mix (lane `lane` of it) served alone, by
    the program as the configuration states it, by its float32 path (the
    control) and by a solve stopped at 100 times the stated tolerance."""
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    mix = json.loads(harness.traffic_file(entry["traffic"]).read_text())
    cfg, program, reference = program_for(entry["config"])
    guess = generator.Traffic(mix, program.start, 2**31 + 11).next().guesses[lane]
    req = generator.Request([guess])
    served = program.serve(req)
    assert served.ok == [True]
    assert passes(reference, reference.judge(cfg, program.outputs_of(served.xs[0])))
    cfg, program, reference = program_for(
        entry["config"], dtype="float32", tolerance=control.CONTROL_TOLERANCE,
        max_iterations=control.CONTROL_ITERATIONS)
    served = program.serve(req)
    numbers = reference.judge(cfg, program.outputs_of(served.xs[0]))
    assert not passes(reference, numbers), numbers
    cfg, program, reference = program_for(
        entry["config"], tolerance=control.LOOSE_FACTOR * cfg["tolerance"])
    served = program.serve(req)
    assert served.ok == [True]
    numbers = reference.judge(cfg, program.outputs_of(served.xs[0]))
    assert not passes(reference, numbers), numbers


def run(cell_name, monkeypatch, tmp_path, lanes=None):
    cell = next(c for c in BENCH["workloads"] if c["name"] == cell_name)
    if lanes is not None:
        mix = json.loads(harness.traffic_file(cell["traffic"]).read_text())
        path = tmp_path / f"lanes{lanes}.json"
        path.write_text(json.dumps({**mix, "lanes": lanes, "guess": {**mix["guess"], "levels": lanes}}))
        monkeypatch.setattr(harness, "traffic_file", lambda _mix: path)
    code, result = harness.run_cell(BENCH, cell, 2**32 + 3, 0.1, False, "cpu",
                                    time.perf_counter(), SMALL[cell["config"]])
    assert code == 0
    return result


def unchanged_step(monkeypatch):
    """Every interior-point step returns its state unchanged but counted."""
    from sleipnir_tpu_torch.optimization import problem

    make = problem.make_interior_point

    def broken(*args, **kwargs):
        init, _step, resume = make(*args, **kwargs)
        return init, lambda st: st._replace(iterations=st.iterations + 1), resume

    monkeypatch.setattr(problem, "make_interior_point", broken)


def altered_answer(monkeypatch):
    """One entry of every solution is moved by 1e-4 where it is produced."""
    from sleipnir_tpu_torch.autodiff import expression
    from sleipnir_tpu_torch.optimization.problem import Problem

    solve = Problem.solve

    def broken(self, *args, **kwargs):
        status = solve(self, *args, **kwargs)
        ids = self._all_ids()
        x = expression._registry.get(ids)
        x[len(x) // 2] += 1e-4
        expression._registry.set(ids, x)
        return status

    monkeypatch.setattr(Problem, "solve", broken)


def half_the_lanes(monkeypatch):
    """The lane solve serves the first half of the guesses and returns the
    rest as they came, as solved."""
    import sleipnir_tpu_torch.parallel as parallel

    solve = parallel.solve_ipm_batched

    def broken(problem, guesses, options=None, *args, **kwargs):
        half = len(guesses) // 2
        statuses, costs, xs, final = solve(problem, guesses[:half], options, *args, **kwargs)
        rest = np.stack(guesses[half:])
        return (np.concatenate([statuses, np.zeros(len(rest), dtype=statuses.dtype)]),
                np.concatenate([costs, costs[:1].repeat(len(rest))]),
                np.concatenate([xs, rest]), final)

    monkeypatch.setattr(parallel, "solve_ipm_batched", broken)


def unchanged_lane_step(monkeypatch):
    """Every batched step returns the lanes' states unchanged but counted."""
    from sleipnir_tpu_torch.parallel import batch

    make = batch.make_lane_interior_point

    def broken(*args, **kwargs):
        init, _step = make(*args, **kwargs)
        return init, lambda st, run: st._replace(iterations=st.iterations + run.long())

    monkeypatch.setattr(batch, "make_lane_interior_point", broken)


def altered_lane(monkeypatch):
    """One entry of the last lane's solution is moved by 1e-4 where the
    lane solve returns it."""
    import sleipnir_tpu_torch.parallel as parallel

    solve = parallel.solve_ipm_batched

    def broken(*args, **kwargs):
        statuses, costs, xs, final = solve(*args, **kwargs)
        xs = xs.copy()
        xs[-1, xs.shape[1] // 2] += 1e-4
        return statuses, costs, xs, final

    monkeypatch.setattr(parallel, "solve_ipm_batched", broken)


@pytest.mark.parametrize("cell, fault, lanes", [
    ("cartpole-n100-resolve", None, None),
    ("cartpole-n100-resolve", unchanged_step, None),
    ("cartpole-n100-resolve", altered_answer, None),
    ("cartpole-n100-multistart8", None, 2),
    ("cartpole-n100-multistart8", half_the_lanes, 2),
    ("cartpole-n100-multistart8", unchanged_lane_step, 2),
    ("cartpole-n100-multistart8", altered_lane, 2),
])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, lanes, monkeypatch, tmp_path):
    if fault is not None:
        fault(monkeypatch)
    result = run(cell, monkeypatch, tmp_path, lanes)
    assert result["correct"] is (fault is None), result
    assert list(result)[-1] == "checks"
