"""The port's named ranges (`sleipnir_tpu_torch/util/profiler.py` `span`)
and the counters of `SolveStats`: a solve records one `slp.solve`, one
`slp.iteration` per iteration and one `slp.host_read` per host read; the
KKT backend's ranges sit inside the benchmark's `pb.*` wrappers one for
one; a batched solve records its lanes' scaling and sets the stats the
benchmark counts; and with no profiler a span is one shared null context.
Flywheel N=10 on the banded backend. The `cuda` cases need the card.

    python -m pytest tests/test_torch_spans.py -q
"""

import collections

import numpy as np
import pytest
import torch

from perfbench import trace
from sleipnir_tpu_torch import Options
from sleipnir_tpu_torch.models.flywheel import flywheel_problem
from sleipnir_tpu_torch.optimization.problem import SolveStats
from sleipnir_tpu_torch.optimization.solver.util import cuda_graph
from sleipnir_tpu_torch.parallel import solve_ipm_batched
from sleipnir_tpu_torch.util import profiler

torch.set_num_threads(1)

N = 10
KKT_SPANS = ("factor", "solve_refined", "kkt_factor", "kkt_solve")


def _profiled(fn, device="cpu"):
    """fn()'s result and the ranges it recorded, (start, end, name), by start."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    return out, events, sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                               if e.name().startswith(("slp.", "pb.")))


def _count(ranges, prefix):
    return collections.Counter(n.split("|")[0] for _s, _e, n in ranges if n.startswith(prefix))


@pytest.fixture(scope="module")
def flywheel():
    problem, X, U = flywheel_problem(N=N)
    assert problem.solve(device="cpu").name == "SUCCESS"  # builds and warms the solver
    return problem, X, U


def _cold_start(X, U):
    X.set_value(np.zeros(X.value().shape))
    U.set_value(np.zeros(U.value().shape))


def test_a_solve_records_one_solve_and_a_range_per_iteration_and_host_read(flywheel):
    problem, X, U = flywheel
    _cold_start(X, U)
    status, _events, ranges = _profiled(lambda: problem.solve(device="cpu"))
    stats = problem.last_solve_stats
    assert status.name == "SUCCESS" and stats.iterations > 1
    counts = _count(ranges, "slp.")
    assert counts["slp.solve"] == 1
    assert counts["slp.iteration"] == stats.iterations
    assert counts["slp.host_read"] == stats.host_syncs
    # Every range of the request nests under its slp.solve.
    (s0, e0, _), = [r for r in ranges if r[2] == "slp.solve"]
    assert all(s0 <= s and e <= e0 for s, e, n in ranges if n.startswith("slp."))
    # On the CPU the graphed functions run eagerly: nothing captured.
    assert (stats.graph_captures, stats.capture_s) == (0, 0.0)


def test_every_kkt_range_sits_in_its_benchmark_twin(flywheel):
    problem, X, U = flywheel
    _cold_start(X, U)
    with trace.Spans():
        _status, _events, ranges = _profiled(lambda: problem.solve(device="cpu"))
    ours, theirs = _count(ranges, "slp."), _count(ranges, "pb.")
    for name in KKT_SPANS:
        assert ours["slp." + name] == theirs["pb." + name] > 0, name
    twins = {n: [r for r in ranges if r[2] == n] for n in {r[2] for r in ranges}}
    for s, e, name in ranges:
        kind = name.split("|")[0].removeprefix("slp.")
        if kind not in KKT_SPANS:
            continue
        # The same name, shapes included, one level out: pb.* wraps the
        # method from outside, slp.* opens first thing inside it.
        outer = [r for r in twins["pb." + name.removeprefix("slp.")] if r[0] <= s and e <= r[1]]
        assert len(outer) == 1, name


def test_a_batched_solve_records_its_lane_scaling_and_sets_its_stats(flywheel):
    problem, _X, _U = flywheel
    options = Options(device="cpu")
    rng = np.random.default_rng(3)
    n = problem._compile()["n"]
    guesses = [0.01 * k * rng.standard_normal(n) for k in range(3)]
    # What the benchmark's harness counts for a multistart call.
    syncs = problem.prepare_ipm(options)[1][-1].syncs
    before = syncs.count
    (statuses, _costs, _xs, final), _events, ranges = _profiled(
        lambda: solve_ipm_batched(problem, guesses, options))
    assert statuses.tolist() == [0, 0, 0]
    stats = problem.last_solve_stats
    assert stats.iterations == int(final.iterations.max())
    assert stats.host_syncs == syncs.count - before
    counts = _count(ranges, "slp.")
    assert counts["slp.solve"] == 1 and counts["slp.lane_scaling"] == 1
    assert counts["slp.iteration"] == stats.iterations
    assert counts["slp.host_read"] == stats.host_syncs


def test_without_a_profiler_a_span_is_the_shared_null_context():
    assert profiler.span("slp.x") is profiler._NULL
    assert profiler.span("slp.kkt_factor", 4, 101, 13, torch.float64) is profiler._NULL
    _out, _events, ranges = _profiled(lambda: profiler.span("slp.kkt_factor", 4, 101, 13,
                                                            torch.float64).__enter__())
    assert [n for _s, _e, n in ranges] == ["slp.kkt_factor|4|101|13|float64"]


def test_the_ranges_are_not_user_annotations():
    """A user annotation (`record_function`) that launches device work is
    mirrored onto the card's timeline, where a reader of the trace would
    take it for an operation; the program's ranges are function-scope
    records, which stay on the host's."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("slp.solve"), torch.profiler.record_function("pb.user"):
            torch.ones(3).sum()
    kinds = {e.name: e.is_user_annotation for e in prof.events() if "." in e.name}
    assert kinds == {"slp.solve": False, "pb.user": True}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the card's trace have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_first_graphed_call_captures_and_a_second_replays(cuda_device):
    g = cuda_graph.Graphs().wrap(lambda x: (x * x).cumsum(0), "square")
    x = torch.linspace(0.0, 1.0, 64, device=cuda_device, dtype=torch.float64)
    for call, (kind, captures) in enumerate((("capture", 1), ("replay", 0))):
        before = SolveStats.counters()
        _out, _events, ranges = _profiled(lambda: g(x + call), "cuda")
        stats = SolveStats.since(0, before)
        assert [n for _s, _e, n in ranges] == [f"slp.graph_{kind}|square"]
        assert stats.graph_captures == captures and (stats.capture_s > 0) == bool(captures)


@pytest.mark.cuda
def test_a_solve_on_the_card_counts_its_captures_and_mirrors_no_range(cuda_device):
    problem, X, U = flywheel_problem(N=N)
    for first in (True, False):
        _cold_start(X, U)
        status, events, ranges = _profiled(lambda: problem.solve(device="cuda"), "cuda")
        stats = problem.last_solve_stats
        assert status.name == "SUCCESS"
        counts = _count(ranges, "slp.")
        assert counts["slp.graph_capture"] == stats.graph_captures
        assert (stats.graph_captures > 0) == first and counts["slp.graph_replay"] > 0
        assert counts["slp.iteration"] == stats.iterations
        from torch.autograd import DeviceType

        on_card = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
        assert on_card and not [n for n in on_card if n.startswith("slp.")]


@pytest.mark.cuda
def test_a_second_lane_solve_on_the_card_replays_every_graph(cuda_device):
    """The lane solve of a multistart, twice on one problem from the same
    guesses: the second call builds no lane step and captures nothing,
    replays the first call's graphs, and answers as it did, bit for bit."""
    problem, _X, _U = flywheel_problem(N=N)
    rng = np.random.default_rng(3)
    guesses = [0.01 * k * rng.standard_normal(problem._compile()["n"]) for k in range(3)]
    answers = []
    for first in (True, False):
        out, _events, ranges = _profiled(
            lambda: solve_ipm_batched(problem, guesses, Options(device="cuda")), "cuda")
        stats = problem.last_solve_stats
        counts = _count(ranges, "slp.")
        assert out[0].tolist() == [0, 0, 0]
        assert stats.lane_steps_built == int(first)
        assert counts["slp.graph_capture"] == stats.graph_captures
        assert (stats.graph_captures > 0) == first and counts["slp.graph_replay"] > 0
        statuses, costs, xs, final = out
        answers.append((statuses, final.iterations.cpu().numpy(), costs, xs))
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)
