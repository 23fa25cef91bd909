"""The batched solve over a mesh (`solve_ipm_batched(..., mesh=)`): the
lanes split into one contiguous group per device, each group a lane solve
of its own in a thread of its own. On a mesh that names the CPU twice,
every lane must end as it does in one batch over all lanes (the
flywheel at N=40 from four guesses, two lanes per group)."""

import numpy as np
import pytest
import torch

from sleipnir_tpu_torch.models.flywheel import flywheel_problem
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.parallel import Mesh, batch, default_mesh, shard_batch, solve_ipm_batched

torch.set_num_threads(1)

N, LANES = 40, 4


def _guesses(n):
    rng = np.random.default_rng(0)
    return [0.01 * k * rng.standard_normal(n) for k in range(LANES)]


def test_two_shard_mesh_matches_one_batch():
    problem, _X, _U = flywheel_problem(N=N)
    guesses = _guesses(problem._compile()["n"])
    options = Options(device="cpu")
    status, cost, xs, final = solve_ipm_batched(problem, guesses, options)
    mesh = Mesh.of(["cpu", "cpu"], "batch")
    m_status, m_cost, m_xs, m_final = solve_ipm_batched(problem, guesses, options, mesh=mesh)
    assert m_status.tolist() == status.tolist() == [0] * LANES
    assert isinstance(m_final, tuple) and len(m_final) == 2
    assert torch.cat([f.iterations for f in m_final]).tolist() == final.iterations.tolist()
    np.testing.assert_allclose(m_xs, xs, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m_cost, cost, rtol=1e-12)
    # Each group had its own solver, though both groups share the CPU (the
    # first group's is the one-batch solve's, built for the same device).
    backends = [v[-1] for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    assert len({id(b) for b in backends}) == 2

    best = batch.multistart_batched(problem, guesses, options, mesh=mesh)
    assert int(best.status) == 0 and best.cost == pytest.approx(m_cost.min(), rel=1e-12)


def test_lanes_that_do_not_divide_raise():
    problem, _X, _U = flywheel_problem(N=N)
    guesses = _guesses(problem._compile()["n"])[:3]
    with pytest.raises(ValueError, match="do not split evenly"):
        solve_ipm_batched(problem, guesses, Options(device="cpu"), mesh=Mesh.of(["cpu"] * 2))


def test_shard_batch_splits_lanes_in_order():
    states = (torch.arange(12.0).reshape(6, 2), (torch.arange(6),))
    mesh = Mesh.of(["cpu"] * 3, "batch")
    parts = shard_batch(states, mesh)
    assert len(parts) == 3
    assert [p[1][0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert torch.equal(torch.cat([p[0] for p in parts]), states[0])
    with pytest.raises(ValueError):
        shard_batch(states, Mesh.of(["cpu"] * 4, "batch"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            default_mesh()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the groups' threads and graphs run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_mesh_on_one_card_builds_each_groups_step_once(cuda_device):
    """Two lane groups on one card, each driven from a thread of its own:
    the first call builds one lane step per group and captures its graphs;
    the second builds none, captures nothing, and answers as the first,
    bit for bit."""
    problem, _X, _U = flywheel_problem(N=N)
    guesses = _guesses(problem._compile()["n"])
    mesh = Mesh.of(["cuda:0", "cuda:0"], "batch")
    answers = []
    for built in (2, 0):
        status, cost, xs, final = solve_ipm_batched(problem, guesses, Options(device="cuda"),
                                                    mesh=mesh)
        stats = problem.last_solve_stats
        assert status.tolist() == [0] * LANES
        assert stats.lane_steps_built == built and (stats.graph_captures > 0) == bool(built)
        answers.append((status, torch.cat([f.iterations for f in final]).cpu().numpy(), cost, xs))
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)
