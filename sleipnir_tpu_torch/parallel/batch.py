"""Batched solves: many starting points of one problem as the lanes of one
interior-point solve on the device.

Port of `sleipnir_tpu/parallel/batch.py`. The reference's only
parallelism is one OS thread per multistart guess (reference
optimization/multistart.hpp:54-56); the JAX package vmaps its solver
state over the guesses. Here the state carries a lane axis and
`lanes.make_lane_interior_point` advances all lanes together: every
derivative evaluation, every K1 ladder and every K2 solve serves all
lanes at once.

Not carried over: the JAX package re-solves the multistart winner
because a vmapped TPU solve runs on the matrix unit's f64 emulation
(`sleipnir_tpu/parallel/batch.py:12-17,159-173`); on the card every lane
is native f64 and reaches the full tolerance. `default_mesh` and
`shard_batch` (several devices) wait for ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import math
import time
from typing import Sequence

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.multistart import MultistartResult
from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs
from sleipnir_tpu_torch.parallel.lanes import make_lane_interior_point


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "batched solves over several devices are not ported yet "
            "(ROADMAP queue 1 item 9); pass mesh=None"
        )


def make_batched_runner(step, mesh=None, axis: str = "batch", *,
                        syncs: HostSyncs | None = None, timeout: float = math.inf):
    """A runner driving lane-axis solver states to completion.

    `step(states, run)` advances the lanes of the mask `run`. A lane
    leaves the batch once its status leaves RUNNING; the loop ends when
    no lane is RUNNING below the iteration cap (or at `timeout` seconds,
    which ends the running lanes as TIMEOUT). One host read per
    iteration decides it."""
    _no_mesh(mesh)
    syncs = HostSyncs() if syncs is None else syncs

    def run(states, cap):
        start = time.monotonic()
        while True:
            running = (states.status == status_codes.RUNNING) & (states.iterations < int(cap))
            if not syncs.read(running.any()):
                return states
            if time.monotonic() - start > timeout:
                timed_out = torch.where(running, int(ExitStatus.TIMEOUT), states.status)
                return states._replace(status=timed_out)
            states = step(states, running)

    return run


def solve_ipm_batched(
    problem,
    initial_guesses: Sequence[np.ndarray],
    options: Options | None = None,
    mesh=None,
    max_iterations: int | None = None,
):
    """Solve an inequality-constrained problem from many starting points
    in one batched solve on `options.device` (the card by default).

    Returns (statuses, costs, xs, final): numpy arrays with a leading lane
    axis, and the final lane-axis `IPMState`."""
    _no_mesh(mesh)
    if options is None:
        options = Options()
    comp, bundle = problem.prepare_ipm(options)
    *_, funcs, _g_fn, backend = bundle
    params = comp["compiled"].gather_params()

    starts, scalings, rows0 = [], [], None
    for guess in initial_guesses:
        x0 = np.asarray(guess, dtype=np.float64).ravel()
        scaling, rows = problem.compute_ipm_scaling(comp, bundle, x0, params)
        if isinstance(rows, tuple):
            # The banded backend's per-row probes: one structure for all.
            if rows0 is None:
                rows0 = rows
            elif rows[0].shape != rows0[0].shape or not np.array_equal(rows[1], rows0[1]):
                raise ValueError("initial guesses give different inequality row structures")
        starts.append(x0)
        scalings.append(scaling)
    L = len(starts)
    init, step = make_lane_interior_point(funcs, options, backend=backend)
    sc = ScalingArrays(
        f=np.array([s.f for s in scalings]),
        c_e=np.stack([s.c_e for s in scalings]).reshape(L, comp["me"]),
        c_i=np.stack([s.c_i for s in scalings]).reshape(L, comp["mi"]),
    )
    states = init(
        np.stack(starts), np.ones((L, comp["mi"])), np.zeros((L, comp["me"])),
        np.ones((L, comp["mi"])), 0.1 * sc.f, params, sc,
    )
    runner = make_batched_runner(step, syncs=backend.syncs, timeout=options.timeout)
    cap = max_iterations if max_iterations is not None else options.max_iterations
    final = runner(states, cap)
    return (final.status.cpu().numpy(), final.f.cpu().numpy(), final.x.cpu().numpy(), final)


def multistart_batched(
    problem,
    initial_guesses: Sequence[np.ndarray],
    options: Options | None = None,
    mesh=None,
) -> MultistartResult:
    """Batched multistart: prefer SUCCESS, then lowest cost (reference
    optimization/multistart.hpp:66-74), over the lanes of one batched
    solve."""
    statuses, costs, xs, _ = solve_ipm_batched(problem, initial_guesses, options, mesh)
    order = sorted(
        range(len(initial_guesses)),
        key=lambda i: (int(statuses[i] != int(ExitStatus.SUCCESS)), costs[i]),
    )
    best = order[0]
    return MultistartResult(ExitStatus(int(statuses[best])), float(costs[best]), xs[best])
