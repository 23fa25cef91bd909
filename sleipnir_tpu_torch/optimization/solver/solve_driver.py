"""Solver loop driver: calls a step function until the status leaves
RUNNING.

Port of `sleipnir_tpu/optimization/solver/solve_driver.py` as a host
loop. With callbacks, each iteration first builds an `IterationInfo` and
calls every callback, matching the reference's per-iteration callback
semantics (reference interior_point.hpp:413-417).

Feasibility restoration changes the problem shape, so a step signals it
through a status sentinel and `run_solver` hands the state to a
`restoration_handler`; without one the solve ends as
FEASIBILITY_RESTORATION_FAILED.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.options import Options


def run_solver(
    state,
    step: Callable,
    options: Options,
    callbacks: Sequence[Callable] = (),
    info_fn: Callable | None = None,
    restoration_handler: Callable | None = None,
    start_time: float | None = None,
):
    """Drive `step` until the state's status leaves RUNNING. Returns the
    final state, with a terminal ExitStatus in `.status`."""
    if start_time is None:
        start_time = time.monotonic()
    while True:
        if state.status == status_codes.RUNNING:
            if state.iterations >= options.max_iterations:
                return state._replace(status=int(ExitStatus.MAX_ITERATIONS_EXCEEDED))
            if time.monotonic() - start_time > options.timeout:
                return state._replace(status=int(ExitStatus.TIMEOUT))
            if callbacks and info_fn is not None:
                info = info_fn(state)
                stop = False
                for cb in callbacks:
                    if cb(info):
                        stop = True
                if stop:
                    return state._replace(status=int(ExitStatus.CALLBACK_REQUESTED_STOP))
            state = step(state)
        elif state.status == status_codes.FEASIBILITY_RESTORATION_REQUESTED:
            if restoration_handler is None:
                return state._replace(
                    status=int(ExitStatus.FEASIBILITY_RESTORATION_FAILED)
                )
            state = restoration_handler(state, start_time)
            if state.status == status_codes.FEASIBILITY_RESTORATION_REQUESTED:
                return state._replace(
                    status=int(ExitStatus.FEASIBILITY_RESTORATION_FAILED)
                )
        else:
            return state
