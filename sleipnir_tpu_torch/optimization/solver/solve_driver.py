"""Solver loop driver: calls a step function until the status leaves
RUNNING.

Port of `sleipnir_tpu/optimization/solver/solve_driver.py` as a host
loop. With callbacks, each iteration first builds an `IterationInfo` and
calls every callback, matching the reference's per-iteration callback
semantics (reference interior_point.hpp:413-417); with diagnostics, each
step is followed by its table row, and profilers time the segments.

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
from sleipnir_tpu_torch.util.profiler import span


def run_solver(
    state,
    step: Callable,
    options: Options,
    callbacks: Sequence[Callable] = (),
    info_fn: Callable | None = None,
    restoration_handler: Callable | None = None,
    diagnostics_fn: Callable | None = None,
    start_time: float | None = None,
    profilers: dict | None = None,
):
    """Drive `step` until the state's status leaves RUNNING. Returns the
    final state, with a terminal ExitStatus in `.status`.

    With `options.diagnostics`, `diagnostics_fn(prev, after)` prints each
    step's table row. `profilers`, when given, is a dict of SolveProfilers
    keyed "solve", "iterate", "restoration", "callbacks" (reference
    interior_point.hpp:155-237). Every step ends in a host read, so the
    "iterate" timer measures the device's work, not its dispatch."""
    if start_time is None:
        start_time = time.monotonic()
    if profilers is not None:
        profilers["solve"].start()
    while True:
        if state.status == status_codes.RUNNING:
            if state.iterations >= options.max_iterations:
                state = state._replace(status=int(ExitStatus.MAX_ITERATIONS_EXCEEDED))
                break
            if time.monotonic() - start_time > options.timeout:
                state = state._replace(status=int(ExitStatus.TIMEOUT))
                break
            if callbacks and info_fn is not None:
                if profilers is not None:
                    profilers["callbacks"].start()
                info = info_fn(state)
                stop = False
                for cb in callbacks:
                    if cb(info):
                        stop = True
                if profilers is not None:
                    profilers["callbacks"].stop()
                if stop:
                    state = state._replace(status=int(ExitStatus.CALLBACK_REQUESTED_STOP))
                    break
            prev = state
            if profilers is not None:
                profilers["iterate"].start()
            with span("slp.iteration"):
                state = step(state)
            if profilers is not None:
                profilers["iterate"].stop()
            if options.diagnostics and diagnostics_fn is not None:
                diagnostics_fn(prev, state)
        elif state.status == status_codes.FEASIBILITY_RESTORATION_REQUESTED:
            if restoration_handler is None:
                state = state._replace(status=int(ExitStatus.FEASIBILITY_RESTORATION_FAILED))
                break
            if profilers is not None:
                profilers["restoration"].start()
            state = restoration_handler(state, start_time)
            if profilers is not None:
                profilers["restoration"].stop()
            if state.status == status_codes.FEASIBILITY_RESTORATION_REQUESTED:
                state = state._replace(status=int(ExitStatus.FEASIBILITY_RESTORATION_FAILED))
                break
        else:
            break
    if profilers is not None:
        profilers["solve"].stop()
    return state
