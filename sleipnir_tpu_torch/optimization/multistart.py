"""Multistart: solve from several initial guesses, keep the best
(reference optimization/multistart.hpp:45-76 and
python/src/sleipnir/optimization/__init__.py:6-33).

Port of `sleipnir_tpu/optimization/multistart.py`. The reference runs one
OS thread per initial guess. Here the parallel unit is a lane axis: pass
a Problem and `multistart` solves every guess in one batched
interior-point solve on the device (`sleipnir_tpu_torch.parallel.batch`).
The callable form, the reference's API, where each guess gets a
user-built problem, runs the closures one after another.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus


class MultistartResult(NamedTuple):
    """The result of a multistart solve (reference multistart.hpp:22-29)."""

    #: The solver exit status.
    status: ExitStatus
    #: The solution's cost.
    cost: float
    #: The decision variables.
    variables: object


def multistart(
    solve: Callable[[object], MultistartResult] | object,
    initial_guesses: Sequence[object],
    options=None,
    mesh=None,
) -> MultistartResult:
    """Solve from each initial guess; prefer SUCCESS, then lowest cost
    (reference multistart.hpp:66-74).

    Two forms:
      - ``multistart(problem, guesses)`` with a Problem: guesses are flat
        decision vectors, solved as the lanes of one batched solve on
        ``options.device`` (the card unless the options say otherwise);
      - ``multistart(solve_fn, guesses)`` with a callable returning a
        MultistartResult per guess: runs each closure in sequence.
    """
    if hasattr(solve, "prepare_ipm"):
        from sleipnir_tpu_torch.parallel.batch import (  # noqa: PLC0415
            multistart_batched,
        )

        return multistart_batched(solve, initial_guesses, options, mesh)

    results = [solve(guess) for guess in initial_guesses]
    return min(results, key=lambda r: (int(r.status != ExitStatus.SUCCESS), r.cost))
