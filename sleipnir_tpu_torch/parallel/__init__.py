"""Batched solves: the guesses of a multistart as the lanes of one
interior-point solve (port of `sleipnir_tpu.parallel`; sharding over
several devices is ROADMAP queue 1 item 9)."""

from sleipnir_tpu_torch.parallel.batch import (
    make_batched_runner,
    multistart_batched,
    solve_ipm_batched,
)

__all__ = [
    "make_batched_runner",
    "multistart_batched",
    "solve_ipm_batched",
]
