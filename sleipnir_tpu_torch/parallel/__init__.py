"""Batched solves: the guesses of a multistart as the lanes of one
interior-point solve, over one device or split over a mesh of several;
and the time-axis split of the KKT factor (port of
`sleipnir_tpu.parallel`)."""

from sleipnir_tpu_torch.parallel.batch import (
    default_mesh,
    make_batched_runner,
    multistart_batched,
    shard_batch,
    solve_ipm_batched,
)
from sleipnir_tpu_torch.parallel.time_axis import Mesh

__all__ = [
    "Mesh",
    "default_mesh",
    "make_batched_runner",
    "multistart_batched",
    "shard_batch",
    "solve_ipm_batched",
]
