"""Wall-clock profilers (reference util/profiler.hpp:15-160) and the
program's named ranges.

Port of `sleipnir_tpu/util/profiler.py`: host-side timers. Device work is
asynchronous under PyTorch, so a timer around device calls measures
dispatch unless the caller synchronizes. Every solver step of the port
ends in a host read (`HostSyncs`), so `run_solver`'s per-iteration timer
measures the card's work, not only its dispatch.

`span(name)` marks a stretch of the program's host work for
`torch.profiler`: a range on the profiler's clock, in the same trace as
the card's operations, so that each operation and each idle gap of the
card can be joined to what the host was doing. Every name starts with
`slp.`; a request's ranges nest under its `slp.solve` on one thread:

  slp.solve             one request: `Problem.solve`, `solve_ipm_batched`;
  slp.iteration         one (batched) step of the solver loop;
  slp.host_read         `HostSyncs.read`: the host blocked on the card;
  slp.graph_replay|<g>  a replay of the graphed function g: input copies,
                        the replay, output clones;
  slp.graph_capture|<g> a capture of g, its eager warm-up included;
  slp.factor            the KKT backend's factor (assembly, scaling, the
                        regularization ladder, inertia), serial or lanes;
  slp.solve_refined     the KKT backend's solve with refinement;
  slp.kkt_factor|B|K|w|dtype, slp.kkt_solve|B|K|w|r|dtype
                        `BandedBackend._chain_factor` / `chain_solve`, the
                        call of the factor's form, with its shape;
  slp.lane_scaling      the lanes' per-guess scaling on the host.

A range is opened only while a profiler collects; otherwise `span`
returns one shared null context and costs a flag read. The ranges are
function-scope records, not user annotations, so the profiler keeps them
on the host's timeline and mirrors none onto the card's.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


def span(name: str, *parts):
    """A profiler range named `name`, with `parts` (sizes, a dtype) joined
    to it by "|", while a profiler collects; else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    if parts:
        name = "|".join([name, *(str(p).removeprefix("torch.") for p in parts)])
    return torch._C._profiler._RecordFunctionFast(name)


class SetupProfiler:
    """One-shot timer (reference util/profiler.hpp:15)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._start = 0.0
        self.duration = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        self.duration = time.perf_counter() - self._start


class SolveProfiler:
    """Count + running average + total timer (reference util/profiler.hpp:60)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.current = 0.0
        self._start = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        self.current = time.perf_counter() - self._start
        self.total += self.current
        self.count += 1

    @property
    def average(self) -> float:
        return self.total / self.count if self.count else 0.0
