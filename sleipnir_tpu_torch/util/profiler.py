"""Wall-clock profilers (reference util/profiler.hpp:15-160).

Port of `sleipnir_tpu/util/profiler.py`: host-side timers. Device work is
asynchronous under PyTorch, so a timer around device calls measures
dispatch unless the caller synchronizes. Every solver step of the port
ends in a host read (`HostSyncs`), so `run_solver`'s per-iteration timer
measures the card's work, not only its dispatch.
"""

from __future__ import annotations

import time


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


class ScopedProfiler:
    """Context-manager RAII wrapper (reference util/profiler.hpp:139)."""

    def __init__(self, profiler: SolveProfiler) -> None:
        self._profiler = profiler

    def __enter__(self) -> "ScopedProfiler":
        self._profiler.start()
        return self

    def __exit__(self, *exc) -> None:
        self._profiler.stop()
