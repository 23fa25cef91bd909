"""Scalability sweep of the port: setup and solve time across horizons.

    python -m sleipnir_tpu_torch.tools.scalability flywheel --samples 100 200 500
    python -m sleipnir_tpu_torch.tools.scalability cart_pole --samples 100 150 \\
        --out build/cart-pole-scalability-results-h100.csv
    python -m sleipnir_tpu_torch.tools.scalability flywheel --samples 10 --device cpu

The counterpart of `benchmarks/scalability.py`: the same problems
(`models.flywheel.flywheel_problem` and `models.cart_pole.cart_pole_problem`,
5 s horizons), the same initial guesses, and the same two times. Setup is
the problem's construction plus its first solve (the kernels' build, the
solver's set-up and its CUDA graph captures included); solve is the best
of three re-solves from the benchmark's initial guess with everything
warm. Both are wall times on the host clock, the solve synchronized with
the device.

Where the reference harness asserts SUCCESS, a size that ends in another
status is reported with its status and iterations and the sweep runs on.
Each size prints its status, iterations, host syncs per iteration and peak
device memory on a line of its own; `--out` receives the reference
schema's three columns (`Samples,Setup time (ms),Solve time (ms)`) for the
sizes that reached SUCCESS, and nothing else.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.models.flywheel import flywheel_problem
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus

HEADER = "Samples,Setup time (ms),Solve time (ms)"
#: Re-solves timed per size; the best counts (benchmarks/scalability.py).
RESOLVES = 3


class Sample(NamedTuple):
    N: int
    status: ExitStatus  # the first failing solve's status, else SUCCESS
    iterations: int  # of the last solve run
    host_syncs_per_iteration: float
    setup_ms: float
    solve_ms: float  # best of the re-solves; nan when a solve failed
    peak_bytes: int | None  # peak device memory; None on the CPU


def _flywheel(N: int):
    problem, X, U = flywheel_problem(N=N, total_time=5.0)

    def guess():
        X.set_value(np.zeros((1, N + 1)))
        U.set_value(np.zeros((1, N + 1)))

    return problem, guess


def _cart_pole(N: int):
    problem, X, U = cart_pole_problem(N=N, total_time=5.0)
    initial = np.zeros((4, N + 1))
    initial[0] = np.linspace(0.0, 1.0, N + 1)
    initial[1] = np.linspace(0.0, math.pi, N + 1)

    def guess():
        X.set_value(initial)
        U.set_value(np.zeros((1, N + 1)))

    return problem, guess


PROBLEMS = {"flywheel": _flywheel, "cart_pole": _cart_pole}


def run(name: str, N: int, device: str) -> Sample:
    """Setup and best-of-three solve of one size, with what it counted."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem, guess = PROBLEMS[name](N)
    status = problem.solve(device=device)
    sync()
    setup_ms = (time.perf_counter() - t0) * 1e3
    times = []
    if status == ExitStatus.SUCCESS:
        for _ in range(RESOLVES):
            guess()
            t0 = time.perf_counter()
            status = problem.solve(device=device)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            if status != ExitStatus.SUCCESS:
                break
    stats = problem.last_solve_stats
    ok = status == ExitStatus.SUCCESS
    return Sample(
        N, status, stats.iterations, stats.host_syncs_per_iteration, setup_ms,
        min(times) if ok else math.nan,
        torch.cuda.max_memory_allocated() if on_card else None,
    )


def describe(name: str, s: Sample, device: str) -> str:
    memory = (f"peak device memory {s.peak_bytes / 2**20:.1f} MiB" if s.peak_bytes is not None
              else "peak device memory not measured (CPU)")
    return (f"{name} N={s.N} on {device}: {s.status}, {s.iterations} iterations, "
            f"host syncs/iteration {s.host_syncs_per_iteration:.2f}, setup {s.setup_ms:.3f} ms, "
            f"solve {s.solve_ms:.3f} ms, {memory}")


def write_csv(path: pathlib.Path, samples: list[Sample]) -> None:
    """The reference schema, SUCCESS sizes only."""
    rows = [HEADER] + [f"{s.N},{s.setup_ms:.3f},{s.solve_ms:.3f}"
                       for s in samples if s.status == ExitStatus.SUCCESS]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(rows) + "\n")


def read_csv(path: pathlib.Path) -> list[tuple[int, float, float]]:
    """(Samples, setup ms, solve ms) rows of a reference-schema CSV."""
    lines = path.read_text().splitlines()
    if lines[0] != HEADER:
        raise ValueError(f"{path}: header {lines[0]!r} is not {HEADER!r}")
    return [(int(n), float(a), float(b)) for n, a, b in (line.split(",") for line in lines[1:])]


def main(argv: list[str] | None = None) -> list[Sample]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("problem", choices=sorted(PROBLEMS))
    parser.add_argument("--samples", type=int, nargs="+", default=[100, 200, 300, 400, 500])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="CSV path (default build/<problem>-scalability-results-<device>.csv)")
    args = parser.parse_args(argv)
    out = args.out or pathlib.Path("build") / (
        f"{args.problem.replace('_', '-')}-scalability-results-{args.device}.csv")

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is false")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)
    samples = []
    for N in args.samples:
        sample = run(args.problem, N, args.device)
        print(describe(args.problem, sample, args.device), flush=True)
        samples.append(sample)
    write_csv(out, samples)
    failed = [s.N for s in samples if s.status != ExitStatus.SUCCESS]
    print(f"wrote {out}: {len(samples) - len(failed)} sizes"
          + (f"; not SUCCESS at N={failed}" if failed else ""), flush=True)
    return samples


if __name__ == "__main__":
    main()
