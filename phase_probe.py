"""Where an iteration of the cart-pole IPM solve spends its time.

Run from the repository root on a machine with a CUDA card:

    python3 phase_probe.py                 # cart-pole N=100 on the card
    python3 phase_probe.py --device cpu --n 10 --timed 5 --profiled 3

One solve through `Problem.solve`, stopped after warm + timed + profiled
iterations (it ends as MAX_ITERATIONS_EXCEEDED), in three windows:

  warm-up   not measured: the kernels build and the solver's caches fill;
  timed     each phase below runs between two device syncs, timed on the
            host clock; a phase called inside another counts in the outer;
  profiled  torch.profiler without the phase syncs: the device's busy
            share of the wall time, device ops per iteration, the ops that
            take the most device time.

Phases: `BandedBackend.eval_derivs` (colored derivative probes),
`factor` (assembly, equilibration, the K1 kernel on the regularization
ladder, inertia), `solve_refined` (three K2 solves), and the compiled
problem's f, c_e and c_i when called outside them (the line search).
"""

from __future__ import annotations

import argparse
import collections
import functools
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

import sleipnir_tpu_torch.optimization.problem as problem_module
from sleipnir_tpu_torch.autodiff.vectorize import BlockCompiler
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend

PHASES = {
    BandedBackend: ("eval_derivs", "factor", "solve_refined"),
    BlockCompiler: ("f", "c_e", "c_i"),
}


class Probe:
    """Phase timers around class methods and an iteration-window hook."""

    def __init__(self, device: torch.device, warm: int, timed: int) -> None:
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.warm, self.timed = warm, timed
        self.timing = False
        self.depth = 0
        self.seconds: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.timed_wall = 0.0
        self.profiled_start = 0.0
        self.profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
        )

    def wrap(self, cls, name: str) -> None:
        inner = getattr(cls, name)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            if not self.timing or self.depth:
                return inner(*args, **kwargs)
            self.sync()
            self.depth += 1
            t0 = time.perf_counter()
            try:
                out = inner(*args, **kwargs)
                self.sync()
            finally:
                self.depth -= 1
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        setattr(cls, name, timed)

    def on_iteration(self, k: int) -> None:
        if k == self.warm:
            self.sync()
            self.timing = True
            self.timed_wall = time.perf_counter()
        elif k == self.warm + self.timed:
            self.sync()
            self.timing = False
            self.timed_wall = time.perf_counter() - self.timed_wall
            self.profiler.start()
            self.profiled_start = time.perf_counter()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=100, help="cart-pole stages N")
    parser.add_argument("--warm", type=int, default=3)
    parser.add_argument("--timed", type=int, default=30)
    parser.add_argument("--profiled", type=int, default=10)
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("torch.cuda.is_available() is false")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)

    probe = Probe(device, args.warm, args.timed)
    for cls, names in PHASES.items():
        for name in names:
            probe.wrap(cls, name)
    run_solver = problem_module.run_solver

    def run_solver_with_hook(state, step, options, **kwargs):
        def hooked_step(st):
            probe.on_iteration(st.iterations)
            return step(st)

        return run_solver(state, hooked_step, options, **kwargs)

    problem_module.run_solver = run_solver_with_hook

    problem, _X, _U = cart_pole_problem(N=args.n, total_time=5.0)
    total = args.warm + args.timed + args.profiled
    status = problem.solve(device=args.device, max_iterations=total)
    probe.sync()
    profiled_wall = time.perf_counter() - probe.profiled_start
    probe.profiler.stop()
    stats = problem.last_solve_stats
    print(f"cart-pole N={args.n} on {args.device}: {status}, {stats.iterations} iterations, "
          f"host syncs/iteration {stats.host_syncs_per_iteration:.2f}", flush=True)
    if stats.iterations != total:
        sys.exit(f"the solve ended after {stats.iterations} of {total} iterations")

    per_it = 1e3 / args.timed
    print(f"timed {args.timed} iterations from iteration {args.warm}: {probe.timed_wall:.3f} s, "
          f"{probe.timed_wall * per_it:.1f} ms/iteration", flush=True)
    for name, s in probe.seconds.most_common():
        print(f"  {name:14s} {s * per_it:9.2f} ms/iteration  {100 * s / probe.timed_wall:5.1f}%  "
              f"{probe.calls[name]:4d} calls", flush=True)
    rest = probe.timed_wall - sum(probe.seconds.values())
    print(f"  {'(rest)':14s} {rest * per_it:9.2f} ms/iteration  "
          f"{100 * rest / probe.timed_wall:5.1f}%", flush=True)

    events = [e for e in probe.profiler.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profiled {args.profiled} iterations: wall {profiled_wall:.3f} s; "
              "device activity not measured (the profiler saw no device events)", flush=True)
        return
    busy_us: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in events:
        busy_us[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    busy = sum(busy_us.values()) / 1e6
    print(f"profiled {args.profiled} iterations: wall {profiled_wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / profiled_wall:.2f}%), {len(events)} device ops "
          f"({len(events) / args.profiled:.0f}/iteration)", flush=True)
    for name, us in busy_us.most_common(8):
        print(f"  {us / 1e3:9.3f} ms  {count[name]:6d} ops  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
