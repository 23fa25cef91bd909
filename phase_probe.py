"""Where an iteration of an IPM solve of the port spends its time.

Run from the repository root on a machine with a CUDA card:

    python3 phase_probe.py                                 # cart-pole N=100
    python3 phase_probe.py --problem cart_pole --N 1000
    python3 phase_probe.py --problem flywheel --N 5000
    python3 phase_probe.py --problem restoration --N 2000
    python3 phase_probe.py --problem flywheel_sqp --N 5000 --warm 1
    python3 phase_probe.py --problem flywheel_dense --N 1000
    python3 phase_probe.py --problem flywheel_min_time --N 5000
    python3 phase_probe.py --problem cart_pole_batch --lanes 8
    python3 phase_probe.py --device cpu --N 10 --timed 5 --profiled 3

One solve through `Problem.solve`, run to its end, with the parent's
iterations in three windows:

  warm-up   not measured: the kernels build and the solver's caches fill;
  timed     each phase below runs between two device syncs, timed on the
            host clock; a phase called inside another counts in the outer;
  profiled  torch.profiler without the phase syncs: the device's busy
            share of the wall time, device ops per iteration, the ops that
            take the most device time.

A window that the solve does not reach is reported as such. Phases:
`BandedBackend.eval_derivs` (colored derivative probes), `factor`
(assembly, equilibration, the K1 kernel on the regularization ladder,
inertia), `solve_refined` (three K2 solves), the same three of
`DenseBackend` (dense derivatives, the blocked LDLᵀ of the ladder, three
triangular-solve pairs), the compiled problem's f,
c_e and c_i when called outside them (the line search), and `restore`
(feasibility restoration, whatever it runs inside). Iteration counts
include the restoration solver's iterations, as the JAX package counts
them. The whole solve's wall time, its exit status, and the restoration
entries with their time and iterations are reported as well.

`flywheel_sqp` is the flywheel without input bounds (SQP on the banded
backend), `flywheel_dense` its plain-Problem form with bounds (the dense
interior-point method), `flywheel_min_time` its minimum-time spin-up with
one shared timestep (the banded backend with its border column); there
`factor` also reports the border's share, `_border_schur` (the K2 solves
of T⁻¹·col on the ladder and the border Schur complement), timed inside
it. `--problem restoration` runs feasibility restoration alone, from the
strongly infeasible cart-pole iterate that `chip_smoke.py` uses, with
every restoration iteration in the timed window (no profiled window).
`--problem cart_pole_batch` solves cart-pole from `--lanes` guesses
0.01·k·randn(n) (seed 0, as `chip_smoke.py` phase 12) as the lanes of one
`solve_ipm_batched` solve; its windows count batched iterations, and its
`factor` and `solve_refined` are the lane-axis ones of `parallel/lanes.py`
(every lane's ladder in one K1 launch, every lane's solves in one K2
launch); `eval_derivs` and f, c_e, c_i run under `vmap` over lanes.
"""

from __future__ import annotations

import argparse
import collections
import functools
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

import sleipnir_tpu_torch.optimization.problem as problem_module
from sleipnir_tpu_torch.autodiff.vectorize import BlockCompiler
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from sleipnir_tpu_torch.models.flywheel import (
    flywheel_min_time_problem,
    flywheel_problem,
    flywheel_unbounded_problem,
)
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.parallel import batch as batch_module
from sleipnir_tpu_torch.parallel.lanes import _BandedLanes

PHASES = {
    BandedBackend: ("eval_derivs", "factor", "solve_refined"),
    DenseBackend: ("eval_derivs", "factor", "solve_refined"),
    BlockCompiler: ("f", "c_e", "c_i"),
    problem_module: ("restore",),
    _BandedLanes: ("factor", "solve_refined"),
}
#: Phases timed inside another phase, reported as a part of it: name ->
#: the outer phase.
INNER_PHASES = {BandedBackend: {"_border_schur": "factor"}}
PROBLEMS = {
    "cart_pole": cart_pole_problem,
    "flywheel": flywheel_problem,
    "flywheel_sqp": flywheel_unbounded_problem,
    "flywheel_dense": functools.partial(flywheel_problem, fast=False),
    "flywheel_min_time": lambda N, total_time: flywheel_min_time_problem(N=N),
}


class Probe:
    """Phase timers around functions and an iteration-window hook."""

    def __init__(self, device: torch.device, warm: int, timed: int, profiled: int) -> None:
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.bounds = (warm, warm + timed, warm + timed + profiled)
        self.window = 0  # 0 warm-up, 1 timed, 2 profiled, 3 done
        self.marks: dict = {}  # window -> (iteration, host time) at its start
        self.depth = 0
        self.seconds: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.restorations: list = []  # (seconds, iterations) per entry
        self.profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]
            + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
        )

    def wrap(self, owner, name: str, nested: bool = False) -> None:
        """Time `owner.name` in the timed window: outside any other phase,
        or (`nested`) inside one as a part of it."""
        inner = getattr(owner, name)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            if self.window != 1 or (self.depth and not nested):
                return inner(*args, **kwargs)
            self.sync()
            self.depth += 0 if nested else 1
            t0 = time.perf_counter()
            try:
                out = inner(*args, **kwargs)
                self.sync()
            finally:
                self.depth -= 0 if nested else 1
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        setattr(owner, name, timed)

    def count_restorations(self) -> None:
        inner = problem_module.restore

        @functools.wraps(inner)
        def counted(parent, parent_state, *args, **kwargs):
            t0 = time.perf_counter()
            out = inner(parent, parent_state, *args, **kwargs)
            self.sync()
            self.restorations.append((time.perf_counter() - t0, out[-1] - parent_state.iterations))
            return out

        problem_module.restore = counted

    def on_iteration(self, k: int) -> None:
        """Called before each parent step with its iteration count."""
        while self.window < 3 and k >= self.bounds[self.window]:
            self.sync()
            self.window += 1
            self.marks[self.window] = (k, time.perf_counter())
            if self.window == 2:
                self.profiler.start()
            elif self.window == 3:
                self.profiler.stop()

    def finish(self, k: int) -> None:
        """Close the open window at the end of the solve."""
        self.sync()
        if self.window in (1, 2):
            self.marks[self.window + 1] = (k, time.perf_counter())
            if self.window == 2:
                self.profiler.stop()
            self.window = 3

    def span(self, window: int):
        """(iterations, seconds) the window covered, or None."""
        if window not in self.marks or window + 1 not in self.marks:
            return None
        (k0, t0), (k1, t1) = self.marks[window], self.marks[window + 1]
        return (k1 - k0, t1 - t0) if k1 > k0 else None


def report_timed(probe: Probe, iterations: int) -> None:
    timed = probe.span(1)
    if timed is None:
        print(f"timed window: not reached (the solve ended after {iterations} iterations)")
        return
    iters, seconds = timed
    per_it = 1e3 / iters
    print(f"timed {iters} iterations from iteration {probe.marks[1][0]}: {seconds:.3f} s, "
          f"{seconds * per_it:.1f} ms/iteration", flush=True)
    inner = {name: outer for names in INNER_PHASES.values() for name, outer in names.items()}

    def line(label, s, calls):
        print(f"  {label:14s} {s * per_it:9.2f} ms/iteration  {100 * s / seconds:5.1f}%  "
              f"{calls:4d} calls", flush=True)

    for name, s in probe.seconds.most_common():
        if name in inner:
            continue
        line(name, s, probe.calls[name])
        for part, outer in inner.items():
            if outer == name and part in probe.seconds:
                line(f"  of which {part}", probe.seconds[part], probe.calls[part])
    rest = seconds - sum(s for name, s in probe.seconds.items() if name not in inner)
    print(f"  {'(rest)':14s} {rest * per_it:9.2f} ms/iteration  "
          f"{100 * rest / seconds:5.1f}%", flush=True)


def report_profiled(probe: Probe) -> None:
    profiled = probe.span(2)
    if profiled is None:
        print("profiled window: not reached", flush=True)
        return
    iters, seconds = profiled
    events = [e for e in probe.profiler.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profiled {iters} iterations: wall {seconds:.3f} s; "
              "device activity not measured (the profiler saw no device events)", flush=True)
        return
    busy_us: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in events:
        busy_us[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    busy = sum(busy_us.values()) / 1e6
    print(f"profiled {iters} iterations: wall {seconds:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / seconds:.2f}%), {len(events)} device ops "
          f"({len(events) / iters:.0f}/iteration)", flush=True)
    for name, us in busy_us.most_common(8):
        print(f"  {us / 1e3:9.3f} ms  {count[name]:6d} ops  {name[:90]}", flush=True)


def batched(probe: Probe, device: torch.device, n_steps: int, lanes: int) -> None:
    """Cart-pole from `lanes` guesses as one batched solve; the windows
    count batched iterations (steps of the lane-axis runner)."""
    problem, _X, _U = cart_pole_problem(N=n_steps, total_time=5.0)
    rng = np.random.default_rng(0)
    n = problem._compile()["n"]
    guesses = [0.01 * k * rng.standard_normal(n) for k in range(lanes)]
    make_step = batch_module.make_lane_interior_point
    steps = [0]

    def hooked(*args, **kwargs):
        init, step = make_step(*args, **kwargs)

        def hooked_step(states, run):
            probe.on_iteration(steps[0])
            steps[0] += 1
            return step(states, run)

        return init, hooked_step

    batch_module.make_lane_interior_point = hooked
    options = Options(device=device.type)
    syncs = problem.prepare_ipm(options)[1][-1].syncs
    before = syncs.count
    t0 = time.perf_counter()
    statuses, _costs, _xs, final = batch_module.solve_ipm_batched(problem, guesses, options)
    probe.sync()
    wall = time.perf_counter() - t0
    probe.finish(steps[0])
    print(f"cart_pole_batch N={n_steps} L={lanes} on {device.type}: statuses "
          f"{statuses.tolist()}, iterations {final.iterations.tolist()}, {steps[0]} batched "
          f"iterations, solve {wall:.3f} s ({wall * 1e3 / max(steps[0], 1):.1f} ms/batched "
          f"iteration), host syncs/batched iteration "
          f"{(syncs.count - before) / max(steps[0], 1):.3f}", flush=True)
    report_timed(probe, steps[0])
    report_profiled(probe)


def restoration(probe: Probe, device: torch.device, n: int) -> None:
    """Restoration alone from the infeasible cart-pole iterate, all of it
    in the timed window."""
    from chip_smoke import restoration_start  # noqa: PLC0415
    from sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration import (  # noqa: PLC0415
        restore,
    )

    funcs, state, options, backend, violation = restoration_start(n, device)
    v0 = violation(state.x)
    probe.window = 1
    probe.marks[1] = (0, time.perf_counter())
    outcome, x_new, _s, _y, _z, iterations = restore(funcs, state, options,
                                                     parent_backend=backend)
    probe.sync()
    probe.marks[2] = (iterations, time.perf_counter())
    probe.window = 3
    print(f"restoration cart-pole N={n} on {device.type}: {outcome} after {iterations} "
          f"iterations, violation {v0:.6g} -> {violation(x_new):.6g}", flush=True)
    report_timed(probe, iterations)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--problem", choices=sorted(PROBLEMS) + ["cart_pole_batch", "restoration"],
                        default="cart_pole")
    parser.add_argument("--N", type=int, default=100, help="horizon steps")
    parser.add_argument("--lanes", type=int, default=8, help="guesses of cart_pole_batch")
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

    probe = Probe(device, args.warm, args.timed, args.profiled)
    probe.count_restorations()
    for owner, names in PHASES.items():
        for name in names:
            probe.wrap(owner, name)
    for owner, names in INNER_PHASES.items():
        for name in names:
            probe.wrap(owner, name, nested=True)
    run_solver = problem_module.run_solver

    def run_solver_with_hook(state, step, options, **kwargs):
        def hooked_step(st):
            probe.on_iteration(st.iterations)
            return step(st)

        return run_solver(state, hooked_step, options, **kwargs)

    problem_module.run_solver = run_solver_with_hook

    if args.problem == "restoration":
        restoration(probe, device, args.N)
        return
    if args.problem == "cart_pole_batch":
        batched(probe, device, args.N, args.lanes)
        return
    problem, _X, _U = PROBLEMS[args.problem](N=args.N, total_time=5.0)
    t0 = time.perf_counter()
    status = problem.solve(device=args.device)
    probe.sync()
    wall = time.perf_counter() - t0
    stats = problem.last_solve_stats
    probe.finish(stats.iterations)
    restore_s = sum(s for s, _ in probe.restorations)
    restore_it = sum(i for _, i in probe.restorations)
    print(f"{args.problem} N={args.N} on {args.device}: {status}, {stats.iterations} iterations, "
          f"solve {wall:.3f} s ({wall * 1e3 / max(stats.iterations, 1):.1f} ms/iteration), "
          f"host syncs/iteration {stats.host_syncs_per_iteration:.2f}", flush=True)
    print(f"restoration: {len(probe.restorations)} entries, {restore_it} iterations, "
          f"{restore_s:.3f} s", flush=True)

    report_timed(probe, stats.iterations)
    report_profiled(probe)


if __name__ == "__main__":
    main()
