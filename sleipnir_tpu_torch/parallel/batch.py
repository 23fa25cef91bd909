"""Batched solves: many starting points of one problem as the lanes of one
interior-point solve on the device.

Port of `sleipnir_tpu/parallel/batch.py`. The reference's only
parallelism is one OS thread per multistart guess (reference
optimization/multistart.hpp:54-56); the JAX package vmaps its solver
state over the guesses. Here the state carries a lane axis and
`lanes.make_lane_interior_point` advances all lanes together: every
derivative evaluation, every K1 ladder and every K2 solve serves all
lanes at once.

Not carried over: the JAX package re-solves the multistart winner
because a vmapped TPU solve runs on the matrix unit's f64 emulation
(`sleipnir_tpu/parallel/batch.py:12-17,159-173`); on the card every lane
is native f64 and reaches the full tolerance.

Over several devices (`mesh=`, a `time_axis.Mesh` such as `default_mesh`
gives), the lanes split into contiguous equal groups, one per device, as
the JAX package's `NamedSharding(mesh, P(axis))` splits its lane axis.
Each group is a lane solve of its own, with its own bundle, lane step
and CUDA graphs on its device, and on the cards one host thread per
group drives it, so the devices overlap across the host reads each
iteration makes (the reference's multistart is likewise one thread per
guess); on the CPU the groups run one after another. The results come
back in lane order. A mesh may name one device more than once; its
groups then share that device.

The lane step is built once per prepared interior-point bundle (one per
lane group over a mesh) and kept beside it in the problem's solver cache,
so a later batched call on the same bundle replays the CUDA graphs the
first one captured; `SolveStats.lane_steps_built` counts the steps a call
built. Whatever the step reads that can change from call to call (the
guesses, their scaling, the parameters, the lane count) reaches it as
arguments. The lane count is not part of the key: a call with another
count reuses the step, whose graphs capture that count's shapes once
beside the others, so the graphs one bundle holds grow with the number of
distinct lane counts it has seen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Sequence

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.multistart import MultistartResult
from sleipnir_tpu_torch.optimization.problem import SolveStats
from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs
from sleipnir_tpu_torch.parallel.lanes import make_lane_interior_point
from sleipnir_tpu_torch.parallel.time_axis import Mesh
from sleipnir_tpu_torch.util.profiler import span


def default_mesh(num_devices: int | None = None, axis: str = "batch") -> Mesh:
    """A one-axis mesh over the first `num_devices` CUDA cards (all of
    them by default)."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("default_mesh needs CUDA cards; build a Mesh of CPU devices instead")
    n = count if num_devices is None else num_devices
    if not 1 <= n <= count:
        raise ValueError(f"num_devices = {n}, but {count} CUDA cards are visible")
    return Mesh.of([f"cuda:{i}" for i in range(n)], axis)


def _groups(lanes: int, mesh: Mesh) -> list:
    """The lane ranges of the mesh's devices: contiguous, equal."""
    n = mesh.size
    if lanes % n:
        raise ValueError(f"{lanes} lanes do not split evenly over the mesh's {n} devices")
    size = lanes // n
    return [range(i * size, (i + 1) * size) for i in range(n)]


def shard_batch(states, mesh: Mesh, axis: str = "batch"):
    """Split a lane-axis state (tensors or (named) tuples of them, lane
    axis first) into one contiguous group of lanes per device of the
    mesh, each on its device: a tuple with one state per device."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def part(tree, lanes, device):
        if isinstance(tree, torch.Tensor):
            return tree[lanes.start:lanes.stop].to(device)
        parts = [part(t, lanes, device) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)

    first = states
    while not isinstance(first, torch.Tensor):
        first = first[0]
    return tuple(part(states, g, d) for g, d in zip(_groups(first.shape[0], mesh), mesh.devices))


def make_batched_runner(step, mesh=None, axis: str = "batch", *,
                        syncs=None, timeout: float = math.inf):
    """A runner driving lane-axis solver states to completion.

    `step(states, run)` advances the lanes of the mask `run`. A lane
    leaves the batch once its status leaves RUNNING; the loop ends when
    no lane is RUNNING below the iteration cap (or at `timeout` seconds,
    which ends the running lanes as TIMEOUT). One host read per
    iteration decides it, through `syncs`.

    With `mesh=`, `step` and `syncs` are sequences, one per device of the
    mesh (each group's solver on its device), and the runner takes and
    returns a tuple of group states, one per device, as `shard_batch`
    splits them: each group runs in a thread of its own."""
    if mesh is not None:
        runners = [make_batched_runner(st, syncs=sy, timeout=timeout)
                   for st, sy in zip(step, syncs or [None] * mesh.size)]

        def run_groups(groups, cap):
            return tuple(_in_threads(mesh, [
                functools.partial(runner, g, cap) for runner, g in zip(runners, groups)
            ]))

        return run_groups
    syncs = HostSyncs() if syncs is None else syncs

    def run(states, cap):
        start = time.monotonic()
        while True:
            running = (states.status == status_codes.RUNNING) & (states.iterations < int(cap))
            if not syncs.read(running.any()):
                return states
            if time.monotonic() - start > timeout:
                timed_out = torch.where(running, int(ExitStatus.TIMEOUT), states.status)
                return states._replace(status=timed_out)
            with span("slp.iteration"):
                states = step(states, running)

    return run


def _in_threads(mesh: Mesh, jobs: list) -> list:
    """Run jobs[i]() on mesh.devices[i], one thread each, where every
    device is a card; their results in order. The first failure is raised
    once every thread has ended. Otherwise the jobs run one after another
    here: a CPU's work is the host's own, and torch's forward-mode AD
    (`torch.func.jvp`, under the derivative probes) keeps one set of
    levels per process, so two threads' eager evaluations would collide.
    On the cards those evaluations replay as CUDA graphs, and their
    captures run one at a time (`util/cuda_graph.py`)."""
    if any(d.type != "cuda" for d in mesh.devices):
        return [job() for job in jobs]
    results, errors = [None] * len(jobs), []

    def work(i):
        try:
            with torch.cuda.device(mesh.devices[i]):
                results[i] = jobs[i]()
        except BaseException as err:  # raised below, in the caller's thread
            errors.append(err)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _on(device: torch.device):
    """Make a card the thread's current device (its streams and graph
    pools are then that card's); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _lane_step(problem, bundle, options: Options, lane_group: int = 0):
    """The bundle's lane step, built on the first call that needs it and
    kept in the problem's solver cache beside the bundle, under the
    bundle's own key with "lanes" in place of "ipm": whatever drops or
    re-keys the bundle drops or re-keys its step too. Returns (init,
    step, steps built: 1 or 0)."""
    *_, funcs, _g_fn, backend = bundle
    key = ("lanes", *problem._cache_key("ipm", options, backend.device)[1:], lane_group)
    cached = problem._solver_cache.get(key)
    if cached is not None:
        return *cached[:2], 0
    init, step = make_lane_interior_point(funcs, options, backend=backend)
    problem._solver_cache[key] = (init, step, backend)
    return init, step, 1


def _start(problem, comp, bundle, initial_guesses, options, lane_group: int = 0):
    """The lane states of the guesses on the bundle's backend, and the
    lane step: (states, step, syncs, lane steps built)."""
    *_, backend = bundle
    params = comp["compiled"].gather_params()

    starts, scalings, rows0 = [], [], None
    with span("slp.lane_scaling"):
        for guess in initial_guesses:
            x0 = np.asarray(guess, dtype=np.float64).ravel()
            scaling, rows = problem.compute_ipm_scaling(comp, bundle, x0, params)
            if isinstance(rows, tuple):
                # The banded backend's per-row probes: one structure for all.
                if rows0 is None:
                    rows0 = rows
                elif rows[0].shape != rows0[0].shape or not np.array_equal(rows[1], rows0[1]):
                    raise ValueError("initial guesses give different inequality row structures")
            starts.append(x0)
            scalings.append(scaling)
    L = len(starts)
    init, step, built = _lane_step(problem, bundle, options, lane_group)
    sc = ScalingArrays(
        f=np.array([s.f for s in scalings]),
        c_e=np.stack([s.c_e for s in scalings]).reshape(L, comp["me"]),
        c_i=np.stack([s.c_i for s in scalings]).reshape(L, comp["mi"]),
    )
    states = init(
        np.stack(starts), np.ones((L, comp["mi"])), np.zeros((L, comp["me"])),
        np.ones((L, comp["mi"])), 0.1 * sc.f, params, sc,
    )
    return states, step, backend.syncs, built


def solve_ipm_batched(
    problem,
    initial_guesses: Sequence[np.ndarray],
    options: Options | None = None,
    mesh: Mesh | None = None,
    max_iterations: int | None = None,
):
    """Solve an inequality-constrained problem from many starting points
    in one batched solve on `options.device` (the card by default), or
    split over the devices of `mesh` (the module docstring).

    Returns (statuses, costs, xs, final): numpy arrays with a leading lane
    axis, and the final lane-axis `IPMState`; with a mesh, the tuple of
    the groups' final states, one per device. `problem.last_solve_stats`
    then holds the batched iterations (the most any lane took) and the
    host reads of every group, with the graph captures and the lane steps
    built."""
    if options is None:
        options = Options()
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a sleipnir_tpu_torch.parallel.Mesh, got {type(mesh)}")
    cap = max_iterations if max_iterations is not None else options.max_iterations
    with span("slp.solve"):
        if mesh is None:
            comp, bundle = problem.prepare_ipm(options)
            before = SolveStats.counters(bundle[-1].syncs)
            states, step, syncs, built = _start(problem, comp, bundle, initial_guesses, options)
            final = make_batched_runner(step, syncs=syncs, timeout=options.timeout)(states, cap)
            problem.last_solve_stats = SolveStats.since(
                int(final.iterations.max()), before, syncs, lane_steps_built=built)
            return (final.status.cpu().numpy(), final.f.cpu().numpy(), final.x.cpu().numpy(),
                    final)
        return _solve_on_mesh(problem, list(initial_guesses), options, mesh, cap)


def _solve_on_mesh(problem, guesses: list, options: Options, mesh: Mesh, cap: int):
    """`solve_ipm_batched` over the devices of a mesh."""
    lane_groups = _groups(len(guesses), mesh)
    comp = problem._compile()
    # Every group's solver and start are built (or fetched) here, one
    # after another, before the threads start: the problem compiles once,
    # and each group has its own backend, lane step and graphs, also where
    # two share a device.
    starts, reads = [], 0
    _, captures, capture_s = SolveStats.counters()
    for i, (lanes, device) in enumerate(zip(lane_groups, mesh.devices)):
        opts = dataclasses.replace(options, device=str(device))
        with _on(device):
            bundle = problem._prepare_ipm(comp, opts, device, lane_group=i)
            reads += bundle[-1].syncs.count
            starts.append(_start(problem, comp, bundle, [guesses[j] for j in lanes], opts, i))
    states, steps, syncs, built = zip(*starts)
    final = make_batched_runner(steps, mesh, syncs=syncs, timeout=options.timeout)(states, cap)
    problem.last_solve_stats = SolveStats.since(
        max(int(f.iterations.max()) for f in final), (reads, captures, capture_s), *syncs,
        lane_steps_built=sum(built))
    statuses, costs, xs = (
        np.concatenate([getattr(f, k).cpu().numpy() for f in final]) for k in ("status", "f", "x")
    )
    return statuses, costs, xs, final


def multistart_batched(
    problem,
    initial_guesses: Sequence[np.ndarray],
    options: Options | None = None,
    mesh: Mesh | None = None,
) -> MultistartResult:
    """Batched multistart: prefer SUCCESS, then lowest cost (reference
    optimization/multistart.hpp:66-74), over the lanes of one batched
    solve (split over the devices of `mesh`, if given)."""
    statuses, costs, xs, _ = solve_ipm_batched(problem, initial_guesses, options, mesh)
    order = sorted(
        range(len(initial_guesses)),
        key=lambda i: (int(statuses[i] != int(ExitStatus.SUCCESS)), costs[i]),
    )
    best = order[0]
    return MultistartResult(ExitStatus(int(statuses[best])), float(costs[best]), xs[best])
