"""The program's own ranges read against the card's trace, on the
profiler's one clock.

sleipnir_tpu_torch marks its host work with `slp.*` ranges while a
profiler collects (`sleipnir_tpu_torch/util/profiler.py` names them), and
counts each request's graph captures in `SolveStats`. `reduce` reads a
profiled stretch's raw events (`prof.profiler.kineto_results.events()`,
the stretch wrapped in `trace.STRETCH`), and `readings` turns that and the
requests' `SolveStats` into per-iteration and per-call figures:

  control_idle_ms       idle ms of the card per slp.iteration, charged to
                        the self time of slp.iteration or slp.solve: the
                        step's and the request's own host control;
  eager_ops_per_iter    device operations launched inside an
                        slp.iteration, inside no slp.graph_capture, by a
                        CUDA call other than a graph launch, per
                        slp.iteration;
  graph_captures_per_call, capture_ms_per_call
                        `SolveStats.graph_captures` and `.capture_s` over
                        the window's requests;
  lane_scaling_ms       host ms inside slp.lane_scaling per slp.solve;
  setup_capture_s       the warm-up request's `SolveStats.capture_s`.

Each idle gap of the card is charged over its whole length: every part of
it goes to the innermost slp.* range open on the host over that part, and
time inside no slp.* range to OUTSIDE. Every figure is None where the
events hold no slp.* range (a program without them) or the stats lack the
counter, not 0.

Until `harness.py` keeps the stretch's events and the requests' stats (a
change to the benchmark's own files), the command below makes one traced
run of a cell exactly as `run.py --trace 1` does, keeping both, and prints
after the harness's result line the idle table by range to standard error
and one JSON line of the readings and their cross-checks:

    python3 perfbench/program_trace.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

PREFIX = "slp."
OUTSIDE = "outside_the_program"
#: The runtime calls that launch a captured graph.
GRAPH_LAUNCHES = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})
#: Device-side mirrors of host ranges carry the range's name; they are not
#: operations.
MIRRORED = ("pb.", PREFIX)


@dataclasses.dataclass
class ProgramTrace:
    """What the slp.* ranges of a profiled stretch showed."""

    #: slp.iteration, slp.solve and slp.lane_scaling ranges in the stretch.
    iterations: int
    solves: int
    lane_scalings: int
    #: Idle seconds of the card by the innermost slp.* range open (its
    #: whole name), OUTSIDE for none; they sum to the stretch's idle time.
    idle_s: dict
    busy_s: float
    window_s: float
    #: Device operations launched eagerly inside an slp.iteration.
    eager_ops: int
    #: Host seconds inside slp.lane_scaling.
    lane_scaling_s: float
    #: Device seconds of the stretch's operations, and of those launched
    #: outside every slp.solve (or whose launch is unknown).
    device_s: float
    outside_solve_device_s: float

    @property
    def idle_total_s(self) -> float:
        return sum(self.idle_s.values())


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged: list, t: float) -> bool:
    """Whether t lies in the union of merged, sorted intervals."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _innermost(ranges, t0: float, t1: float) -> list:
    """[start, end, name] pieces covering [t0, t1], each with the innermost
    range (the latest begun of those open) over it, None where none is."""
    marks = sorted([(s, 1, j) for j, (s, _e, _n) in enumerate(ranges)]
                   + [(e, 0, j) for j, (_s, e, _n) in enumerate(ranges)])
    pieces, stack, at = [], [], t0
    for t, opens, j in marks:
        t = min(max(t, t0), t1)
        if t > at:
            pieces.append([at, t, ranges[stack[-1]][2] if stack else None])
            at = t
        if opens:
            stack.append(j)
        else:
            stack.remove(j)
    if t1 > at:
        pieces.append([at, t1, ranges[stack[-1]][2] if stack else None])
    return pieces


def reduce(events) -> ProgramTrace | None:
    """Reduce the raw events of a stretch wrapped in a `trace.STRETCH`
    range; None where the stretch, its device operations or the slp.*
    ranges are missing."""
    from torch.autograd import DeviceType  # noqa: PLC0415

    from perfbench import trace  # noqa: PLC0415

    runtime = {}  # correlation id of a CUDA API call -> (start, name)
    op_at = {}  # correlation id of an operator on the host -> its start
    ranges, stretch, device = [], None, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if trace.RUNTIME_CALL.match(name):
                runtime[e.correlation_id()] = (e.start_ns(), name)
            elif e.correlation_id():
                op_at[e.correlation_id()] = e.start_ns()
            if name.startswith(PREFIX):
                ranges.append((e.start_ns(), e.end_ns(), name))
            elif name == trace.STRETCH and stretch is None:
                stretch = (e.start_ns(), e.end_ns())
        elif e.device_type() == DeviceType.CUDA and not name.startswith(MIRRORED):
            device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                           e.linked_correlation_id()))
    if stretch is None or not device:
        return None
    t0, t1 = stretch
    ranges = sorted(r for r in ranges if r[0] < t1 and r[1] > t0)
    if not ranges:
        return None

    def union(name):
        return _merge([s, e] for s, e, n in ranges if n == name)

    def starts(name):
        return sum(n == name for _s, _e, n in ranges)

    iterations, captures = union(PREFIX + "iteration"), _merge(
        [s, e] for s, e, n in ranges if n.startswith(PREFIX + "graph_capture|"))
    solves = union(PREFIX + "solve")
    eager, device_s, outside = 0, 0.0, 0.0
    busy = []
    for s, e, corr, linked in device:
        if e <= t0 or s >= t1:
            continue
        busy.append((max(s, t0), min(e, t1)))
        dur = (min(e, t1) - max(s, t0)) * 1e-9
        device_s += dur
        launch = runtime.get(corr)
        at = launch[0] if launch else op_at.get(linked) if linked else None
        if at is None or not _inside(solves, at):
            outside += dur
        if (at is not None and (launch is None or launch[1] not in GRAPH_LAUNCHES)
                and _inside(iterations, at) and not _inside(captures, at)):
            eager += 1
    busy = _merge(busy)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    idle = collections.Counter()
    pieces = _innermost(ranges, t0, t1)
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            idle[name or OUTSIDE] += (min(e, g1) - max(s, g0)) * 1e-9
            k += 1
    lane = [(s, e) for s, e, n in ranges if n == PREFIX + "lane_scaling"]
    return ProgramTrace(
        iterations=starts(PREFIX + "iteration"), solves=starts(PREFIX + "solve"),
        lane_scalings=len(lane), idle_s=dict(idle.most_common()),
        busy_s=sum(e - s for s, e in busy) * 1e-9, window_s=(t1 - t0) * 1e-9,
        eager_ops=eager, lane_scaling_s=sum(e - s for s, e in lane) * 1e-9,
        device_s=device_s, outside_solve_device_s=outside,
    )


def _stat(stats, field: str) -> list | None:
    values = [getattr(s, field, None) for s in stats]
    return None if not values or None in values else values


def readings(pt: ProgramTrace | None, window_stats: list, warm_stats) -> dict:
    """The figures of the module docstring, each None where what it reads
    is missing."""
    out = dict.fromkeys(("control_idle_ms", "eager_ops_per_iter", "lane_scaling_ms",
                         "graph_captures_per_call", "capture_ms_per_call", "setup_capture_s"))
    if pt is not None and pt.iterations:
        control = pt.idle_s.get(PREFIX + "iteration", 0.0) + pt.idle_s.get(PREFIX + "solve", 0.0)
        out["control_idle_ms"] = 1e3 * control / pt.iterations
        out["eager_ops_per_iter"] = pt.eager_ops / pt.iterations
    if pt is not None and pt.lane_scalings and pt.solves:
        out["lane_scaling_ms"] = 1e3 * pt.lane_scaling_s / pt.solves
    captures, capture_s = _stat(window_stats, "graph_captures"), _stat(window_stats, "capture_s")
    if captures is not None:
        out["graph_captures_per_call"] = sum(captures) / len(captures)
        out["capture_ms_per_call"] = 1e3 * sum(capture_s) / len(capture_s)
    out["setup_capture_s"] = getattr(warm_stats, "capture_s", None)
    return out


def keep(harness) -> dict:
    """Make the harness's traced runs in this process keep the stretch's
    events and every request's `SolveStats` (the warm-up's first) and
    seconds, in the dict returned."""
    kept = {"stats": [], "seconds": []}

    class KeepingStretch(harness.Stretch):
        def stop(self):
            reduction = super().stop()
            kept.update(events=self._prof.profiler.kineto_results.events(), first=self.first,
                        reduction=reduction)
            return reduction

    class CountingProgram(harness.Program):
        def serve(self, req):
            t = time.perf_counter()
            served = super().serve(req)
            kept["seconds"].append(time.perf_counter() - t)
            kept["stats"].append(getattr(self.problem, "last_solve_stats", None))
            return served

    harness.Stretch, harness.Program = KeepingStretch, CountingProgram
    return kept


def report(kept: dict, log) -> dict:
    """The readings of a kept traced run, with their cross-checks; the idle
    table by range goes to `log`."""
    t = time.perf_counter()
    pt = reduce(kept["events"])
    warm, window = kept["stats"][0], kept["stats"][1:]
    stretch = window[kept["first"]:]
    red = kept["reduction"]
    checks = {
        "window_requests": len(window),
        "captures_in_window": sum(getattr(s, "graph_captures", 0) for s in window),
        "stretch_request_s": kept["seconds"][1 + kept["first"]:],
        "stretch_steps": sum(s.iterations for s in stretch),
    }
    if pt is not None:
        checks.update({
            "slp_iterations": pt.iterations, "slp_solves": pt.solves,
            "idle_charged_s": pt.idle_total_s,
            "idle_of_the_harness_s": red.window_s - red.busy_s if red else None,
            "outside_solve_device_pct": 100.0 * pt.outside_solve_device_s / pt.device_s,
        })
        log("idle seconds of the stretch by the innermost slp.* range open:")
        for name, s in pt.idle_s.items():
            log(f"  {name:60s} {s:10.6f}")
    log(f"program trace reduced in {time.perf_counter() - t:.1f} s")
    return {"program": readings(pt, window, warm), "idle_s": pt.idle_s if pt else None,
            "checks": checks}


def main(argv: list[str] | None = None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    # run.py's clock starts when it is imported, before torch and NumPy
    # load; the harness loads them with run.py's host threads.
    from perfbench import run  # noqa: PLC0415

    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    from perfbench import harness  # noqa: PLC0415

    kept = keep(harness)
    code = run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    if code != 0 or "events" not in kept:
        return code
    print(json.dumps(report(kept, harness.log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
