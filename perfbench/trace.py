"""Spans around the program's calls, and the reduction of a profiled
stretch to device seconds per span.

The program has no named ranges of its own at its layer boundaries, so
`Spans` wraps its calls from here, for the profiled stretch only, each in
a `torch.profiler.record_function` range and with no added
synchronisation:

  pb.eval_derivs     the graphed problem evaluations that hold the
                     derivatives (`evaluate`, `refresh`, `kkt_fallback`,
                     the lanes' `lane_init`);
  pb.line_search     every other graphed evaluation (trial points, second-
                     order corrections, the values and stop checks);
  pb.factor          `BandedBackend.factor`, the lanes' `factor`: assembly,
                     equilibration, the regularization ladder, inertia;
  pb.solve_refined   `BandedBackend.solve_refined`, the lanes' one;
  pb.kkt_factor|...  `BandedBackend._chain_factor`, the call that factors B
                     staged systems in whatever form the backend selects,
                     its shape and dtype in the name;
  pb.kkt_solve|...   `BandedBackend.chain_solve`, the same for a solve.

`reduce_events` reads the profiler's raw events: each device operation is
charged to every span open on the host when it was launched (the CUDA
API call with its correlation id, or the operator it is linked to), and
the idle gaps between device operations to the innermost span open when
the gap began.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re

import torch

from perfbench import roofline

PREFIX = "pb."
STRETCH = "pb.stretch"
REQUEST = "pb.request"
OUTSIDE = "outside_the_spans"
DERIVATIVE_GRAPHS = frozenset({"evaluate", "refresh", "kkt_fallback", "lane_init"})
TOP = 10
#: CUDA runtime and driver API calls on the host (cudaLaunchKernel,
#: cudaGraphLaunch, cuLaunchKernel, cudaMemcpyAsync, ...).
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class Spans(contextlib.AbstractContextManager):
    """Wraps the program's layer calls in named ranges while open."""

    def __init__(self) -> None:
        self._undo: list = []

    def _patch(self, owner, attr: str, name_of) -> None:
        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name_of(*args)):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, inner))

    def __enter__(self) -> "Spans":
        from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend  # noqa: PLC0415
        from sleipnir_tpu_torch.optimization.solver.util.cuda_graph import Graphed  # noqa: PLC0415
        from sleipnir_tpu_torch.parallel.lanes import _BandedLanes  # noqa: PLC0415

        def graphed_name(graphed, *_args):
            kind = "eval_derivs" if graphed.name in DERIVATIVE_GRAPHS else "line_search"
            return PREFIX + kind

        def factor_name(_backend, Ds, _Es):
            B, K, w, _ = Ds.shape
            return f"{PREFIX}kkt_factor|{B}|{K}|{w}|{_dtype_name(Ds)}"

        def solve_name(_backend, _fac, b):
            B, K, w = b.shape[:3]
            r = b.shape[3] if b.dim() == 4 else 1
            return f"{PREFIX}kkt_solve|{B}|{K}|{w}|{r}|{_dtype_name(b)}"

        self._patch(Graphed, "__call__", graphed_name)
        for owner in (BandedBackend, _BandedLanes):
            self._patch(owner, "factor", lambda *_a: PREFIX + "factor")
            self._patch(owner, "solve_refined", lambda *_a: PREFIX + "solve_refined")
        self._patch(BandedBackend, "_chain_factor", factor_name)
        self._patch(BandedBackend, "chain_solve", solve_name)
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()


@dataclasses.dataclass
class Reduction:
    """What a profiled stretch showed."""

    #: Device seconds of the operations launched inside each span name
    #: (the shape suffix of pb.kkt_* dropped).
    span_s: dict
    #: (least seconds, device seconds) per pb.kkt_factor / pb.kkt_solve call.
    factor_calls: list
    solve_calls: list
    #: Device seconds with an operation running, and the stretch's length.
    busy_s: float
    window_s: float
    #: The operations that took most device time, and the idle seconds by
    #: the innermost span open when each gap began.
    device_ops: list
    idle_gaps: list
    #: Device operations seen, and those charged to a launch on the host.
    device_events: int
    attributed: int


def _least_seconds(name: str) -> float:
    kind, *dims, dtype = name.split("|")
    dims = [int(d) for d in dims]
    if kind == PREFIX + "kkt_factor":
        return roofline.least_seconds(*roofline.factor_work(*dims, dtype), dtype)
    return roofline.least_seconds(*roofline.solve_work(*dims, dtype), dtype)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _open_at(ranges, times):
    """For each of the ascending host times, the indices of the ranges
    (start, end, name), sorted by start, that are open at it."""
    ends = sorted((e, j) for j, (_s, e, _n) in enumerate(ranges))
    opened, out, ps, pe = set(), [], 0, 0
    for t in times:
        while ps < len(ranges) and ranges[ps][0] <= t:
            opened.add(ps)
            ps += 1
        while pe < len(ends) and ends[pe][0] < t:
            opened.discard(ends[pe][1])
            pe += 1
        out.append(tuple(opened))
    return out


def reduce_events(events) -> Reduction | None:
    """Reduce the profiler's raw events (`prof.profiler.kineto_results
    .events()`) of a stretch wrapped in a `STRETCH` range; None where the
    stretch or its device operations are missing."""
    from torch.autograd import DeviceType  # noqa: PLC0415

    launch_at = {}  # CUPTI correlation id of a CUDA API call -> its start (ns)
    op_at = {}  # correlation id of an operator on the host -> its start (ns)
    spans = []  # (start, end, name) of the pb.* ranges on the host
    device = []  # (start, end, name, correlation id, linked correlation id)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if RUNTIME_CALL.match(name):
                launch_at[e.correlation_id()] = e.start_ns()
            elif e.correlation_id():
                op_at[e.correlation_id()] = e.start_ns()
            if name.startswith(PREFIX):
                spans.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            # Ranges mirrored onto the device's timeline share the host
            # range's name; they are not operations.
            device.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                           e.linked_correlation_id()))
    stretch = [(s, e) for s, e, n in spans if n == STRETCH]
    if not stretch or not device:
        return None
    t0, t1 = stretch[0]
    inner = sorted((s, e, n) for s, e, n in spans if n not in (STRETCH, REQUEST))
    span_s = collections.Counter()
    per_call = collections.Counter()
    op_s = collections.Counter()
    launched = []
    for s, e, name, corr, linked in device:
        op_s[name] += (e - s) * 1e-9
        # The CUDA API call that launched it (a kernel of a graph replay or
        # of a library bound by ctypes has no operator around it), else the
        # operator that it is linked to.
        t = launch_at.get(corr, op_at.get(linked) if linked else None)
        if t is not None:
            launched.append((t, (e - s) * 1e-9))
    launched.sort()
    for (_t, dur), opened in zip(launched, _open_at(inner, [t for t, _d in launched])):
        for j in opened:
            per_call[j] += dur
        for name in {inner[j][2].split("|")[0] for j in opened}:
            span_s[name] += dur
    factor_calls, solve_calls = [], []
    for j, (_s, _e, name) in enumerate(inner):
        if name.startswith(PREFIX + "kkt_"):
            calls = factor_calls if name.startswith(PREFIX + "kkt_factor") else solve_calls
            calls.append((_least_seconds(name), per_call[j]))

    busy = _merge((max(s, t0), min(e, t1)) for s, e, *_ in device if e > t0 and s < t1)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gap_list = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    gaps = collections.Counter()
    for (g0, g1), opened in zip(gap_list, _open_at(inner, [g0 for g0, _g1 in gap_list])):
        name = inner[max(opened, key=lambda j: inner[j][0])][2].split("|")[0] if opened else OUTSIDE
        gaps[name] += (g1 - g0) * 1e-9
    return Reduction(
        span_s={k.removeprefix(PREFIX): v for k, v in span_s.items()},
        factor_calls=factor_calls, solve_calls=solve_calls,
        busy_s=busy_s, window_s=(t1 - t0) * 1e-9,
        device_ops=[[n[:64], s] for n, s in op_s.most_common(TOP)],
        idle_gaps=[[n.removeprefix(PREFIX), s] for n, s in gaps.most_common(TOP)],
        device_events=len(device),
        attributed=len(launched),
    )
