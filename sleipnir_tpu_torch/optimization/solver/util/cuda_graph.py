"""CUDA graphs of the solvers' problem evaluations.

The counterpart of the JAX package's `jit` of its step: a problem
evaluation (derivative probes under `torch.func` transforms, trial
points of the line search) is thousands of small device operations, and
dispatching them one by one from Python leaves the card idle. On the
card, `Graphs.wrap(fn)` records such a function once as a CUDA graph and
replays it on every later call.

A wrapped function is a pure function of tensors: its arguments are
tensors, (named) tuples of them, or hashable host constants, and what it
returns is built from its arguments and from tensors that stay fixed for
the solver's lifetime (probe matrices, index vectors). On CUDA tensors:

  - the first call for an input signature (the tree structure, each
    tensor's shape, dtype and device, each host constant's value) runs
    the function eagerly on the solver's side stream and returns that
    result, then captures the function into a CUDA graph in the
    solver's memory pool;
  - every later call copies the arguments into the graph's static input
    buffers, replays the graph and returns clones of its static outputs,
    so no result is overwritten by the next replay.

A capture that fails raises, naming the function; nothing falls back to
eager execution on the card. On CPU tensors the function runs eagerly:
that is how the CPU runs the solvers, not a fallback. The undecorated
function stays reachable as `.eager`, so a run can hold graphed results
against eager ones. `CAPTURES`, `REPLAYS` and `CAPTURE_SECONDS` count
what every graph did since `reset_counters()`.

Captures run in CUDA's thread-local capture mode, one at a time: the
batched solve over a mesh drives each device's lanes from a thread of its
own, and in the default (global) mode any thread's unsafe CUDA call would
end another thread's capture.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from sleipnir_tpu_torch.util.profiler import span

#: Graph captures and replays, and the seconds captures took (the eager
#: warm-up included), since the counters were last reset.
CAPTURES = 0
REPLAYS = 0
CAPTURE_SECONDS = 0.0


#: Held for a whole capture, its eager warm-up included: one capture at a
#: time, so no thread turns the collector back on during another's.
_CAPTURING = threading.Lock()


def reset_counters() -> None:
    global CAPTURES, REPLAYS, CAPTURE_SECONDS
    CAPTURES = 0
    REPLAYS = 0
    CAPTURE_SECONDS = 0.0


def at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[i] for a 0-d index tensor i. Indexing with a 0-d tensor reads it
    to the host as an integer; this gathers on the device instead, so
    that a graph can hold it."""
    return v[i.reshape(1)].reshape(())


class Graphs:
    """The CUDA graphs of one solver bundle: one memory pool and one side
    stream, made at the first capture."""

    def __init__(self) -> None:
        self._pool = None
        self._stream = None

    def wrap(self, fn: Callable, name: str | None = None) -> "Graphed":
        return Graphed(fn, self, name or fn.__name__)

    def _cuda(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        return self._pool, self._stream


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "out_spec")

    def __init__(self, graph, inputs, outputs, out_spec) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec


def _signature(leaves, spec):
    return (spec, tuple(
        (leaf.shape, leaf.dtype, leaf.device) if isinstance(leaf, torch.Tensor) else ("host", leaf)
        for leaf in leaves
    ))


class Graphed:
    """A function that replays as a CUDA graph on the card (see the module
    docstring); `eager` is the function itself."""

    def __init__(self, fn: Callable, graphs: Graphs, name: str) -> None:
        self.eager = fn
        self.graphs = graphs
        self.name = name
        self._entries: dict = {}
        self._replay_span = "slp.graph_replay|" + name
        self._capture_span = "slp.graph_capture|" + name

    def __call__(self, *args):
        global REPLAYS
        leaves, spec = pytree.tree_flatten(args)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        if not any(t.is_cuda for t in tensors):
            return self.eager(*args)
        if not all(t.is_cuda for t in tensors):
            # A replay would read a host tensor's value from the capture.
            raise ValueError(f"{self.name}: CPU and CUDA tensors in one graphed call")
        key = _signature(leaves, spec)
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, leaves, spec)
        with span(self._replay_span):
            for dst, src in zip(entry.inputs, leaves):
                if isinstance(src, torch.Tensor):
                    dst.copy_(src)
            entry.graph.replay()
            REPLAYS += 1
            return pytree.tree_unflatten(
                [t.clone() if isinstance(t, torch.Tensor) else t for t in entry.outputs],
                entry.out_spec,
            )

    def _capture(self, key, leaves, spec):
        with span(self._capture_span), _CAPTURING:
            return self._capture_locked(key, leaves, spec)

    def _capture_locked(self, key, leaves, spec):
        global CAPTURES, CAPTURE_SECONDS
        pool, stream = self.graphs._cuda()
        t0 = time.perf_counter()
        current = torch.cuda.current_stream()
        inputs = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves]
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # The warm-up is the eager run whose result this call returns.
            result = self.eager(*pytree.tree_unflatten(leaves, spec))
        current.wait_stream(stream)
        for t in pytree.tree_leaves(result):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        # The collector could free another solver's graph mid-capture (a
        # finished restoration's, say), and destroying a graph while a
        # stream captures invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self.eager(*pytree.tree_unflatten(inputs, spec))
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        outputs, out_spec = pytree.tree_flatten(out)
        self._entries[key] = _Entry(graph, inputs, outputs, out_spec)
        CAPTURES += 1
        CAPTURE_SECONDS += time.perf_counter() - t0
        return result
