"""One run of one cell: set-up, the measured window (whose end a traced
run profiles), and the judgement of every answer against the plain
reference.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: `configs/<config>.json` (the configuration as run) and
`configs/<config>.py` (its `build(cfg)` through the port's public API),
`reference/<config>.py` (its plain reference: `judge` and `LIMITS`),
`traffic/<mix>.json` (read by `generator.py`), and `metrics/<metric>.py`
(a `read(run)` that returns the metric or None), looked up under the
metric's whole name first and then under the part before its first dot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import generator, trace

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent
#: A traced run profiles the requests that start in its window's last
#: STRETCH_SECONDS, at least one.
STRETCH_SECONDS = 2.0
#: Top-level module names that may not be loaded when the window closes.
BANNED_MODULES = frozenset({"jax", "jaxlib", "flax", "sleipnir_tpu"})


def load_module(path: Path):
    name = "perfbench._by_name." + "_".join(path.relative_to(PERFBENCH).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace("-", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_files(config: str) -> tuple[Path, Path, Path]:
    """The configuration's sizes, the module that builds it, and its plain reference."""
    return (PERFBENCH / "configs" / f"{config}.json", PERFBENCH / "configs" / f"{config}.py",
            PERFBENCH / "reference" / f"{config}.py")


def traffic_file(mix: str) -> Path:
    return PERFBENCH / "traffic" / f"{mix}.json"


def metric_file(metric: str) -> Path:
    for stem in (metric, metric.split(".")[0]):
        path = PERFBENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {metric!r} under {PERFBENCH / 'metrics'}")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    a trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Served:
    """What one request returned: per solve (lane), whether it ended
    SUCCESS and its decision vector; the solver steps it took (batched
    iterations for a multistart call) and its host reads."""

    ok: list
    xs: list
    steps: int
    syncs: int


class Program:
    """sleipnir_tpu_torch under one configuration, driven through the
    cell's entry: `Problem.solve`, or the lane solve of a multistart."""

    def __init__(self, build_module, cfg: dict, entry: str, device: str, dtype: str | None = None,
                 tolerance: float | None = None, max_iterations: int | None = None) -> None:
        from sleipnir_tpu_torch import Options  # noqa: PLC0415

        built = build_module.build(cfg)
        self.problem = built["problem"]
        self.outputs = built["outputs"]
        self.entry = entry
        self.ids = self.problem._compile()["all_ids"]
        #: The decision vector as the build left it: the configuration's own guess.
        self.start = self._registry().get(self.ids).copy()
        self.options = Options(
            device=device, dtype=dtype or cfg["dtype"],
            tolerance=cfg["tolerance"] if tolerance is None else tolerance,
            **({} if max_iterations is None else {"max_iterations": max_iterations}),
        )
        self._syncs = None

    def _registry(self):
        from sleipnir_tpu_torch.autodiff import expression  # noqa: PLC0415

        return expression._registry

    def serve(self, req: generator.Request) -> Served:
        from sleipnir_tpu_torch import ExitStatus  # noqa: PLC0415
        from sleipnir_tpu_torch.parallel import solve_ipm_batched  # noqa: PLC0415

        if self.entry == "solve":
            self._registry().set(self.ids, req.guesses[0])
            status = self.problem.solve(self.options)
            stats = self.problem.last_solve_stats
            return Served([status == ExitStatus.SUCCESS], [self._registry().get(self.ids).copy()],
                          stats.iterations, stats.host_syncs)
        if self._syncs is None:
            self._syncs = self.problem.prepare_ipm(self.options)[1][-1].syncs
        before = self._syncs.count
        statuses, _costs, xs, final = solve_ipm_batched(self.problem, req.guesses, self.options)
        return Served(list(statuses == int(ExitStatus.SUCCESS)), list(xs),
                      int(final.iterations.max()), self._syncs.count - before)

    def outputs_of(self, x: np.ndarray) -> dict:
        """The named outputs (X, U) of a decision vector, as the public API
        reads them; it leaves the variables at x."""
        self._registry().set(self.ids, x)
        return {name: np.array(var.value(), dtype=np.float64) for name, var in self.outputs.items()}


@dataclasses.dataclass
class Run:
    """What the metric readers read. Requests are solves or multistart
    calls; solves count each lane; steps are solver iterations (batched
    iterations for the lanes)."""

    requests: int
    solves: int
    steps: int
    syncs: int
    elapsed_s: float
    setup_s: float
    trace: trace.Reduction | None = None
    stretch_steps: int = 0


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Stretch:
    """The profiled end of a traced run's window: the program's calls
    wrapped in spans (`trace.Spans`) under `torch.profiler`."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.first = None  # index of the first profiled record
        self._stack = contextlib.ExitStack()
        self._prof = None

    def start(self, first: int) -> None:
        self.first = first
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._stack.enter_context(trace.Spans())
        self._prof = self._stack.enter_context(torch.profiler.profile(activities=activities))
        self._stack.enter_context(torch.profiler.record_function(trace.STRETCH))

    def stop(self) -> trace.Reduction | None:
        _sync(self.device)
        self._stack.close()
        return trace.reduce_events(self._prof.profiler.kineto_results.events())


def drive(program: Program, traffic: generator.Traffic, seconds: float, device: str,
          records: list, stretch: Stretch | None = None) -> float:
    """Serve requests back to back until `seconds` have passed, ending on a
    request's boundary; append (request, served, seconds) to `records`
    and return the window's length. With a `stretch`, the requests that
    start in the window's last STRETCH_SECONDS (at least one) are
    profiled."""
    _sync(device)
    t0 = time.perf_counter()
    while True:
        if stretch is not None and stretch.first is None and (
                time.perf_counter() - t0 >= seconds - STRETCH_SECONDS):
            stretch.start(len(records))
        req = traffic.next()
        with torch.profiler.record_function(trace.REQUEST) if stretch else contextlib.nullcontext():
            ts = time.perf_counter()
            served = program.serve(req)
            te = time.perf_counter()
        records.append((req, served, te - ts))
        if te - t0 >= seconds and (stretch is None or stretch.first is not None):
            break
    _sync(device)
    return time.perf_counter() - t0


def judge(reference, cfg: dict, program: Program, records: list) -> tuple[int, int, dict]:
    """(attempted, failed, checks): every solve of every request held to
    the reference; `checks` gives each number compared, the worst over
    all solves, beside its limit."""
    worst = {name: 0.0 for name in reference.LIMITS}
    attempted = failed = unsuccessful = 0
    for _req, served, _s in records:
        for ok, x in zip(served.ok, served.xs):
            attempted += 1
            numbers = reference.judge(cfg, program.outputs_of(x))
            bad = not ok
            unsuccessful += bad
            for name, limit in reference.LIMITS.items():
                value = numbers[name]
                worst[name] = max(worst[name], value) if np.isfinite(value) else float("inf")
                bad = bad or not value <= limit
            failed += bad
    checks = {name: {"value": worst[name], "limit": limit}
              for name, limit in reference.LIMITS.items()}
    checks["not_success"] = {"value": unsuccessful, "limit": 0}
    return attempted, failed, checks


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & BANNED_MODULES)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, cfg_override: dict | None = None) -> tuple[int, dict | None]:
    """One run of `cell` (an entry of BENCHMARK.json's workloads): exit
    code and the result line's object (None where there is none)."""
    sizes, build_path, reference_path = config_files(cell["config"])
    cfg = {**json.loads(sizes.read_text()), **(cfg_override or {})}
    mix = json.loads(traffic_file(cell["traffic"]).read_text())
    metrics = cell_metrics(bench, cell["name"], traced)
    readers = {m["name"]: load_module(metric_file(m["name"])) for m in metrics}
    reference = load_module(reference_path)
    setup = {}

    t = time.perf_counter()
    if device.startswith("cuda"):
        from sleipnir_tpu_torch.ops import cuda_banded, cuda_build  # noqa: PLC0415

        cuda_build.build([cuda_banded.SOURCE])
    setup["build"] = time.perf_counter() - t

    t = time.perf_counter()
    program = Program(load_module(build_path), cfg, mix["entry"], device)
    setup["problem"] = time.perf_counter() - t

    from sleipnir_tpu_torch.optimization.solver.util import cuda_graph  # noqa: PLC0415

    t = time.perf_counter()
    warm = generator.Traffic(mix, program.start, seed, generator.WARM_UP)
    program.serve(warm.next())
    _sync(device)
    setup["warm_up"] = time.perf_counter() - t
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    captures = cuda_graph.CAPTURES

    traffic = generator.Traffic(mix, program.start, seed)
    setup_s = time.perf_counter() - t_start
    log("setup_s by phase: " + ", ".join(f"{k} {v:.3f} s" for k, v in setup.items())
        + f", the rest (imports, start) {setup_s - sum(setup.values()):.3f} s; total {setup_s:.3f} s")
    records: list = []
    stretch = Stretch(device) if traced else None
    elapsed = drive(program, traffic, seconds, device, records, stretch)
    window = list(records)
    log(f"window: {len(window)} requests in {elapsed:.3f} s, "
        f"{', '.join(f'{t:.3f}' for _r, _s, t in window)} s each; steps "
        f"{[s.steps for _r, s, _t in window]}; graph captures in the window "
        f"{cuda_graph.CAPTURES - captures}")
    banned = banned_modules()
    if banned:
        log(f"modules that the run may not load are loaded: {', '.join(banned)}")
        return 3, None

    run = Run(
        requests=len(window), solves=sum(len(s.ok) for _r, s, _t in window),
        steps=sum(s.steps for _r, s, _t in window), syncs=sum(s.syncs for _r, s, _t in window),
        elapsed_s=elapsed, setup_s=setup_s,
    )
    if traced:
        t = time.perf_counter()
        run.trace = stretch.stop()
        run.stretch_steps = sum(s.steps for _r, s, _t in records[stretch.first:])
        log(f"profiled stretch: the last {len(records) - stretch.first} requests, "
            f"{run.stretch_steps} steps, {run.trace.device_events if run.trace else 0} device "
            f"operations, {run.trace.attributed if run.trace else 0} of them charged to a launch; "
            f"stopped and reduced in {time.perf_counter() - t:.1f} s")
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0

    t = time.perf_counter()
    attempted, failed, checks = judge(reference, cfg, program, records)
    log(f"judged {attempted} solves against the reference in {time.perf_counter() - t:.1f} s, "
        f"{failed} failed")

    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and attempted > 0, "attempted": attempted,
              "failed": failed, "metrics": values, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} against the limit {c['limit']!r}")
    return 0, result

