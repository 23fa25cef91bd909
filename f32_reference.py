"""The float32 solve's reference record: statuses and iterations of the
JAX package (or of the port, on the CPU) in float32 and float64.

Runs on the CPU, one case per call, and prints one JSON line per solve:

    python3 f32_reference.py scalars                   # the three problems of
                                                       # tests/optimization/test_dtype_axis.py
    python3 f32_reference.py flywheel --N 60 --dtype float32 --tol 1e-2
    python3 f32_reference.py lanes --N 60 --lanes 4    # solve_ipm_batched, float32
    python3 f32_reference.py flywheel --N 60 --package port
    python3 f32_reference.py flywheel --N 60 --package port --diagnostics
    python3 f32_reference.py part --N 60               # where the two packages part

`part` solves the flywheel in both packages in one process and prints
the relative difference of their iterates every 50 iterations and the
first iteration where it passes 1e-3. A flywheel solve also lists each
feasibility restoration entry: its outcome and the solver state's
iteration count when it returned (restoration's own iterations count
from the parent's).

`iterations` is the solver state's count (restoration's iterations
included), `callbacks` the iterations the user callback saw. The JAX
package's float32 flywheel takes minutes at N=1000 and about 20 at
N=5000 on one core.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _packages(name: str):
    if name == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import sleipnir_tpu as slp
        from sleipnir_tpu.models.flywheel import flywheel_problem
        from sleipnir_tpu.parallel.batch import solve_ipm_batched

        return slp, flywheel_problem, solve_ipm_batched, {}
    import sleipnir_tpu_torch as slp
    from sleipnir_tpu_torch.models.flywheel import flywheel_problem
    from sleipnir_tpu_torch.parallel import solve_ipm_batched

    return slp, flywheel_problem, solve_ipm_batched, {"device": "cpu"}


def _solve(name, problem, options, read) -> None:
    seen = [0]
    entries = []

    def count(_info):
        seen[0] += 1
        return False

    # Each restoration entry through the solving package's own `restore`.
    module = sys.modules[type(problem).__mro__[-2].__module__]
    restore = module.restore

    def traced(*args, **kwargs):
        out = restore(*args, **kwargs)
        entries.append([str(getattr(out[0], "name", out[0])), int(out[-1])])
        return out

    problem.add_callback(count)
    module.restore = traced
    t0 = time.monotonic()
    try:
        status = problem.solve(options)
    finally:
        module.restore = restore
    print(json.dumps({
        "case": name, "dtype": options.dtype, "tolerance": options.tolerance,
        "status": status.name, "iterations": int(problem._last_state.iterations),
        "callbacks": seen[0], "restorations": entries, "value": read(),
        "seconds": time.monotonic() - t0,
    }), flush=True)


def _part(args) -> None:
    """The flywheel's iterates in both packages, iteration by iteration."""
    traces = []
    for package in ("jax", "port"):
        slp, flywheel_problem, _batch, extra = _packages(package)
        problem, _X, _U = flywheel_problem(N=args.N, total_time=5.0)
        xs = []
        problem.add_callback(lambda info, xs=xs: xs.append(np.array(info.x, np.float64)) and False)
        problem.solve(slp.Options(dtype=args.dtype, tolerance=args.tol, **extra))
        traces.append(xs)
    first = None
    for k, (a, b) in enumerate(zip(*traces)):
        rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))
        if k % 50 == 0:
            print(json.dumps({"iteration": k, "rel": rel}), flush=True)
        if first is None and rel > 1e-3:
            first = k
    print(json.dumps({"case": f"part flywheel N={args.N}", "dtype": args.dtype,
                      "iterations": [len(t) for t in traces], "first_over_1e-3": first}),
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("case", choices=["scalars", "flywheel", "lanes", "part"])
    parser.add_argument("--package", choices=["jax", "port"], default="jax")
    parser.add_argument("--N", type=int, default=60)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--tol", type=float, default=1e-2)
    parser.add_argument("--lanes", type=int, default=4)
    parser.add_argument("--diagnostics", action="store_true",
                        help="print the solver's iteration table (μ, δ, step sizes)")
    args = parser.parse_args()
    if args.case == "part":
        _part(args)
        return
    slp, flywheel_problem, solve_ipm_batched, extra = _packages(args.package)

    if args.case == "scalars":
        for dtype, tol in (("float64", 1e-8), ("float32", 1e-4)):
            options = slp.Options(dtype=dtype, tolerance=tol, **extra)
            p = slp.Problem()
            x = p.decision_variable()
            x.set_value(20.0)
            p.minimize(x * x - 6.0 * x)
            _solve("Newton", p, options, lambda: [float(x.value())])
            p = slp.Problem()
            x, y = p.decision_variable(), p.decision_variable()
            x.set_value(1.0)
            y.set_value(1.0)
            p.minimize(x * x + 2.0 * y * y)
            p.subject_to(x + y == 3.0)
            _solve("SQP", p, options, lambda: [float(x.value()), float(y.value())])
            p = slp.Problem()
            x, y = p.decision_variable(), p.decision_variable()
            x.set_value(3.0)
            y.set_value(2.0)
            p.minimize(x * x + y * y)
            p.subject_to(x + y >= 2.0)
            _solve("IPM", p, options, lambda: [float(x.value()), float(y.value())])
        return

    options = slp.Options(dtype=args.dtype, tolerance=args.tol, diagnostics=args.diagnostics,
                          **extra)
    problem, X, _U = flywheel_problem(N=args.N, total_time=5.0)
    if args.case == "flywheel":
        _solve(f"flywheel N={args.N}", problem, options,
               lambda: [float(X.value()[0, args.N])])
        return
    # The lanes start from 0.01·k·randn(n), k = 0..L-1 (seed 0), as the
    # batched cart-pole of chip_smoke.py phase 12.
    n = problem._compile()["n"]
    rng = np.random.default_rng(0)
    guesses = [0.01 * k * rng.standard_normal(n) for k in range(args.lanes)]
    t0 = time.monotonic()
    statuses, costs, _xs, final = solve_ipm_batched(problem, guesses, options)
    print(json.dumps({
        "case": f"lanes flywheel N={args.N}, L={args.lanes}", "dtype": args.dtype,
        "tolerance": args.tol, "statuses": np.asarray(statuses).tolist(),
        "iterations": np.asarray(final.iterations).tolist(),
        "costs": np.asarray(costs, dtype=np.float64).tolist(),
        "seconds": time.monotonic() - t0,
    }), flush=True)


if __name__ == "__main__":
    main()
