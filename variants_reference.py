"""The JAX package and the port under the banded backend's opt-in factor
forms on the CPU: exit status, iterations, seconds (model building and
compilation included) and what the model's oracle says of the solution.

    JAX_PLATFORMS=cpu python variants_reference.py --problem cart_pole --N 20 \\
        --variable SLEIPNIR_TPU_INV
    JAX_PLATFORMS=cpu python variants_reference.py --problem flywheel --N 5000 \\
        --variable SLEIPNIR_TPU_BCR --package port

`--variable none` solves with neither variable set. The flywheel's oracle
is `models/flywheel.oracle_failures`; cart-pole's is the final state's
distance from [1, π, 0, 0]. Each package solves a fresh problem; the last
line is a JSON object of the results.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

VARIABLES = ("SLEIPNIR_TPU_BCR", "SLEIPNIR_TPU_INV")


def _oracle(problem: str, X, U, N: int, total_time: float):
    if problem == "flywheel":
        from sleipnir_tpu_torch.models.flywheel import oracle_failures

        return oracle_failures(X, U, total_time)
    return float(np.abs(np.asarray(X)[:, N] - [1.0, math.pi, 0.0, 0.0]).max())


def solve(package: str, problem: str, N: int, total_time: float) -> dict:
    t0 = time.perf_counter()
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        if problem == "flywheel":
            from sleipnir_tpu.models.flywheel import flywheel_problem as build
        else:
            from sleipnir_tpu.models.cart_pole import cart_pole_problem as build
        p, X, U = build(N=N, total_time=total_time)
        status = p.solve()
        iterations = int(p._last_state.iterations)
    else:
        import torch

        torch.set_num_threads(1)
        if problem == "flywheel":
            from sleipnir_tpu_torch.models.flywheel import flywheel_problem as build
        else:
            from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem as build
        p, X, U = build(N=N, total_time=total_time)
        status = p.solve(device="cpu")
        iterations = p.last_solve_stats.iterations
    seconds = time.perf_counter() - t0
    return {"package": package, "status": status.name, "iterations": iterations,
            "seconds": seconds, "oracle": _oracle(problem, X.value(), U.value(), N, total_time)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--problem", choices=["flywheel", "cart_pole"], required=True)
    parser.add_argument("--N", type=int, required=True)
    parser.add_argument("--total-time", type=float, default=5.0)
    parser.add_argument("--variable", choices=[*VARIABLES, "none"], required=True)
    parser.add_argument("--package", choices=["jax", "port", "both"], default="both")
    args = parser.parse_args(argv)
    for name in VARIABLES:
        os.environ.pop(name, None)
    if args.variable != "none":
        os.environ[args.variable] = "1"
    results = []
    for package in (["jax", "port"] if args.package == "both" else [args.package]):
        result = solve(package, args.problem, args.N, args.total_time)
        results.append(result)
        print(f"{args.problem} N={args.N} under {args.variable}, {package}: {result['status']} "
              f"after {result['iterations']} iterations, {result['seconds']:.1f} s; oracle "
              f"{result['oracle']}", flush=True)
    out = {"problem": args.problem, "N": args.N, "variable": args.variable, "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
