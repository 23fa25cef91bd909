"""On-card smoke run of sleipnir_tpu_torch: kernels and main path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from csrc/ with nvcc for sm_90a;
  3. kernels: the block-tridiagonal factor (K1) and solve (K2) kernels
     against their plain torch versions on CUDA tensors, inertia exactly
     and solutions to 1e-10 relative, and both timed with CUDA events at
     the main path's shapes;
  4. main path: the cart-pole swing-up at N=100 solved on the card to the
     1e-8 tolerance, once and then twice timed from the initial guess; the
     result must satisfy the RK4 physics oracle and reach the target
     state, and both kernels must have been launched by the solves.

The last two lines of output are a JSON object of per-kernel results and
a JSON object naming the device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N = 100
TOTAL_TIME = 5.0
TARGET = [1.0, math.pi, 0.0, 0.0]
REL_TOL = 1e-10
KERNEL_CASES = [  # (name, B, K, w, r); r = 0 is a vector right-hand side
    ("ladder", 4, 101, 13, 0),
    ("multi-rhs", 1, 101, 13, 3),
    ("restoration-width", 2, 40, 37, 0),
    ("small", 1, 7, 3, 0),
]


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}]: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def random_system(rng, B, K, w, r):
    """A symmetric indefinite block-tridiagonal system, as in the JAX
    package's kernel tests."""
    D = rng.standard_normal((B, K, w, w))
    D = D + np.swapaxes(D, 2, 3) + 10 * np.eye(w)
    D[:, ::3] -= 18 * np.eye(w)
    E = rng.standard_normal((B, K - 1, w, w))
    b = rng.standard_normal((B, K, w, r) if r else (B, K, w))
    return D, E, b


def ipm_like_chain(rng):
    """Quasidefinite stages with tiny Hessian diagonals and near
    rank-deficient Jacobians (cond(S_k) ~ 1e9), as in the JAX package's
    tests/ops/test_pallas_banded.py."""
    K, m, p = 40, 5, 8
    w = m + p
    D = np.zeros((1, K, w, w))
    E = np.zeros((1, K - 1, w, w))
    for k in range(K):
        A = rng.standard_normal((p, m))
        D[0, k, :m, :m] = 1e-4 * np.eye(m)
        D[0, k, :m, m:] = A.T
        D[0, k, m:, :m] = A
        D[0, k, m:, m:] = -1e-10 * np.eye(p)
        if k + 1 < K:
            E[0, k, :m, :m] = 0.01 * rng.standard_normal((m, m))
            E[0, k, m:, :m] = rng.standard_normal((p, m))
    return D, E, rng.standard_normal((1, K, w))


def cuda_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    if smi.returncode != 0:
        fail("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}", flush=True)

    from sleipnir_tpu_torch import ExitStatus
    from sleipnir_tpu_torch.models.cart_pole import (
        cart_pole_problem,
        dynamics_numpy,
        rk4_numpy,
    )
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA

    # -- 2. build ---------------------------------------------------------
    t0 = time.monotonic()
    try:
        lib, log = cuda_banded.build(verbose=True)
    except RuntimeError as err:
        fail("build", str(err))
    print(f"build: {time.monotonic() - t0:.2f} s -> {lib.name}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernels against their plain versions --------------------------
    rng = np.random.default_rng(2024)
    cases = [(name, *random_system(rng, B, K, w, r)) for name, B, K, w, r in KERNEL_CASES]
    cases.append(("ipm-like-chain", *ipm_like_chain(rng)))
    for name, D, E, b in cases:
        Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
        fk = cuda_banded.banded_factor(Dg, Eg)
        xk = cuda_banded.banded_solve(fk, bg)
        fp = plain.block_tridiag_factor(Dg, Eg)
        xp = plain.block_tridiag_solve(fp, bg)
        torch.cuda.synchronize()
        ik = [t.tolist() for t in plain.block_tridiag_inertia(fk, EPS_INERTIA)]
        ip = [t.tolist() for t in plain.block_tridiag_inertia(fp, EPS_INERTIA)]
        rel = ((xk - xp).abs().max() / xp.abs().max()).item()
        print(f"kernels {name} {tuple(D.shape[:3])}: inertia {ik[0]}/{ik[1]}/{ik[2]} "
              f"(plain {ip[0]}/{ip[1]}/{ip[2]}), solution rel diff {rel:.3e}", flush=True)
        if ik != ip:
            fail("kernels", f"{name}: inertia {ik} != plain {ip}")
        if not rel <= REL_TOL:
            fail("kernels", f"{name}: solution rel diff {rel:.3e} > {REL_TOL}")

    # Errors and times at the main path's shapes: K1 factors the 4-wide
    # ladder (B=4, K=101, w=13); K2 solves one system (B=1) per call.
    D, E, b = random_system(np.random.default_rng(7), 4, 101, 13, 0)
    Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
    fk = cuda_banded.banded_factor(Dg, Eg)
    fp = plain.block_tridiag_factor(Dg, Eg)
    xp = plain.block_tridiag_solve(fp, bg)
    err_factor = (plain.block_tridiag_solve(fk, bg) - xp).abs().max().item()
    f1 = plain.BlockTridiagFactor(*(t[:1].contiguous() for t in fp))
    b1 = bg[:1].contiguous()
    err_solve = (cuda_banded.banded_solve(f1, b1) - plain.block_tridiag_solve(f1, b1)).abs().max().item()
    times = {
        "factor_plain": cuda_ms(lambda: plain.block_tridiag_factor(Dg, Eg), 10),
        "factor": cuda_ms(lambda: cuda_banded.banded_factor(Dg, Eg)),
        "solve": cuda_ms(lambda: cuda_banded.banded_solve(f1, b1)),
        "solve_plain": cuda_ms(lambda: plain.block_tridiag_solve(f1, b1), 10),
    }
    print("kernel times (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)

    # -- 4. main path -----------------------------------------------------
    problem, X, U = cart_pole_problem(N=N, total_time=TOTAL_TIME)
    guess = X.value().copy()
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = problem.solve(device="cuda")
    print(f"first solve: {status}, {problem.last_solve_stats.iterations} iterations, "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    if status != ExitStatus.SUCCESS:
        fail("main path", f"first solve ended {status}")
    solve_s, iterations = [], []
    for _ in range(2):
        X.set_value(guess)
        U.set_value(np.zeros((1, N + 1)))
        t0 = time.monotonic()
        status = problem.solve(device="cuda")
        torch.cuda.synchronize()
        solve_s.append(time.monotonic() - t0)
        iterations.append(problem.last_solve_stats.iterations)
        if status != ExitStatus.SUCCESS:
            fail("main path", f"timed solve ended {status}")
    launches = {"factor": cuda_banded.FACTOR_LAUNCHES, "solve": cuda_banded.SOLVE_LAUNCHES}
    stats = problem.last_solve_stats
    print(f"timed solves: {[f'{t * 1e3:.1f} ms' for t in solve_s]}, iterations {iterations}, "
          f"best {min(solve_s) * 1e3:.1f} ms ({min(solve_s) * 1e3 / iterations[0]:.2f} ms/iteration), "
          f"host syncs/iteration {stats.host_syncs_per_iteration:.2f}, "
          f"launches factor {launches['factor']} solve {launches['solve']}", flush=True)
    if launches["factor"] == 0 or launches["solve"] == 0:
        fail("main path", f"a kernel was never launched: {launches}")

    Xv, Uv = X.value(), U.value()
    if Xv.shape != (4, N + 1) or Uv.shape != (1, N + 1) or not (
        np.isfinite(Xv).all() and np.isfinite(Uv).all()
    ):
        fail("main path", "the trajectory is not finite or has the wrong shape")
    final_err = float(np.abs(Xv[:, N] - TARGET).max())
    dyn_err = max(
        float(np.abs(
            Xv[:, k + 1] - rk4_numpy(dynamics_numpy, Xv[:, k : k + 1], Uv[:, k : k + 1],
                                     TOTAL_TIME / N).ravel()
        ).max())
        for k in range(N)
    )
    print(f"final state error {final_err:.3e}, RK4 oracle error {dyn_err:.3e}", flush=True)
    if not final_err <= 1e-6:
        fail("main path", f"final state {Xv[:, N]} is {final_err:.3e} from the target")
    if not dyn_err <= 1e-8:
        fail("main path", f"trajectory breaks the RK4 oracle by {dyn_err:.3e}")

    kernels = [
        {
            "name": "banded_factor",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": "sleipnir_tpu/ops/pallas_banded.py:360",
            "launches": launches["factor"],
            "max_abs_err": err_factor,
            "ms": times["factor"],
            "plain_ms": times["factor_plain"],
        },
        {
            "name": "banded_solve",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": "sleipnir_tpu/ops/pallas_banded.py:421",
            "launches": launches["solve"],
            "max_abs_err": err_solve,
            "ms": times["solve"],
            "plain_ms": times["solve_plain"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
