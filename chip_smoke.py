"""On-card smoke run of sleipnir_tpu_torch: kernels and its paths.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles every CUDA source in csrc/ with nvcc for sm_90a, one
     nvcc per source, all at once;
  3. kernels: the block-tridiagonal factor (K1) and solve (K2) kernels
     against their plain torch versions on CUDA tensors, inertia exactly
     and solutions to 1e-10 relative, at the main path's shapes, at the
     edges of the kernels' width classes (one row per lane up to w=32, two
     beyond) and at the long horizons where the TPU takes its chunked
     kernels (K3a/K3b); each timed with CUDA events, and K1 at (·, 5001, 4)
     with one system and with the ladder's four;
  4. main path: the cart-pole swing-up at N=100 solved on the card to the
     1e-8 tolerance, once, timed from the initial guess; the result must
     satisfy the RK4 physics oracle and reach the target state, and both
     kernels must have been launched by the solve;
  5. precision probe: `sleipnir_tpu_torch.tools.dd_probe` on the card, one
     kernel launch per probe run; every double-float output must equal
     its plain version bit for bit and the one-hot product torch.matmul's;
     each part is timed host-paced (back-to-back calls) and on the device
     (one call), beside torch.matmul, with the single TF32 pass's error;
  6. long horizon: the flywheel at N=5000 solved on the card, once and
     then once timed from the zero guess; it must reach SUCCESS, pass the
     numpy oracle, and launch K1/K2 at K=5001;
  7. restoration: banded feasibility restoration from a strongly
     infeasible cart-pole N=2000 iterate; it must hand the iterate back
     ("resume") with a violation below 0.95 of the start's, running K1/K2
     on the 37-wide restoration system;
  8. banded SQP: the flywheel without input bounds at N=5000, equality
     constraints only, solved once and then once timed by SQP on the
     banded backend (K=5001); SUCCESS, x_0 = 0, x_N > 9.9, the dynamics to
     1e-7, and K1/K2 launched at K=5001;
  9. dense path: the README example through SQP (x = 18, y = 6) and the
     plain-Problem flywheel at N=1000 through the dense interior-point
     method, which must pass the numpy oracle;
 10. minimum time (the arrowhead border): the flywheel spun up to 50 rad/s
     in minimum time with one shared timestep (VARIABLE_SINGLE) at
     N=5000, solved once from its initial guess with warnings as errors
     (no dense fallback); SUCCESS, N·dt within 1e-3 of the analytic
     optimum, K1 at (4, 5001, 4) and K2 at (4, 5001, 4) for the border
     columns and (1, 5001, 4) for the steps;
 11. the rest of the OCP layer: the minimum-time double integrator with
     one timestep per step (VARIABLE) at N=1000 (total time 2 s, K1 at
     (4, 1001, 8)), direct collocation of ẋ = −x + u at N=5000 (the
     Hermite–Simpson defect recomputed in numpy), the differential drive
     at N=40 (RK4 oracle), the double integrator at N=70 and single
     shooting at N=10 on the dense path;
 12. the batched solve: cart-pole N=100 from 8 guesses as the lanes of one
     `solve_ipm_batched` solve, timed from the guesses; every lane must
     reach SUCCESS, the target state, the RK4 oracle and the JAX package's
     cost, with K1 at (32, 101, 13) (the ladders of all lanes in one
     launch) and K2 at (8, 101, 13); then `multistart` on Mishra's bird
     (the dense backend) and one Gradient, Jacobian and Hessian on the
     card against the CPU.

Phase 3 also holds K2 with the border's batched right-hand sides:
(4, 5001, 4) with one column, the path's shape, and (4, 101, 13) with
two; and the batched solve's shapes, K1 at (32, 101, 13) and K2 at
(8, 101, 13), timed beside the single solve's. Launch counts are reset
just before each path (phases 4-12) and read just after it. The last two
lines of output are a JSON object of per-kernel results and a JSON
object naming the device.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
import warnings

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
#: The edges of the kernels' width classes (one row per lane up to w=32,
#: two beyond), at B=1 and B=4 over K=9 well-conditioned stages: random
#: stages 31 to 37 wide amplify rounding past 1e-10 even over 9 stages.
EDGE_WIDTHS = (1, 5, 6, 31, 32, 33, 37)
#: Long horizons (B, K, w, system): the TPU takes its chunked kernels
#: here. The flywheel at N=5000 factors (4, 5001, 4) and solves
#: (1, 5001, 4); cart-pole's restoration at N=2000 factors (4, 2001, 37).
#: Random 37-wide stages chained over 2001 stages make a system so
#: ill-conditioned that two correct f64 orderings differ near 1e-10, so
#: that width takes well-conditioned stages of mixed inertia instead.
LONG_CASES = [
    (1, 5001, 3, "random"), (4, 5001, 4, "random"), (4, 1001, 13, "random"),
    (4, 5001, 13, "random"), (4, 2001, 37, "conditioned"),
]
#: K2 over the ladder's candidates with the border columns as right-hand
#: sides (B, K, w, r): the minimum-time flywheel's shape at N=5000 (one
#: border column) and a wider one with two.
BORDER_SOLVE_CASES = [(4, 5001, 4, 1), (4, 101, 13, 2)]
FLYWHEEL_N = 5000
#: The batched solve (phase 12): cart-pole N=100 from L guesses
#: 0.01·k·randn(n), k = 0..L-1 (seed 0, as __graft_entry__.py:83-86), and
#: what the JAX package's `solve_ipm_batched` gives on a CPU: every lane
#: SUCCESS, these iterations, and this cost to 1e-8 relative.
LANES = 8
LANES_JAX_ITERATIONS = [42, 42, 40, 37, 38, 48, 42, 41]
LANES_JAX_COST = 7578.4538198
#: K1 over the ladders of all lanes, K2 over the lanes' step systems.
LANE_FACTOR_SHAPE, LANE_SOLVE_SHAPE = (4 * LANES, N + 1, 13), (LANES, N + 1, 13)
#: Mishra's bird (tests/optimization/test_multistart.py:69): the guesses
#: and the constrained global minimum.
BIRD_GUESSES = [(-3.0, -8.0), (-3.0, -1.5), (-6.0, -4.0), (-2.0, -6.0)]
BIRD_MINIMUM = (-3.1302468, -1.5821422)
#: The minimum-time flywheel (VARIABLE_SINGLE) at the top of the repo's
#: scalability sweep, and the minimum-time double integrator with one
#: timestep per step (VARIABLE) at the JAX package's largest size that
#: reaches SUCCESS on a CPU (478 iterations there).
MIN_TIME_N = 5000
PER_STEP_N, PER_STEP_JAX_ITERATIONS = 1000, 478
#: Direct collocation of ẋ = −x + u over 3 s (tests/optimization/
#: test_ocp.py:88-111 at the long horizon).
COLLOCATION_N, COLLOCATION_T = 5000, 3.0
#: The plain-Problem flywheel on the dense path, at the JAX package's
#: default horizon.
DENSE_FLYWHEEL_N = 1000
RESTORATION_N, RESTORATION_SEED, RESTORATION_SCALE = 2000, 7, 0.3
#: Stage rows K·w above which the TPU package takes its chunked kernels:
#: ⌈K·w/8⌉·4096 bytes over its 3.5 MB single-shot budget
#: (sleipnir_tpu/ops/pallas_banded.py:471, :491-493).
TPU_CHUNKED_ROWS = 6833
#: Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes
#: per second, and float64 (tensor-core) and float32 operations per second.
HBM_BYTES_PER_S = 3.35e12
F64_PER_S = 67e12
F32_PER_S = 67e12


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


def conditioned_system(rng, B, K, w):
    """Symmetric stages Q diag(λ) Qᵀ with |λ| in [20, 40] of random sign,
    coupled by E = 0.5·randn: every Schur complement keeps its
    eigenvalues far from zero, whatever K."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, K, w, w)))
    lam = rng.choice([-1.0, 1.0], (B, K, w)) * rng.uniform(20.0, 40.0, (B, K, w))
    D = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    D = 0.5 * (D + np.swapaxes(D, 2, 3))
    return D, 0.5 * rng.standard_normal((B, K - 1, w, w)), rng.standard_normal((B, K, w))


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


def restoration_start(n: int, dev: torch.device):
    """Cart-pole at horizon n from the strongly infeasible iterate of the
    JAX package's tests/solver/test_banded_restoration.py (seed 7, scale
    0.3): (funcs, state, options, backend, violation), ready for
    `feasibility_restoration.restore(funcs, state, options,
    parent_backend=backend)`; `violation(x)` is the ℓ1 constraint
    violation at x."""
    from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
    from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
    from sleipnir_tpu_torch.optimization.solver.options import Options

    cp, _, _ = cart_pole_problem(N=n, total_time=TOTAL_TIME)
    options = Options(device=dev.type)
    comp = cp._compile()
    init, _step, _resume, funcs, g_fn, backend = cp._prepare_ipm(comp, options, dev)
    params = comp["compiled"].gather_params()
    x0 = RESTORATION_SCALE * np.random.default_rng(RESTORATION_SEED).standard_normal(comp["n"])
    scaling, _, _ = cp._ipm_scaling(g_fn, backend, x0, params)
    state = init(x0, np.ones(comp["mi"]), np.zeros(comp["me"]), np.ones(comp["mi"]),
                 0.1 * scaling.f, 0, params,
                 ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=scaling.c_i))

    def violation(xv):
        xt = torch.as_tensor(xv, dtype=torch.float64, device=dev)
        ce = funcs.c_e(xt, state.params, state.scaling)
        ci = funcs.c_i(xt, state.params, state.scaling)
        return float(ce.abs().sum() + torch.clamp(ci, max=0.0).abs().sum())

    return funcs, state, options, backend, violation


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


def device_ms(fn, reps: int = 20) -> float:
    """The device time of one call (median of `reps`): the card first runs
    a sleep kernel of about half a millisecond, so the call is enqueued
    before the start event runs and the events hold the device's work,
    not the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_diff(x, ref) -> float:
    return ((x - ref).abs().max() / ref.abs().max()).item()


def bound(ops: float, op_rate: float, nbytes: float):
    """The least time the card could take (ms) and what sets it."""
    t_ops, t_bytes = ops / op_rate, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def factor_bound(B, K, w):
    """K1's function: per stage an LU (2w³/3) and an LDLᵀ (w³/3) of S_k,
    X_k = S_k⁻¹E_kᵀ (2w³) and S_{k+1} = D_{k+1} − E_k X_k (2w³) in f64;
    D and E read once, LU, X, d (f64) and perm (i32) written once."""
    ops = B * K * 5.0 * w**3
    nbytes = 8 * B * ((2 * K - 1) * w * w * 2 + K * w) + 4 * B * K * w
    return bound(ops, F64_PER_S, nbytes)


def solve_bound(B, K, w, r=1):
    """K2's function: per stage and right-hand side Xₖᵀy, the LU solve and
    X x (6w² f64 operations); LU, X, perm and b read once, x written once."""
    ops = B * K * r * 6.0 * w * w
    nbytes = 8 * B * ((2 * K - 1) * w * w + 2 * K * w * r) + 4 * B * K * w
    return bound(ops, F64_PER_S, nbytes)


def long_launches(shape_counts, kind):
    """Launches of `kind` at shapes where the TPU takes its chunked kernels."""
    return {
        f"B={B},K={K},w={w}": n for (k, B, K, w), n in shape_counts.items()
        if k == kind and K * w >= TPU_CHUNKED_ROWS
    }


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

    from sleipnir_tpu_torch import (
        OCP,
        DynamicsType,
        ExitStatus,
        Options,
        Problem,
        TimestepMethod,
        TranscriptionMethod,
    )
    from sleipnir_tpu_torch.models import differential_drive, double_integrator, flywheel
    from sleipnir_tpu_torch.models.cart_pole import (
        cart_pole_problem,
        dynamics_numpy,
        rk4_numpy,
    )
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded, cuda_build, cuda_dd_probe
    from sleipnir_tpu_torch.ops import dd as plain_dd
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA
    from sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration import restore
    from sleipnir_tpu_torch.tools import dd_probe

    # -- 2. build ---------------------------------------------------------
    t0 = time.monotonic()
    sources = [cuda_banded.SOURCE, cuda_dd_probe.SOURCE]
    try:
        built = cuda_build.build(sources, verbose=True)
    except RuntimeError as err:
        fail("build", str(err))
    print(f"build: {time.monotonic() - t0:.2f} s -> {', '.join(lib.name for lib, _ in built)}",
          flush=True)
    for src, (_lib, log) in zip(sources, built):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src.path.name}:", line.strip(), flush=True)

    # -- 3. kernels against their plain versions --------------------------
    t_phase = time.monotonic()
    rng = np.random.default_rng(2024)
    cases = [(name, *random_system(rng, B, K, w, r)) for name, B, K, w, r in KERNEL_CASES]
    cases.append(("ipm-like-chain", *ipm_like_chain(rng)))
    cases += [(f"edge-w{w}-B{B}", *conditioned_system(rng, B, 9, w))
              for w in EDGE_WIDTHS for B in (1, 4)]
    for name, D, E, b in cases:
        Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
        fk = cuda_banded.banded_factor(Dg, Eg)
        xk = cuda_banded.banded_solve(fk, bg)
        fp = plain.block_tridiag_factor(Dg, Eg)
        xp = plain.block_tridiag_solve(fp, bg)
        # Each kernel alone (K1: the plain solve on its factor; K2: on the
        # plain factor) and both together, unrefined.
        rels = {"both": rel_diff(xk, xp),
                "K1 alone": rel_diff(plain.block_tridiag_solve(fk, bg), xp),
                "K2 alone": rel_diff(cuda_banded.banded_solve(fp, bg), xp)}
        torch.cuda.synchronize()
        ik = [t.tolist() for t in plain.block_tridiag_inertia(fk, EPS_INERTIA)]
        ip = [t.tolist() for t in plain.block_tridiag_inertia(fp, EPS_INERTIA)]
        print(f"kernels {name} {tuple(D.shape[:3])}: inertia {ik[0]}/{ik[1]}/{ik[2]} "
              f"(plain {ip[0]}/{ip[1]}/{ip[2]}), solution rel diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()), flush=True)
        if ik != ip:
            fail("kernels", f"{name}: inertia {ik} != plain {ip}")
        if not torch.equal(fk.perm, fp.perm):
            fail("kernels", f"{name}: pivot permutations differ from the plain version's")
        for key, rel in rels.items():
            if not rel <= REL_TOL:
                fail("kernels", f"{name}: solution rel diff ({key}) {rel:.3e} > {REL_TOL}")

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

    # The batched solve's shapes: K1 over the 4-wide ladders of all lanes
    # at once, and K2 over one system per lane (the rung each lane picks;
    # here every fourth candidate).
    D, E, b = random_system(np.random.default_rng(8), *LANE_FACTOR_SHAPE, 0)
    Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
    fk = cuda_banded.banded_factor(Dg, Eg)
    fp = plain.block_tridiag_factor(Dg, Eg)
    xp = plain.block_tridiag_solve(fp, bg)
    xf = plain.block_tridiag_solve(fk, bg)
    rung = torch.arange(0, LANE_FACTOR_SHAPE[0], 4, device=dev)
    fl = plain.BlockTridiagFactor(*(t[rung].contiguous() for t in fp))
    bl = bg[rung].contiguous()
    xl, xl_plain = cuda_banded.banded_solve(fl, bl), plain.block_tridiag_solve(fl, bl)
    torch.cuda.synchronize()
    ik = [t.tolist() for t in plain.block_tridiag_inertia(fk, EPS_INERTIA)]
    ip = [t.tolist() for t in plain.block_tridiag_inertia(fp, EPS_INERTIA)]
    lane_kernels = {
        "factor": {
            "B": LANE_FACTOR_SHAPE[0], "K": N + 1, "w": 13,
            "max_abs_err": (xf - xp).abs().max().item(), "rel_err": rel_diff(xf, xp),
            "ms": cuda_ms(lambda: cuda_banded.banded_factor(Dg, Eg)),
            "plain_ms": cuda_ms(lambda: plain.block_tridiag_factor(Dg, Eg), 10),
            **dict(zip(("bound_ms", "bound_by"), factor_bound(*LANE_FACTOR_SHAPE))),
        },
        "solve": {
            "B": LANE_SOLVE_SHAPE[0], "K": N + 1, "w": 13,
            "max_abs_err": (xl - xl_plain).abs().max().item(), "rel_err": rel_diff(xl, xl_plain),
            "ms": cuda_ms(lambda: cuda_banded.banded_solve(fl, bl)),
            "plain_ms": cuda_ms(lambda: plain.block_tridiag_solve(fl, bl), 10),
            **dict(zip(("bound_ms", "bound_by"), solve_bound(*LANE_SOLVE_SHAPE))),
        },
    }
    for which, e in lane_kernels.items():
        print(f"kernels lanes {which} ({e['B']}, {e['K']}, {e['w']}): rel diff {e['rel_err']:.3e}, "
              f"{e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.5f}; the "
              f"single solve's ({4 if which == 'factor' else 1}, {N + 1}, 13): "
              f"{times[which]:.4f} ms)", flush=True)
        if not e["rel_err"] <= REL_TOL:
            fail("kernels", f"lanes {which}: rel diff {e['rel_err']:.3e} > {REL_TOL}")
    if ik != ip or not torch.equal(fk.perm, fp.perm):
        fail("kernels", f"lanes factor: inertia {ik} (plain {ip}) or pivots differ")
    del Dg, Eg, bg, fk, fp, xp, xf, fl, bl, xl, xl_plain

    # The long horizons: the same kernels where the TPU chunks. The factor
    # at (B, K, w), the solve on its first system (B=1), as the paths call
    # them; the plain versions loop over K on the host, so one rep each.
    # Each kernel is held on its own (K1: the plain solve on its factor;
    # K2: on the plain factor) and the two together, all unrefined.
    long = {}
    systems = {"random": lambda rng, B, K, w: random_system(rng, B, K, w, 0),
               "conditioned": conditioned_system}
    for B, K, w, system in LONG_CASES:
        D, E, b = systems[system](np.random.default_rng(B * K + w), B, K, w)
        Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
        fk = cuda_banded.banded_factor(Dg, Eg)
        xk = cuda_banded.banded_solve(fk, bg)
        fp = plain.block_tridiag_factor(Dg, Eg)
        xp = plain.block_tridiag_solve(fp, bg)
        xf = plain.block_tridiag_solve(fk, bg)
        f1 = plain.BlockTridiagFactor(*(t[:1].contiguous() for t in fp))
        b1 = bg[:1].contiguous()
        xs = cuda_banded.banded_solve(f1, b1)
        xs_plain = plain.block_tridiag_solve(f1, b1)
        torch.cuda.synchronize()
        ik = [t.tolist() for t in plain.block_tridiag_inertia(fk, EPS_INERTIA)]
        ip = [t.tolist() for t in plain.block_tridiag_inertia(fp, EPS_INERTIA)]
        entry = {
            "system": system,
            "factor_max_abs_err": (xf - xp).abs().max().item(),
            "factor_rel_err": rel_diff(xf, xp),
            "solve_max_abs_err": (xs - xs_plain).abs().max().item(),
            "solve_rel_err": rel_diff(xs, xs_plain),
            "rel_err": rel_diff(xk, xp),
            "inertia_equal": ik == ip,
            "perm_equal": torch.equal(fk.perm, fp.perm),
            "factor_ms": cuda_ms(lambda: cuda_banded.banded_factor(Dg, Eg), 3),
            "factor_plain_ms": cuda_ms(lambda: plain.block_tridiag_factor(Dg, Eg), 1),
            "solve_ms": cuda_ms(lambda: cuda_banded.banded_solve(f1, b1), 5),
            "solve_plain_ms": cuda_ms(lambda: plain.block_tridiag_solve(f1, b1), 1),
        }
        if (B, K, w) == (4, FLYWHEEL_N + 1, 4):
            # The batch axis: one system against the ladder's four.
            D1, E1 = Dg[:1].contiguous(), Eg[:1].contiguous()
            entry["factor_b1_ms"] = cuda_ms(lambda: cuda_banded.banded_factor(D1, E1), 3)
            del D1, E1
        entry["factor_bound_ms"], entry["factor_bound_by"] = factor_bound(B, K, w)
        entry["solve_bound_ms"], entry["solve_bound_by"] = solve_bound(1, K, w)
        long[B, K, w] = entry
        print(f"kernels long (B={B}, K={K}, w={w}, {system}): inertia {ik[0]}/{ik[1]}/{ik[2]} "
              f"(plain {ip[0]}/{ip[1]}/{ip[2]}), pivots equal {entry['perm_equal']}, solution "
              f"rel diff {entry['rel_err']:.3e} (factor alone {entry['factor_rel_err']:.3e}, "
              f"solve alone {entry['solve_rel_err']:.3e}); factor "
              f"{entry['factor_ms']:.3f} ms (plain {entry['factor_plain_ms']:.1f}, bound "
              f"{entry['factor_bound_ms']:.5f}), solve {entry['solve_ms']:.3f} ms (plain "
              f"{entry['solve_plain_ms']:.1f}, bound {entry['solve_bound_ms']:.5f})"
              + (f"; factor with B=1 {entry['factor_b1_ms']:.3f} ms" if "factor_b1_ms" in entry else ""),
              flush=True)
        if ik != ip:
            fail("kernels", f"long {(B, K, w)}: inertia {ik} != plain {ip}")
        if not entry["perm_equal"]:
            fail("kernels", f"long {(B, K, w)}: pivot permutations differ from the plain version's")
        for key in ("rel_err", "factor_rel_err", "solve_rel_err"):
            if not entry[key] <= REL_TOL:
                fail("kernels", f"long {(B, K, w)}: {key} {entry[key]:.3e} > {REL_TOL}")
        del Dg, Eg, bg, fk, xk, fp, xp, xf, f1, b1, xs, xs_plain
    # K2 with the border's batched right-hand sides, after K1 at the same
    # shape: held on the kernel factor alone and, with K1, against the
    # plain factor and solve.
    border = {}
    for B, K, w, r in BORDER_SOLVE_CASES:
        D, E, b = random_system(np.random.default_rng(B * K + w + r), B, K, w, r)
        Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
        fk = cuda_banded.banded_factor(Dg, Eg)
        xk = cuda_banded.banded_solve(fk, bg)
        xs_plain = plain.block_tridiag_solve(fk, bg)
        xp = plain.block_tridiag_solve(plain.block_tridiag_factor(Dg, Eg), bg)
        torch.cuda.synchronize()
        entry = {
            "B": B, "K": K, "w": w, "r": r, "system": "random",
            "max_abs_err": (xk - xs_plain).abs().max().item(),
            "rel_err": rel_diff(xk, xs_plain),
            "with_factor_rel_err": rel_diff(xk, xp),
            "ms": cuda_ms(lambda: cuda_banded.banded_solve(fk, bg), 5),
            "plain_ms": cuda_ms(lambda: plain.block_tridiag_solve(fk, bg), 1),
        }
        entry["us_per_stage"] = 1e3 * entry["ms"] / K
        entry["bound_ms"], entry["bound_by"] = solve_bound(B, K, w, r)
        border[B, K, w, r] = entry
        print(f"kernels border solve (B={B}, K={K}, w={w}, r={r}): rel diff {entry['rel_err']:.3e} "
              f"(with K1 against the plain factor {entry['with_factor_rel_err']:.3e}), "
              f"{entry['ms']:.3f} ms (plain {entry['plain_ms']:.1f}, bound "
              f"{entry['bound_ms']:.5f})", flush=True)
        for key in ("rel_err", "with_factor_rel_err"):
            if not entry[key] <= REL_TOL:
                fail("kernels", f"border solve {(B, K, w, r)}: {key} {entry[key]:.3e} > {REL_TOL}")
        del Dg, Eg, bg, fk, xk, xs_plain, xp
    torch.cuda.empty_cache()
    print(f"kernels phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 4. main path -----------------------------------------------------
    t_phase = time.monotonic()
    problem, X, U = cart_pole_problem(N=N, total_time=TOTAL_TIME)
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = problem.solve(device="cuda")
    torch.cuda.synchronize()
    solve_s = time.monotonic() - t0
    launches = {"factor": cuda_banded.FACTOR_LAUNCHES, "solve": cuda_banded.SOLVE_LAUNCHES}
    stats = problem.last_solve_stats
    print(f"solve: {status}, {stats.iterations} iterations, {solve_s * 1e3:.1f} ms "
          f"({solve_s * 1e3 / max(stats.iterations, 1):.2f} ms/iteration), "
          f"host syncs/iteration {stats.host_syncs_per_iteration:.2f}, "
          f"launches factor {launches['factor']} solve {launches['solve']}", flush=True)
    if status != ExitStatus.SUCCESS:
        fail("main path", f"solve ended {status}")
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
    print(f"main path phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 5. precision probe -----------------------------------------------
    t_phase = time.monotonic()
    cuda_dd_probe.reset_counters()
    probe = dd_probe.main(["--device", "cuda"])
    probe_launches = cuda_dd_probe.LAUNCHES
    if probe_launches != 1:
        fail("precision probe", f"a probe run took {probe_launches} launches, not one")
    if not probe.get("bitwise_equal"):
        fail("precision probe", "the kernel differs from the plain version")
    x = dd_probe.probe_inputs(dev)
    matmul = torch.matmul(x["P"], x["Mh"])
    fused, _single = dd_probe.run_fused(x)
    for label, product in (("probe", fused["onehot"][0]),
                           ("onehot_product", cuda_dd_probe.onehot_product(x["P"], x["Mh"]))):
        if not torch.equal(product.view(torch.int32), matmul.view(torch.int32)):
            fail("precision probe", f"the {label} one-hot product differs from torch.matmul")
    # The whole probe run is the wrapper call that launches it.
    probe_args = (x["ah"], x["al"], x["bh"], x["bl"], x["P"], x["Mh"])
    probe_ms = cuda_ms(lambda: cuda_dd_probe.probe(*probe_args))
    probe_device_ms = device_ms(lambda: cuda_dd_probe.probe(*probe_args))
    probe_plain_ms = cuda_ms(lambda: dd_probe.run_probe(x, dd_probe.plain_primitive,
                                                        plain_dd.onehot_product))
    # Each part alone, through its thin call into the same kernel. Bounds:
    # float32 operations per element as ops/dd.py writes them, inputs read
    # once and (hi, lo) written once. Only the one-hot product has a single
    # library call: torch.matmul (float32; TF32 is off by default), timed
    # here and used nowhere else.
    n_el, w_oh = x["ah"].numel(), x["P"].shape[0]
    primitives = (("two_sum", 6, 2), ("two_prod", 17, 2), ("add2", 20, 4),
                  ("mul2", 24, 4), ("div2", 114, 4))
    probe_parts = []
    for name, ops, n_in in primitives:
        args = (x["ah"], x["bh"]) if n_in == 2 else (x["ah"], x["al"], x["bh"], x["bl"])
        probe_parts.append({
            "name": name,
            "ms": cuda_ms(lambda: cuda_dd_probe.primitive(name, *args)),
            "device_ms": device_ms(lambda: cuda_dd_probe.primitive(name, *args)),
            "plain_ms": cuda_ms(lambda: dd_probe.plain_primitive(name, *args)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(ops * n_el, F32_PER_S, 4 * n_el * (n_in + 2)))),
            "library_ms": None,
        })
    probe_parts.append({
        "name": "onehot_product",
        "ms": cuda_ms(lambda: cuda_dd_probe.onehot_product(x["P"], x["Mh"])),
        "device_ms": device_ms(lambda: cuda_dd_probe.onehot_product(x["P"], x["Mh"])),
        "plain_ms": cuda_ms(lambda: plain_dd.onehot_product(x["P"], x["Mh"])),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2.0 * w_oh**3, F32_PER_S, 4 * 3 * w_oh * w_oh))),
        "library_ms": cuda_ms(lambda: torch.matmul(x["P"], x["Mh"])),
        "library_device_ms": device_ms(lambda: torch.matmul(x["P"], x["Mh"])),
        "equals_library": True,
    })
    matmul_ms = probe_parts[-1]["library_ms"]
    targets = {"probe_vs_matmul": probe_ms <= matmul_ms,
               "onehot_vs_matmul": probe_parts[-1]["ms"] <= matmul_ms}
    # The whole probe: inputs (ah, al, bh, bl, P, Mh) read once, its ten
    # element outputs and the two products (exact, one TF32 pass) written
    # once.
    probe_bound = bound(sum(ops for _n, ops, _i in primitives) * n_el + 4.0 * w_oh**3, F32_PER_S,
                        4 * (4 * n_el + 2 * w_oh * w_oh) + 4 * (10 * n_el + 2 * w_oh * w_oh))
    print(f"precision probe: {probe_launches} launch per run, bitwise equal to the plain version "
          f"and to torch.matmul; one TF32 pass errs by {probe['tf32_single_pass_max_err']}; "
          f"whole probe {probe_ms:.4f} ms host-paced, {probe_device_ms:.4f} ms on the device "
          f"(plain {probe_plain_ms:.4f}); "
          + ", ".join(f"{p['name']} {p['ms']:.4f} ms (device {p['device_ms']:.4f}, plain "
                      f"{p['plain_ms']:.4f}"
                      + ("" if p["library_ms"] is None else
                         f", torch.matmul {p['library_ms']:.4f}, device {p['library_device_ms']:.4f}")
                      + ")" for p in probe_parts)
          + f"; targets met {targets}; phase {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 6. long horizon: flywheel N=5000 -----------------------------------
    t_phase = time.monotonic()
    fly, FX, FU = flywheel.flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = fly.solve(device="cuda")
    first_s = time.monotonic() - t0
    if status != ExitStatus.SUCCESS:
        fail("long horizon", f"first flywheel solve ended {status}")
    FX.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    FU.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    t0 = time.monotonic()
    status = fly.solve(device="cuda")
    torch.cuda.synchronize()
    fly_s = time.monotonic() - t0
    fly_shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
    fly_iters = fly.last_solve_stats.iterations
    if status != ExitStatus.SUCCESS:
        fail("long horizon", f"timed flywheel solve ended {status}")
    failures = flywheel.oracle_failures(FX.value(), FU.value(), TOTAL_TIME)
    print(f"flywheel N={FLYWHEEL_N}: {status}, {fly_iters} iterations (the JAX package: "
          f"18 on a TPU, docs/scalability_results.md:123), first solve {first_s:.2f} s, "
          f"timed solve {fly_s:.2f} s ({fly_s * 1e3 / fly_iters:.1f} ms/iteration), "
          f"launches {fly_shapes}, oracle failures {len(failures)}", flush=True)
    if failures:
        fail("long horizon", "flywheel oracle: " + "; ".join(failures[:5]))
    for k in ("factor", "solve"):
        if not any(kk == k and K == FLYWHEEL_N + 1 for kk, _b, K, _w in fly_shapes):
            fail("long horizon", f"no {k} launch at K={FLYWHEEL_N + 1}: {fly_shapes}")
    print(f"long horizon phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 7. restoration: cart-pole N=2000 -----------------------------------
    t_phase = time.monotonic()
    funcs, state, options, backend, violation = restoration_start(RESTORATION_N, dev)
    v0 = violation(state.x)
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    outcome, x_new, _s, _y, _z, fr_iters = restore(funcs, state, options, parent_backend=backend)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    fr_shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
    v1 = violation(x_new)
    print(f"restoration cart-pole N={RESTORATION_N}: {outcome} after {fr_iters} iterations, "
          f"{restore_s:.2f} s, violation {v0:.6g} -> {v1:.6g} ({v1 / v0:.4f} of the start), "
          f"launches {fr_shapes}", flush=True)
    if outcome != "resume":
        fail("restoration", f"outcome {outcome}")
    if not v1 < 0.95 * v0:
        fail("restoration", f"violation {v1} is not below 0.95 x {v0}")
    for k in ("factor", "solve"):
        if not any(kk == k and K == RESTORATION_N + 1 and w == 37 for kk, _b, K, w in fr_shapes):
            fail("restoration", f"no {k} launch at K={RESTORATION_N + 1}, w=37: {fr_shapes}")
    print(f"restoration phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 8. SQP on the banded kernels: flywheel without input bounds --------
    t_phase = time.monotonic()
    sqp, SX, SU = flywheel.flywheel_unbounded_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = sqp.solve(device="cuda")
    torch.cuda.synchronize()
    sqp_first_s = time.monotonic() - t0
    if status != ExitStatus.SUCCESS:
        fail("banded SQP", f"first solve ended {status}")
    SX.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    SU.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = sqp.solve(device="cuda")
    torch.cuda.synchronize()
    sqp_s = time.monotonic() - t0
    sqp_shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
    sqp_iters = sqp.last_solve_stats.iterations
    if status != ExitStatus.SUCCESS:
        fail("banded SQP", f"timed solve ended {status}")
    [sqp_cached] = [v for k, v in sqp._solver_cache.items() if k[0] == "sqp"]
    sqp_backend = sqp_cached[-1]
    if type(sqp_backend).__name__ != "BandedBackend" or sqp_backend.K != FLYWHEEL_N + 1:
        fail("banded SQP", f"the solve ran on {type(sqp_backend).__name__}, not the banded "
             f"backend with K={FLYWHEEL_N + 1}")
    Xs, Us = SX.value(), SU.value()
    a = math.exp(-TOTAL_TIME / FLYWHEEL_N)
    sqp_dyn = float(np.abs(Xs[0, 1:] - (a * Xs[0, :-1] + (1.0 - a) * Us[0, :FLYWHEEL_N])).max())
    print(f"banded SQP flywheel N={FLYWHEEL_N} without input bounds: {status}, {sqp_iters} "
          f"iterations, first solve {sqp_first_s:.2f} s, timed solve {sqp_s:.3f} s "
          f"({sqp_s * 1e3 / max(sqp_iters, 1):.1f} ms/iteration), backend "
          f"{type(sqp_backend).__name__} K={sqp_backend.K} stage width w={sqp_backend.w}, "
          f"x_0 {Xs[0, 0]:.3e}, x_N {Xs[0, -1]:.6f}, dynamics residual {sqp_dyn:.3e}, "
          f"launches {sqp_shapes}", flush=True)
    if not abs(Xs[0, 0]) < 1e-9:
        fail("banded SQP", f"x_0 = {Xs[0, 0]}")
    if not Xs[0, FLYWHEEL_N] > 9.9:
        fail("banded SQP", f"x_N = {Xs[0, FLYWHEEL_N]} is not above 9.9")
    if not sqp_dyn <= 1e-7:
        fail("banded SQP", f"dynamics residual {sqp_dyn:.3e} above 1e-7")
    for k in ("factor", "solve"):
        if not any(kk == k and K == FLYWHEEL_N + 1 for kk, _b, K, _w in sqp_shapes):
            fail("banded SQP", f"no {k} launch at K={FLYWHEEL_N + 1}: {sqp_shapes}")
    print(f"banded SQP phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 9. the dense path: README (SQP) and the plain-Problem flywheel -----
    t_phase = time.monotonic()
    readme = Problem()
    rx, ry = readme.decision_variable(), readme.decision_variable()
    rx.set_value(1.0)
    ry.set_value(2.0)
    readme.maximize(rx * ry)
    readme.subject_to(rx + 3 * ry == 36)
    t0 = time.monotonic()
    status = readme.solve(device="cuda")
    torch.cuda.synchronize()
    readme_s = time.monotonic() - t0
    [readme_cached] = [v for k, v in readme._solver_cache.items() if k[0] == "sqp"]
    print(f"README example (SQP, {type(readme_cached[-1]).__name__}): {status}, "
          f"{readme.last_solve_stats.iterations} iterations, {readme_s:.3f} s, x = {rx.value()}, "
          f"y = {ry.value()}", flush=True)
    if status != ExitStatus.SUCCESS or not (abs(rx.value() - 18.0) <= 1e-8
                                            and abs(ry.value() - 6.0) <= 1e-8):
        fail("dense path", f"README example: {status}, x = {rx.value()}, y = {ry.value()}")
    dense_fly, DX, DU = flywheel.flywheel_problem(N=DENSE_FLYWHEEL_N, total_time=TOTAL_TIME,
                                                  fast=False)
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    status = dense_fly.solve(device="cuda")
    torch.cuda.synchronize()
    dense_s = time.monotonic() - t0
    dense_iters = dense_fly.last_solve_stats.iterations
    [dense_cached] = [v for k, v in dense_fly._solver_cache.items() if k[0] == "ipm"]
    dense_failures = flywheel.oracle_failures(DX.value(), DU.value(), TOTAL_TIME)
    print(f"plain-Problem flywheel N={DENSE_FLYWHEEL_N} (dense IPM, "
          f"{type(dense_cached[-1]).__name__}, KKT size "
          f"{dense_cached[-1].n + dense_cached[-1].me}): {status}, {dense_iters} iterations, "
          f"{dense_s:.2f} s ({dense_s * 1e3 / max(dense_iters, 1):.1f} ms/iteration), oracle "
          f"failures {len(dense_failures)}, banded launches {dict(cuda_banded.LAUNCHES_BY_SHAPE)}",
          flush=True)
    if status != ExitStatus.SUCCESS:
        fail("dense path", f"plain-Problem flywheel ended {status}")
    if type(dense_cached[-1]).__name__ != "DenseBackend":
        fail("dense path", f"the flywheel ran on {type(dense_cached[-1]).__name__}")
    if dense_failures:
        fail("dense path", "flywheel oracle: " + "; ".join(dense_failures[:5]))
    print(f"dense path phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 10. minimum time: the arrowhead border ----------------------------
    t_phase = time.monotonic()
    t0 = time.monotonic()
    mt, MX, MU = flywheel.flywheel_min_time_problem(N=MIN_TIME_N)
    mt_options = Options(device="cuda")
    mt_backend = mt._prepare_ipm(mt._compile(), mt_options, dev)[-1]
    mt_setup_s = time.monotonic() - t0
    if type(mt_backend).__name__ != "BandedBackend" or mt_backend.nb != 1:
        fail("minimum time", f"the solve would run on {type(mt_backend).__name__} "
             f"with nb={getattr(mt_backend, 'nb', None)}, not the bordered banded backend")
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        status = mt.solve(mt_options)
    torch.cuda.synchronize()
    mt_s = time.monotonic() - t0
    mt_shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
    mt_stats = mt.last_solve_stats
    mt_total = float(mt.dt().value(0, 0)) * MIN_TIME_N
    t_star = flywheel.min_time_optimum()
    mt_x, mt_u = MX.value(), MU.value()
    print(f"minimum-time flywheel N={MIN_TIME_N} (VARIABLE_SINGLE, border nb=1, K="
          f"{mt_backend.K}, w={mt_backend.w}): {status}, {mt_stats.iterations} iterations (the "
          f"JAX package on a CPU: 31 at N=200, 228 at N=1000), set-up {mt_setup_s:.2f} s, solve "
          f"{mt_s:.2f} s ({mt_s * 1e3 / max(mt_stats.iterations, 1):.1f} ms/iteration), host syncs "
          f"{mt_stats.host_syncs} ({mt_stats.host_syncs_per_iteration:.3f}/iteration), N·dt "
          f"{mt_total:.10f} s against T* {t_star:.10f} s (rel {abs(mt_total / t_star - 1):.3e}), "
          f"x_N {mt_x[0, -1]:.9f}, launches {mt_shapes}", flush=True)
    if status != ExitStatus.SUCCESS:
        fail("minimum time", f"solve ended {status}")
    if not abs(mt_total / t_star - 1.0) <= 1e-3:
        fail("minimum time", f"N·dt = {mt_total} is not within 1e-3 of T* = {t_star}")
    if not (np.isfinite(mt_x).all() and np.isfinite(mt_u).all() and abs(mt_x[0, 0]) <= 1e-8
            and abs(mt_x[0, -1] - 50.0) <= 1e-6 and np.abs(mt_u).max() <= 12.0 + 1e-9):
        fail("minimum time", f"x_0 {mt_x[0, 0]}, x_N {mt_x[0, -1]}, max |u| {np.abs(mt_u).max()}")
    K_mt = MIN_TIME_N + 1
    for key in (("factor", 4, K_mt, 4), ("solve", 4, K_mt, 4), ("solve", 1, K_mt, 4)):
        if not mt_shapes.get(key):
            fail("minimum time", f"no launch at {key}: {mt_shapes}")
    print(f"minimum time phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 11. the rest of the OCP layer --------------------------------------
    t_phase = time.monotonic()
    rest_shapes: collections.Counter = collections.Counter()

    def solve_path(label, problem):
        cuda_banded.reset_counters()
        t0 = time.monotonic()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            status = problem.solve(device="cuda")
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
        rest_shapes.update(shapes)
        [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
        backend = cached[-1]
        stats = problem.last_solve_stats
        print(f"{label}: {status}, {stats.iterations} iterations, {seconds:.2f} s "
              f"({seconds * 1e3 / max(stats.iterations, 1):.1f} ms/iteration), "
              f"{type(backend).__name__}"
              + (f" K={backend.K} w={backend.w}" if hasattr(backend, "K") else "")
              + f", host syncs {stats.host_syncs_per_iteration:.3f}/iteration, "
              f"launches {shapes}", flush=True)
        if status != ExitStatus.SUCCESS:
            fail("OCP layer", f"{label} ended {status}")
        return backend, shapes, stats

    # Per-step timesteps fold into the stage: m = 4, and stage 0 holds x₀
    # beside its dynamics rows, p = 4.
    per_step = double_integrator.min_time_problem(PER_STEP_N, TimestepMethod.VARIABLE)
    backend, shapes, stats = solve_path(
        f"minimum-time double integrator N={PER_STEP_N} (VARIABLE; the JAX package on a CPU: "
        f"{PER_STEP_JAX_ITERATIONS} iterations)", per_step)
    per_step_total = float(per_step.dt().value()[0, :PER_STEP_N].sum())
    print(f"  total time {per_step_total:.10f} s", flush=True)
    if not abs(per_step_total - 2.0) <= 2e-2:
        fail("OCP layer", f"per-step minimum time {per_step_total} s, not 2 s")
    if not shapes.get(("factor", 4, PER_STEP_N + 1, 8)):
        fail("OCP layer", f"per-step dt: no K1 launch at (4, {PER_STEP_N + 1}, 8): {shapes}")

    colloc = OCP(1, 1, COLLOCATION_T / COLLOCATION_N, COLLOCATION_N, lambda x, u: -x + u,
                 DynamicsType.EXPLICIT_ODE, TimestepMethod.FIXED,
                 TranscriptionMethod.DIRECT_COLLOCATION)
    colloc.constrain_initial_state(0.0)
    colloc.set_lower_input_bound(-12)
    colloc.set_upper_input_bound(12)
    colloc.minimize(((10.0 - colloc.X()) ** 2).sum())
    backend, shapes, stats = solve_path(f"direct collocation N={COLLOCATION_N}", colloc)
    cx, cu = colloc.X().value()[0], colloc.U().value()[0]
    h = COLLOCATION_T / COLLOCATION_N
    xdot0, xdot1 = -cx[:-1] + cu[:-1], -cx[1:] + cu[1:]
    xdot_c = -3.0 / (2.0 * h) * (cx[:-1] - cx[1:]) - 0.25 * (xdot0 + xdot1)
    x_c = 0.5 * (cx[:-1] + cx[1:]) + h / 8.0 * (xdot0 - xdot1)
    defect = float(np.abs(-x_c + 0.5 * (cu[:-1] + cu[1:]) - xdot_c).max())
    print(f"  x_0 {cx[0]:.3e}, x_N {cx[-1]:.6f}, max |u| {np.abs(cu).max():.12f}, "
          f"Hermite–Simpson defect {defect:.3e}", flush=True)
    if not (abs(cx[0]) <= 1e-8 and abs(cx[-1] - 10.0) <= 0.5
            and np.abs(cu).max() <= 12.0 + 1e-9 and defect <= 1e-8):
        fail("OCP layer", f"collocation: x_0 {cx[0]}, x_N {cx[-1]}, max |u| "
             f"{np.abs(cu).max()}, defect {defect}")
    if not any(k == "factor" and K == COLLOCATION_N + 1 for k, _b, K, _w in shapes):
        fail("OCP layer", f"collocation: no K1 launch at K={COLLOCATION_N + 1}: {shapes}")

    dd, DDX, DDU = differential_drive.differential_drive_problem(N=40, total_time=4.0)
    solve_path("differential drive N=40", dd)
    ddx, ddu = DDX.value(), DDU.value()
    dd_oracle = max(
        float(np.abs(ddx[:, k + 1] - rk4_numpy(
            lambda x, u: differential_drive.dynamics_numpy(x, u), ddx[:, k : k + 1],
            ddu[:, k : k + 1], 0.1).ravel()).max())
        for k in range(40)
    )
    print(f"  x_0 error {np.abs(ddx[:, 0]).max():.3e}, x_N error "
          f"{np.abs(ddx[:, 40] - [1.0, 1.0, 0.0, 0.0, 0.0]).max():.3e}, RK4 oracle {dd_oracle:.3e}",
          flush=True)
    if not (np.abs(ddx[:, 0]).max() <= 1e-8
            and np.abs(ddx[:, 40] - [1.0, 1.0, 0.0, 0.0, 0.0]).max() <= 1e-7
            and dd_oracle <= 1e-7):
        fail("OCP layer", "differential drive misses x_0, x_N or the RK4 oracle")

    di, DIX, DIU = double_integrator.double_integrator_problem(N=70, total_time=3.5)
    solve_path("double integrator N=70", di)
    dix, diu, dt_di = DIX.value(), DIU.value(), 3.5 / 70
    di_dyn = max(
        float(np.abs(dix[0, 1:] - (dix[0, :-1] + dix[1, :-1] * dt_di
                                   + 0.5 * diu[0, :70] * dt_di * dt_di)).max()),
        float(np.abs(dix[1, 1:] - (dix[1, :-1] + diu[0, :70] * dt_di)).max()),
    )
    print(f"  x_N {dix[:, 70]}, kinematics residual {di_dyn:.3e}", flush=True)
    if not (np.abs(dix[:, 70] - [2.0, 0.0]).max() <= 1e-8 and di_dyn <= 1e-8
            and np.abs(dix[1]).max() <= 1.0 + 1e-9 and np.abs(diu[0, :70]).max() <= 1.0 + 1e-9):
        fail("OCP layer", "double integrator misses x_N, the kinematics or a limit")

    shoot = OCP(1, 1, 0.1, 10, lambda x, u: -x + u, DynamicsType.EXPLICIT_ODE,
                TimestepMethod.FIXED, TranscriptionMethod.SINGLE_SHOOTING)
    shoot.set_lower_input_bound(-12)
    shoot.set_upper_input_bound(12)
    shoot.minimize(((10.0 - shoot.X()) ** 2).sum())
    backend, _shapes, _stats = solve_path("single shooting N=10", shoot)
    x_end = float(shoot.X().value(0, 10))
    print(f"  x(1 s) {x_end:.6f} against 12(1 − e⁻¹) = {12.0 * (1.0 - math.exp(-1.0)):.6f}",
          flush=True)
    if type(backend).__name__ != "DenseBackend" or not abs(
            x_end - 12.0 * (1.0 - math.exp(-1.0))) <= 0.2:
        fail("OCP layer", f"single shooting: {type(backend).__name__}, x(1 s) = {x_end}")
    print(f"OCP layer phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 12. the batched solve, multistart and the drivers ----------------
    t_phase = time.monotonic()
    from sleipnir_tpu_torch import (
        Gradient, Hessian, Jacobian, VariableMatrix, cos, exp, multistart, sin,
    )
    from sleipnir_tpu_torch.autodiff import expression as ex
    from sleipnir_tpu_torch.parallel import solve_ipm_batched

    lanes_problem, LX, LU = cart_pole_problem(N=N, total_time=TOTAL_TIME)
    lanes_comp = lanes_problem._compile()
    rng = np.random.default_rng(0)
    guesses = [0.01 * k * rng.standard_normal(lanes_comp["n"]) for k in range(LANES)]
    lanes_options = Options(device="cuda")
    lanes_syncs = lanes_problem.prepare_ipm(lanes_options)[1][-1].syncs
    syncs_before = lanes_syncs.count
    cuda_banded.reset_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lane_status, lane_costs, lane_xs, lane_final = solve_ipm_batched(
        lanes_problem, guesses, lanes_options)
    torch.cuda.synchronize()
    lanes_s = time.monotonic() - t0
    lanes_shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
    lanes_launches = {"factor": cuda_banded.FACTOR_LAUNCHES, "solve": cuda_banded.SOLVE_LAUNCHES}
    lanes_syncs_n = lanes_syncs.count - syncs_before
    lane_iterations = lane_final.iterations.tolist()
    # One ladder per batched iteration, all lanes in one K1 launch.
    batched_iterations = lanes_shapes.get(("factor", *LANE_FACTOR_SHAPE), 0)
    lane_checks = []
    for lane in range(LANES):
        ex._registry.set(lanes_comp["all_ids"], lane_xs[lane])
        Xv, Uv = LX.value(), LU.value()
        lane_checks.append((
            float(np.abs(Xv[:, N] - TARGET).max()),
            max(float(np.abs(Xv[:, k + 1] - rk4_numpy(
                dynamics_numpy, Xv[:, k : k + 1], Uv[:, k : k + 1], TOTAL_TIME / N).ravel()).max())
                for k in range(N)),
            abs(lane_costs[lane] / LANES_JAX_COST - 1.0),
        ))
    print(f"batched solve cart-pole N={N}, L={LANES}: statuses {lane_status.tolist()}, "
          f"iterations {lane_iterations} (the JAX package on a CPU: {LANES_JAX_ITERATIONS}), "
          f"{batched_iterations} batched iterations, {lanes_s:.2f} s "
          f"({lanes_s * 1e3 / max(batched_iterations, 1):.1f} ms/batched iteration), host syncs "
          f"{lanes_syncs_n} ({lanes_syncs_n / max(batched_iterations, 1):.3f}/batched iteration), "
          f"costs {[f'{c:.10f}' for c in lane_costs]} (JAX {LANES_JAX_COST}), final-state "
          f"errors {[f'{c[0]:.2e}' for c in lane_checks]}, RK4 oracle "
          f"{[f'{c[1]:.2e}' for c in lane_checks]}, launches {lanes_shapes}", flush=True)
    if lane_status.tolist() != [int(ExitStatus.SUCCESS)] * LANES:
        fail("batched solve", f"lanes ended {lane_status.tolist()}")
    for lane, (final_err, oracle_err, cost_rel) in enumerate(lane_checks):
        if not (final_err <= 1e-6 and oracle_err <= 1e-8 and cost_rel <= 1e-8):
            fail("batched solve", f"lane {lane}: final state {final_err:.3e}, RK4 oracle "
                 f"{oracle_err:.3e}, cost rel {cost_rel:.3e}")
    for key in (("factor", *LANE_FACTOR_SHAPE), ("solve", *LANE_SOLVE_SHAPE)):
        if not lanes_shapes.get(key):
            fail("batched solve", f"no launch at {key}: {lanes_shapes}")
    if any(k == "factor" and B not in (4 * LANES, LANES) for k, B, _K, _w in lanes_shapes):
        fail("batched solve", f"a ladder was factored per lane: {lanes_shapes}")

    bird = Problem()
    bx, by = bird.decision_variable(), bird.decision_variable()
    bird.minimize(sin(by) * exp((1 - cos(bx)) ** 2) + cos(bx) * exp((1 - sin(by)) ** 2)
                  + (bx - by) ** 2)
    bird.subject_to((bx + 5) ** 2 + (by + 5) ** 2 < 25)
    t0 = time.monotonic()
    best = multistart(bird, [np.asarray(g) for g in BIRD_GUESSES])
    bird_s = time.monotonic() - t0
    print(f"multistart Mishra's bird ({len(BIRD_GUESSES)} lanes, dense backend): {best.status}, "
          f"x {np.asarray(best.variables).tolist()}, cost {best.cost:.10f}, {bird_s:.2f} s",
          flush=True)
    if best.status != ExitStatus.SUCCESS or not np.abs(
            np.asarray(best.variables) - BIRD_MINIMUM).max() <= 1e-3:
        fail("batched solve", f"multistart gave {best}")

    dv = VariableMatrix(3)
    dv.set_value(np.array([[0.3], [-1.2], [2.5]]))
    dexpr = sin(dv[0, 0]) * dv[1, 0] ** 3 + exp(dv[2, 0] * dv[0, 0])
    dvec = VariableMatrix([[dv[0, 0] * dv[1, 0]], [cos(dv[2, 0])]])
    driver_errs = {}
    for name, make in (("Gradient", lambda d: Gradient(dexpr, dv, device=d)),
                       ("Jacobian", lambda d: Jacobian(dvec, dv, device=d)),
                       ("Hessian", lambda d: Hessian(dexpr, dv, device=d))):
        on_card, on_cpu = make("cuda").value(), make("cpu").value()
        driver_errs[name] = float(np.abs(on_card - on_cpu).max() / max(np.abs(on_cpu).max(), 1e-300))
    print(f"drivers on the card against the CPU (rel): {driver_errs}", flush=True)
    if not all(e <= 1e-12 for e in driver_errs.values()):
        fail("batched solve", f"drivers differ between the card and the CPU: {driver_errs}")
    print(f"batched solve phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- results ----------------------------------------------------------
    path_shapes = (collections.Counter(fly_shapes) + collections.Counter(fr_shapes)
                   + collections.Counter(sqp_shapes) + collections.Counter(mt_shapes)
                   + rest_shapes)
    fly_long = long[4, FLYWHEEL_N + 1, 4]

    def long_entry(kind, replaces):
        shapes = []
        for (B, K, w), e in long.items():
            shapes.append({
                "B": B if kind == "factor" else 1, "K": K, "w": w,
                "system": e["system"], "max_abs_err": e[f"{kind}_max_abs_err"],
                "rel_err": e[f"{kind}_rel_err"], "inertia_equal": e["inertia_equal"],
                "perm_equal": e["perm_equal"],
                "ms": e[f"{kind}_ms"], "us_per_stage": 1e3 * e[f"{kind}_ms"] / K,
                "plain_ms": e[f"{kind}_plain_ms"],
                "bound_ms": e[f"{kind}_bound_ms"], "bound_by": e[f"{kind}_bound_by"],
            })
        if kind == "solve":
            # The border's batched right-hand sides; (4, 5001, 4, 1) is the
            # minimum-time flywheel's T⁻¹·col.
            shapes += list(border.values())
        return {
            "name": f"banded_{kind}_long",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": replaces,
            "launches": sum(long_launches(path_shapes, kind).values()),
            "launches_by_shape": long_launches(path_shapes, kind),
            # At the flywheel path's shape (factor B=4, solve B=1, K=5001, w=4);
            # every long shape is listed under "shapes".
            "max_abs_err": fly_long[f"{kind}_max_abs_err"],
            "ms": fly_long[f"{kind}_ms"],
            "us_per_stage": 1e3 * fly_long[f"{kind}_ms"] / (FLYWHEEL_N + 1),
            "plain_ms": fly_long[f"{kind}_plain_ms"],
            "bound_ms": fly_long[f"{kind}_bound_ms"],
            "bound_by": fly_long[f"{kind}_bound_by"],
            "library_ms": None,
            "shapes": shapes,
            **({"ms_B1": fly_long["factor_b1_ms"]} if kind == "factor" else {}),
        }

    kernels = [
        {
            "name": "banded_factor",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": "sleipnir_tpu/ops/pallas_banded.py:360",
            "launches": launches["factor"],
            "max_abs_err": err_factor,
            "ms": times["factor"],
            "us_per_stage": 1e3 * times["factor"] / (N + 1),
            "plain_ms": times["factor_plain"],
            **dict(zip(("bound_ms", "bound_by"), factor_bound(4, N + 1, 13))),
            "library_ms": None,
            # The batched solve's shape (phase 12): its launches there.
            "lanes": {**lane_kernels["factor"],
                      "launches": lanes_shapes.get(("factor", *LANE_FACTOR_SHAPE), 0)},
        },
        {
            "name": "banded_solve",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": "sleipnir_tpu/ops/pallas_banded.py:421",
            "launches": launches["solve"],
            "max_abs_err": err_solve,
            "ms": times["solve"],
            "us_per_stage": 1e3 * times["solve"] / (N + 1),
            "plain_ms": times["solve_plain"],
            **dict(zip(("bound_ms", "bound_by"), solve_bound(1, N + 1, 13))),
            "library_ms": None,
            "lanes": {**lane_kernels["solve"],
                      "launches": lanes_shapes.get(("solve", *LANE_SOLVE_SHAPE), 0)},
        },
        long_entry("factor", "sleipnir_tpu/ops/pallas_banded.py:633"),
        long_entry("solve", "sleipnir_tpu/ops/pallas_banded.py:680"),
        {
            "name": "dd_probe",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/dd_probe.cu",
            "replaces": "tools/pallas_dd_probe.py:22",
            "launches": probe_launches,
            "max_abs_err": probe["max_abs_diff"],
            "bitwise_equal": probe["bitwise_equal"],
            "tf32_single_pass_max_err": probe["tf32_single_pass_max_err"],
            "ms": probe_ms,
            "device_ms": probe_device_ms,
            "targets_met": targets,
            "us_per_stage": None,  # no stages
            "plain_ms": probe_plain_ms,
            "bound_ms": probe_bound[0],
            "bound_by": probe_bound[1],
            # No single call computes all six; the one-hot product's
            # torch.matmul time is under "parts".
            "library_ms": None,
            "parts": probe_parts,
        },
    ]
    for entry in kernels[2:4]:
        if entry["launches"] == 0:
            fail("results", f"{entry['name']} was never launched at a long-horizon shape")
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
