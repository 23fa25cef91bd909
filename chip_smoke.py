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
     kernels must have been launched by the solve; then a second problem
     built the same way, timed in the warm process, with the same result;
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
just before each path (phases 4-12) and read just after it.

 13. graphs: cart-pole N=100, the flywheel at N=5000, restoration at
     N=2000, the minimum-time flywheel at N=5000 (40 iterations), the
     8 lanes and the float32 flywheel at N=60 (200 iterations) again,
     every graphed problem evaluation held against its eager function on
     the same inputs, bit for bit, with the iterations of the unchecked
     runs; then a model-predictive re-solve of the flywheel at N=5000
     with new parameters, which must capture nothing and equal a fresh
     problem's solve bit for bit;
 14. float32 (`Options(dtype="float32")`), each path with the launch
     counts at 0 just before it, no float64 kernel launch and no float64
     tensor in any graphed call: the three scalar problems of the JAX
     package's test_dtype_axis.py (Newton, SQP, the dense IPM) to 1e-4;
     the flywheel at N=60 to 1e-2 (SUCCESS, x_N within 5 of 10) and at
     N=1000 (feasibility restoration fails, as in the JAX package, after
     running its banded system on the float32 kernels);
     4 lanes of the flywheel at N=60 by `solve_ipm_batched`; a cached
     float64 problem re-solved in float32 (new captures, equal to a fresh
     float32 problem bit for bit); then K1/K2 in float32 against the
     float32 twin at every float32 shape the paths launched, at the
     flywheel's N=5000 shapes (2 and 1, 5001, 4 and 12), at (2, 40, 37)
     and at the width edges (inertia and pivots equal, solutions to
     1e-4 relative on well-conditioned stages), each path shape timed
     beside the float64 kernels at the same shape and its bound at 4-byte
     words. Every status is printed beside the JAX package's, with its
     iterations.
 15. examples: every program of `sleipnir_tpu_torch/examples` at its
     published size (the flywheel OCP at N=100 on the banded backend,
     with K1 at (4, 101, 4) and K2 at (1, 101, 4); on the dense backend
     the current manager, the flywheel by direct transcription at N=100,
     the multi-tag pose, the FRC 2022 shooter at N=30, the FRC 2024
     shooter at N=10 and G-FOLD at N=25), each held to the JAX
     package's exit status and values on a CPU (`EXAMPLES_JAX`; G-FOLD to
     its class, infeasible), then one point of each scalability sweep of
     `sleipnir_tpu_torch.tools.scalability` (flywheel N=1000, cart-pole
     N=100), which must reach SUCCESS and write the reference schema.

 16. the partitioned factor and the time axis: the partitioned factor and
     solve on K1/K2 (`banded_factor_part`, `banded_solve_part`) against
     the partitioned twin on the same tensors and against K1/K2's chain,
     inertia exactly and solutions to 1e-10, at (4, 5001, 4),
     (4, 5001, 13), (4, 2001, 37) and (1, 256, 13), with K2 over the
     condensation columns (r = 2w), each timed beside the chain; the
     crossover of the two at K = 101…5001 and w = 4, 13, 37 (B=4); then
     the JAX package's multi-device dry run (__graft_entry__.py:65-252)
     on a mesh of every card, or of 4 shards of the one card: cart-pole
     N=24 from one guess per shard by `solve_ipm_batched(mesh=)`, one
     thread per shard, every lane SUCCESS; the flywheel at N = 8·shards
     through `set_time_axis_mesh`, SUCCESS and within 1e-6 of the
     unsharded solve; and the sharded factor and solve at K=2048, w=13
     against the unsharded one to 1e-8 with equal inertia, timed per
     shard count.
 17. the opt-in factor forms and cart-pole's DSL dynamics: cart-pole at
     N=100 with `fast=False` (the DSL dynamics), which must take the dense
     backend with the JAX package's warning, reach SUCCESS, the target
     state and the RK4 oracle; block cyclic reduction (its coarsest two
     blocks on K1/K2) and the explicit-inverse partitioned factor against
     K1/K2's chain at (4, 101, 13), (4, 5001, 4), (4, 5001, 13) and
     (4, 2001, 37), B=1 solves, inertia exactly and solutions to 1e-10
     and 1e-9, the inverse's residual on the interior-point-like chain
     printed beside the chain's, both forms timed beside the partitioned
     one over the crossover's shapes; then the flywheel at N=5000 under
     SLEIPNIR_TPU_BCR=1 and under SLEIPNIR_TPU_INV=1, each a fresh
     problem: SUCCESS, the JAX package's iterations within 2, the oracle
     with only the JAX package's misses (BCR misses the steady-state
     voltage at three steps there too), and the factor in that form only.

From K = 256 stages the banded backend takes the partitioned form on the
card, so the long paths of phases 6, 7, 8, 10, 11 (N=1000 and
collocation) and 14 (N=1000) are checked for it: the partitioned calls at
the path's (B, K, w), K1 at the parts' interiors (B·P, L-1, w), and no
chain of K stages. Phase 3 still holds K1/K2's chain at the long shapes.

Phases 4-12 print each path's iterations and time per iteration beside
the figures from before the problem evaluations ran as CUDA graphs,
and the graphs' captures, replays and capture seconds and the peak device
memory. Phase 9 also solves the README example with diagnostics=True and
spy=True and parses the .spy files it writes (under build/spy). The last
two lines of output are a JSON object of per-kernel results and a JSON
object naming the device.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import pathlib
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
#: Each path's figures on the card before its problem evaluations ran as
#: CUDA graphs (PERF.md §5-6; NVIDIA H100 80GB HBM3, 700 W).
EARLIER = {
    "cart-pole": "215 iterations, 110.3 s, 513.0 ms/iteration",
    "flywheel": "18 iterations, 77.3 ms/iteration",
    "restoration": "resume after 2 iterations, 1563.1 ms/iteration (phase_probe)",
    "banded SQP": "14 iterations, 45.8-51.6 ms/iteration (phase_probe)",
    "README": "3 iterations",
    "dense flywheel": "21 iterations, 510.7-720.1 ms/iteration (phase_probe)",
    "minimum time": "1,422 iterations, 104.5 ms/iteration",
    "per-step": "490 iterations",
    "collocation": "20 iterations, 149-194 ms/iteration",
    "lanes": "[42, 42, 40, 37, 38, 41, 46, 42], 46 batched iterations, "
             "593.1 ms/batched iteration",
}
#: The paths whose problem evaluations phase 13 holds, graphed against
#: eager, and the iterations it runs of each (None: to the end). The
#: minimum-time flywheel takes 1,422 iterations at N=5000; 40 of them
#: reach every graphed function it has at the path's shapes. The float32
#: flywheel at N=60 (phase 14) takes over a thousand; 200 of them reach
#: its graphed functions in float32.
GRAPH_PATHS = {"cart-pole": None, "flywheel": None, "restoration": None,
               "minimum time": 40, "lanes": None, "float32 flywheel": 200}
#: The float32 solve (phase 14; `Options(dtype="float32")`), each path held
#: to what the JAX package's float32 path gives on a CPU (`f32_reference.py`,
#: PERF.md §6): the scalar problems of tests/optimization/test_dtype_axis.py
#: (name: JAX iterations) to 1e-4 with their atol 1e-2, and the flywheel at
#: N=60 and 1000 to 1e-2 (N: JAX status and iterations). The flywheel's
#: float32 path runs at N=1000, not at N=5000, where its last restoration
#: runs to the 5,000-iteration cap (484 s, as the JAX package's does;
#: PERF.md §5) and would take the script past its time; K1/K2 in float32
#: at the N=5000 path's shapes, `F32_LONG_SHAPES` (B, K, w), stay held
#: against the float32 twin and timed.
F32_N = 60
F32_SCALAR_JAX_ITERATIONS = {"Newton": 1, "SQP": 1, "IPM": 5}
F32_FLYWHEEL_JAX = {60: ("SUCCESS", 1404), 1000: ("FEASIBILITY_RESTORATION_FAILED", 577)}
F32_LONG_SHAPES = [(2, 5001, 4), (1, 5001, 4), (2, 5001, 12), (1, 5001, 12)]
#: 4 lanes of the flywheel at N=60 in float32 from 0.01·k·randn(n) (seed
#: 0): the JAX package's `solve_ipm_batched` statuses and iterations. Every
#: lane ends asking for restoration (status 101), which a lane of the
#: batch does not run, as in the JAX package.
F32_LANES = 4
F32_LANES_JAX = ([101] * F32_LANES, [1395, 1753, 959, 1596])
#: The float32 kernels against the float32 twin, unrefined, on
#: well-conditioned stages (|λ| in [20, 40]): float32 eps is 1.2e-7, and
#: two orders of operations part by a few hundred ulps over thousands of
#: stages at most.
F32_REL_TOL = 1e-4
#: Stage rows K·w above which the TPU package takes its chunked kernels:
#: ⌈K·w/8⌉·4096 bytes over its 3.5 MB single-shot budget
#: (sleipnir_tpu/ops/pallas_banded.py:471, :491-493).
TPU_CHUNKED_ROWS = 6833
#: The examples (phase 15, `sleipnir_tpu_torch/examples/`) at their
#: published sizes, and what the JAX package's examples (`examples/`) give
#: on a CPU: exit status and values, held to 1e-6 relative or 1e-8
#: absolute (the current manager to 1e-3, the tolerance of its own test,
#: tests/examples/test_current_manager.py). For the flywheels the values
#: are x_N and Σ(10 − x)²; for the multi-tag pose x, y and θ; for the
#: shooters the initial velocity, pitch and yaw. G-FOLD at N=25 is
#: infeasible: the JAX package ends LOCALLY_INFEASIBLE, and the port ends
#: LOCALLY_INFEASIBLE or FEASIBILITY_RESTORATION_FAILED as its sums round
#: (tests/test_torch_examples_gfold.py); its fuel cost is inf.
EXAMPLES_JAX = {
    "current_manager": ("SUCCESS", [24.999993743536887, 9.999843589172132, 4.9993743616880675,
                                    0.00023539378046597118, 29.960317461578096, 9.007936509192517,
                                    1.0317459596198384, 3.708624889530717e-08]),
    "flywheel_ocp": ("SUCCESS", [9.999999988322378, 794.340721534629]),
    "flywheel_direct_transcription": ("SUCCESS", [9.99999998737953, 794.3407215346294]),
    "constrained_multitag": ("SUCCESS", [0.0007749818980796211, 5.413759757799949e-13,
                                         -2.703206537120687e-13]),
    "frc_2022_shooter": ("SUCCESS", [8.110883865376167, 0.6512092807372257, 0.6815197090288613]),
    "frc_2024_shooter": ("NONFINITE_INITIAL_GUESS",
                         [14.999999999999998, 0.1375467297967536, 2.909860051922712]),
    "g_fold": ("LOCALLY_INFEASIBLE", [math.inf]),
}
EXAMPLE_TOL = {"rtol": 1e-6, "atol": 1e-8}
#: The flywheel OCP example's K1 and K2 shapes (stage width 4, N=100).
EXAMPLE_OCP_SHAPES = {("factor", 4, 101, 4), ("solve", 1, 101, 4)}
#: One point of each sweep of `sleipnir_tpu_torch.tools.scalability`.
SWEEP_POINTS = {"flywheel": 1000, "cart_pole": 100}
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


def factor_bound(B, K, w, word=8, rate=F64_PER_S):
    """K1's function: per stage an LU (2w³/3) and an LDLᵀ (w³/3) of S_k,
    X_k = S_k⁻¹E_kᵀ (2w³) and S_{k+1} = D_{k+1} − E_k X_k (2w³), in
    words of `word` bytes at `rate` operations per second (f64 by
    default); D and E read once, LU, X, d and perm (i32) written once."""
    ops = B * K * 5.0 * w**3
    nbytes = word * B * ((2 * K - 1) * w * w * 2 + K * w) + 4 * B * K * w
    return bound(ops, rate, nbytes)


def solve_bound(B, K, w, r=1, word=8, rate=F64_PER_S):
    """K2's function: per stage and right-hand side Xₖᵀy, the LU solve and
    X x (6w² operations); LU, X, perm and b read once, x written once."""
    ops = B * K * r * 6.0 * w * w
    nbytes = word * B * ((2 * K - 1) * w * w + 2 * K * w * r) + 4 * B * K * w
    return bound(ops, rate, nbytes)


def long_launches(shape_counts, kind):
    """Launches of `kind` at shapes where the TPU takes its chunked kernels."""
    return {
        f"B={B},K={K},w={w}": n for (k, B, K, w), n in shape_counts.items()
        if k == kind and K * w >= TPU_CHUNKED_ROWS
    }


def path_counts():
    """What a path launched since the counters were reset: K1/K2 launches
    by shape, the partitioned factor's and solve's calls by the outer
    system's shape, and the launches those calls made."""
    from sleipnir_tpu_torch.ops import cuda_banded

    return (dict(cuda_banded.LAUNCHES_BY_SHAPE), dict(cuda_banded.PARTITIONED_BY_SHAPE),
            dict(cuda_banded.PARTITIONED_LAUNCHES))


def check_partitioned(phase, launches, part, factor_key, solve_keys):
    """A path at K ≥ 256 stages on the card: its factor at factor_key =
    (kind, B, K, w) and its solves at solve_keys took the partitioned
    form, K1 ran the parts' interiors at (B·P, L-1, w), and no chain of K
    stages was launched."""
    from sleipnir_tpu_torch.ops.block_tridiag import choose_partitions

    kind, B, K, w = factor_key
    P, L = choose_partitions(K)
    for key in (factor_key, *solve_keys):
        if not part.get(key):
            fail(phase, f"no partitioned call at {key}: {part}")
    if not launches.get((kind, B * P, L - 1, w)):
        fail(phase, f"no K1 launch at the interiors' shape {(kind, B * P, L - 1, w)}: {launches}")
    if any(k == K for _kind, _b, k, _w in launches):
        fail(phase, f"a chain of {K} stages was launched: {launches}")


_MEMORY_AT_RESET = [0]


def reset_graph_counts() -> None:
    """Zero the CUDA graphs' counters and the peak-memory statistic before
    a path."""
    from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

    cuda_graph.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    _MEMORY_AT_RESET[0] = torch.cuda.memory_allocated()


def graph_note() -> str:
    """The CUDA graphs' counts since `reset_graph_counts`, and the peak
    device memory over what was allocated then (earlier paths' problems
    stay allocated)."""
    from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

    peak = torch.cuda.max_memory_allocated() - _MEMORY_AT_RESET[0]
    return (f"graphs {cuda_graph.CAPTURES} captures ({cuda_graph.CAPTURE_SECONDS:.2f} s), "
            f"{cuda_graph.REPLAYS} replays, peak memory {peak / 2**20:.0f} MiB above the "
            f"path's start")


def read_spy(path):
    """A .spy file (reference util/spy.hpp:20-44): (title, row label,
    column label, rows, cols, frames), each frame a list of (row, col,
    sign)."""
    import struct

    with open(path, "rb") as f:
        def text():
            (size,) = struct.unpack("<i", f.read(4))
            return f.read(size).decode("utf-8")

        title, row_label, col_label = text(), text(), text()
        rows, cols = struct.unpack("<ii", f.read(8))
        frames = []
        while head := f.read(4):
            (count,) = struct.unpack("<i", head)
            frames.append([struct.unpack("<ii", f.read(8)) + (f.read(1).decode(),)
                           for _ in range(count)])
    return title, row_label, col_label, rows, cols, frames


class GraphCheck:
    """While active, holds every graphed problem evaluation against its
    eager function on the same inputs, bit for bit: a call that captures
    a graph (and returns the eager warm-up) is replayed at once on the
    same inputs, and the first `replays` replays of each function are run
    eagerly beside it. Records per function the calls held, the bitwise
    equal ones and the largest relative difference, and the first
    difference seen (function, call, output leaf)."""

    def __init__(self, replays: int = 2) -> None:
        self.replays = replays
        self.held: collections.Counter = collections.Counter()
        self.equal: collections.Counter = collections.Counter()
        self.max_rel: dict = collections.defaultdict(float)
        self.first_diff = None

    def compare(self, name: str, graphed, eager) -> None:
        from torch.utils import _pytree as pytree

        a_leaves, b_leaves = pytree.tree_leaves(graphed), pytree.tree_leaves(eager)
        self.held[name] += 1
        same = len(a_leaves) == len(b_leaves)
        for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
            if not isinstance(a, torch.Tensor):
                leaf_same = a == b
            elif a.shape != b.shape or a.dtype != b.dtype:
                leaf_same = False
            else:
                eq = a == b
                if a.is_floating_point():
                    eq = eq | (torch.isnan(a) & torch.isnan(b))
                    diff = torch.where(eq, 0.0, (a - b).abs()).max() if a.numel() else 0.0
                    scale = b[torch.isfinite(b)].abs().max() if a.numel() else 0.0
                    rel = float(diff / scale) if float(scale) > 0 else float(diff)
                    self.max_rel[name] = max(self.max_rel[name], rel)
                leaf_same = bool(eq.all())
            if not leaf_same and self.first_diff is None:
                self.first_diff = (name, self.held[name], i)
            same = same and leaf_same
        self.equal[name] += int(same)

    def __enter__(self) -> "GraphCheck":
        from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

        self._graphed = cuda_graph.Graphed
        self._call = call = cuda_graph.Graphed.__call__
        check = self

        def checked(graphed, *args):
            before = len(graphed._entries)
            out = call(graphed, *args)
            if len(graphed._entries) > before:  # captured: `out` ran eagerly
                check.compare(graphed.name, call(graphed, *args), out)
            elif check.held[graphed.name] < check.replays + 1:
                check.compare(graphed.name, out, graphed.eager(*args))
            return out

        cuda_graph.Graphed.__call__ = checked
        return self

    def __exit__(self, *exc) -> None:
        self._graphed.__call__ = self._call

    def summary(self) -> dict:
        return {name: (self.equal[name], n, self.max_rel[name]) for name, n in self.held.items()}


class DtypeTally:
    """While active, records the floating dtypes of every graphed call's
    arguments and results, and the calls that captured: a float32 solve
    must hand its graphs no float64 tensor, and a float32 re-solve of a
    problem solved in float64 before must capture its own graphs."""

    def __init__(self) -> None:
        self.dtypes: collections.Counter = collections.Counter()
        self.float64_calls: collections.Counter = collections.Counter()
        self.captures: collections.Counter = collections.Counter()

    def __enter__(self) -> "DtypeTally":
        from torch.utils import _pytree as pytree

        from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

        self._graphed = cuda_graph.Graphed
        self._call = call = cuda_graph.Graphed.__call__
        tally = self

        def tallied(graphed, *args):
            before = len(graphed._entries)
            out = call(graphed, *args)
            seen = {t.dtype for t in pytree.tree_leaves((args, out))
                    if isinstance(t, torch.Tensor) and t.is_floating_point()}
            tally.dtypes.update(seen)
            tally.float64_calls[graphed.name] += int(torch.float64 in seen)
            tally.captures[graphed.name] += len(graphed._entries) - before
            return out

        cuda_graph.Graphed.__call__ = tallied
        return self

    def __exit__(self, *exc) -> None:
        self._graphed.__call__ = self._call


def examples_phase() -> dict:
    """Phase 15: every example of `sleipnir_tpu_torch/examples` at its
    published size on the card, held to the JAX package's results; the
    flywheel OCP's K1/K2 launches by shape, with the counts at 0 just
    before it; then one point of each scalability sweep. Returns the OCP
    example's launches by shape."""
    from sleipnir_tpu_torch import ExitStatus
    from sleipnir_tpu_torch.examples import (
        constrained_multitag,
        current_manager,
        flywheel_direct_transcription,
        flywheel_ocp,
        frc_2022_shooter,
        frc_2024_shooter,
        g_fold,
    )
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.problem import Problem
    from sleipnir_tpu_torch.tools import scalability

    solved = []  # (Problem, status, iterations) of every solve an example runs
    solve = Problem.solve

    def recording(self, *args, **kwargs):
        status = solve(self, *args, **kwargs)
        solved.append((self, status, self.last_solve_stats.iterations))
        return status

    def backends():
        names = {type(entry[-1]).__name__ for p, _, _ in solved for key, entry in
                 p._solver_cache.items() if key[0] in ("ipm", "sqp", "newton")}
        return "/".join(sorted(names)) or "none (no solve ran)"

    def flywheel_values(X):
        Xv = X.value()
        return [float(Xv[0, -1]), float(((10.0 - Xv) ** 2).sum())]

    def manager():
        # `calculate` returns the currents only: the status is the first
        # of its two solves that did not succeed, else SUCCESS.
        m = current_manager.CurrentManager([1.0, 5.0, 10.0, 5.0], 40.0)
        values = m.calculate([25.0, 10.0, 5.0, 0.0]) + m.calculate([30.0, 10.0, 5.0, 0.0])
        status = next((st for _, st, _ in solved if st != ExitStatus.SUCCESS), ExitStatus.SUCCESS)
        return status, values

    def fly_ocp():
        status, ocp = flywheel_ocp.main(verbose=False)
        return status, flywheel_values(ocp.X())

    def fly_dt():
        status, X, _U = flywheel_direct_transcription.main(verbose=False)
        return status, flywheel_values(X)

    def values_of(main):
        def run():
            status, *values = main(verbose=False)
            return status, [float(v) for v in values]
        return run

    def gfold():
        status, cost = g_fold.main(N=25, verbose=False)
        return status, [cost]

    runs = {
        "current_manager": manager, "flywheel_ocp": fly_ocp,
        "flywheel_direct_transcription": fly_dt,
        "constrained_multitag": values_of(constrained_multitag.main),
        "frc_2022_shooter": values_of(frc_2022_shooter.main),
        "frc_2024_shooter": values_of(frc_2024_shooter.main), "g_fold": gfold,
    }
    ocp_shapes: dict = {}
    Problem.solve = recording
    try:
        for name, run in runs.items():
            expected_status, expected = EXAMPLES_JAX[name]
            solved.clear()
            cuda_banded.reset_counters()
            reset_graph_counts()
            t0 = time.monotonic()
            status, values = run()
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            shapes = dict(cuda_banded.LAUNCHES_BY_SHAPE)
            iterations = [n for _, _, n in solved]
            print(f"example {name}: {status} (JAX {expected_status}), values {values} (JAX "
                  f"{expected}), {seconds:.2f} s, iterations {iterations}, backend "
                  f"{backends()}, kernel launches {shapes}, {graph_note()}", flush=True)
            if name == "g_fold":
                infeasible = {ExitStatus.LOCALLY_INFEASIBLE,
                              ExitStatus.FEASIBILITY_RESTORATION_FAILED}
                if status not in infeasible or values != expected:
                    fail("examples", f"g_fold ended {status} with cost {values}; the JAX "
                         f"package ends {expected_status} with cost inf")
                continue
            if status != ExitStatus[expected_status]:
                fail("examples", f"{name} ended {status}; the JAX package's ends "
                     f"{expected_status}")
            tol = {"rtol": 0.0, "atol": 1e-3} if name == "current_manager" else EXAMPLE_TOL
            if not np.allclose(values, expected, **tol):
                fail("examples", f"{name}: {values} differ from the JAX package's {expected} "
                     f"beyond {tol}")
            if name == "flywheel_ocp":
                ocp_shapes = shapes
                missing = [s for s in EXAMPLE_OCP_SHAPES if not shapes.get(s)]
                if missing:
                    fail("examples", f"flywheel_ocp launched no kernel at {missing}: {shapes}")
    finally:
        Problem.solve = solve

    out_dir = pathlib.Path(__file__).resolve().parent / "build"
    for name, n in SWEEP_POINTS.items():
        out = out_dir / f"{name}-scalability-smoke.csv"
        [sample] = scalability.main([name, "--samples", str(n), "--out", str(out)])
        rows = scalability.read_csv(out)
        if sample.status != ExitStatus.SUCCESS or [r[0] for r in rows] != [n]:
            fail("examples", f"scalability {name} N={n}: {sample.status}, file rows {rows}")
    return ocp_shapes


#: Phase 16: the partitioned factor and solve on K1/K2 against the
#: partitioned twin on the same tensors and against K1/K2's chain, at the
#: long paths' shapes (B, K, w, system): the flywheel at N=5000 (w=4),
#: cart-pole at N=5000 (w=13), its restoration system at N=2000 (w=37,
#: well-conditioned stages, as in phase 3) and the threshold, K=256.
PART_CASES = [(4, 5001, 4, "random"), (4, 5001, 13, "random"),
              (4, 2001, 37, "conditioned"), (1, 256, 13, "random")]
#: The crossover grid: K1's chain against the partitioned factor at B=4,
#: and the solves at B=1, as the paths call them.
CROSSOVER_K = (101, 256, 512, 1001, 2001, 5001)
CROSSOVER_W = (4, 13, 37)
#: The multi-device dry run of the JAX package (__graft_entry__.py:65-252):
#: its mesh is every card when there are several, else this many shards
#: of the one card; the batch is cart-pole at N=24 with one guess per
#: shard, the time axis the flywheel at N = 8 · shards, and the sharded
#: factor and solve a K=2048, w=13 system.
DRYRUN_SHARDS = 4
DRYRUN_LANES_N = 24
SHARDED_K, SHARDED_W = 2048, 13
#: Phase 17, the opt-in factor forms: block cyclic reduction and the
#: explicit-inverse partitioned factor against K1/K2's chain at these
#: (K, w), B=4 factors and B=1 solves on well-conditioned stages, to the
#: bounds of the JAX package's own tests (tests/solver/
#: test_block_tridiag.py:143-151, tests/solver/test_inverse_blocks.py).
VARIANT_SHAPES = [(101, 13), (5001, 4), (5001, 13), (2001, 37)]
BCR_REL_TOL, INV_REL_TOL = 1e-10, 1e-9
#: The environment variable of each opt-in form.
VARIANT_VARIABLES = {"bcr": "SLEIPNIR_TPU_BCR", "inv": "SLEIPNIR_TPU_INV"}
#: What the JAX package's flywheel IPM at N=5000 gives under each variable
#: on a CPU (tests/test_torch_factor_variants_long.py): SUCCESS in these
#: iterations (18 by default), and the steps k at which the numpy oracle's
#: steady-state voltage check misses, with u_k there. BCR misses three.
VARIANT_FLYWHEEL_JAX = {
    "bcr": (24, {1792: 10.04780696798847, 1793: 9.963707644454892, 1794: 10.016436001255093}),
    "inv": (18, {}),
}


def mesh_ms(fn, devices, reps: int = 5) -> float:
    """Host time of one call (ms, mean of `reps` after one warm call) with
    every device of the mesh synchronized around it."""
    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def partitioned_phase() -> dict:
    """Phase 16: (a) the partitioned factor on the card, (b) the crossover
    against K1's chain, (c) the JAX package's multi-device dry run on the
    port's meshes. Returns {"shapes", "crossover", "time_axis"}."""
    return {"shapes": partitioned_kernels(), "crossover": crossover(), "time_axis": dry_run()}


_SYSTEMS = {"random": lambda rng, B, K, w: random_system(rng, B, K, w, 0),
            "conditioned": conditioned_system}


def _on_card(*arrays):
    return (torch.tensor(a, dtype=torch.float64, device="cuda") for a in arrays)


def partitioned_kernels() -> dict:
    """Phase 16 (a): the partitioned factor and solve on K1/K2 against the
    partitioned twin and K1/K2's chain at PART_CASES; entries by (B, K, w)."""
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import take
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA

    dev = torch.device("cuda")
    systems, on_card = _SYSTEMS, _on_card
    shapes = {}
    for B, K, w, system in PART_CASES:
        Dg, Eg, bg = on_card(*systems[system](np.random.default_rng(B * K + w + 16), B, K, w))
        P, L = plain.choose_partitions(K)
        cuda_banded.reset_counters()
        fk = cuda_banded.banded_factor_part(Dg, Eg)
        xk = cuda_banded.banded_solve_part(fk, bg)
        torch.cuda.synchronize()
        launches = {",".join(map(str, k)): n for k, n in cuda_banded.LAUNCHES_BY_SHAPE.items()}
        fp = plain.block_tridiag_factor_part(Dg, Eg)
        xp = plain.block_tridiag_solve_part(fp, bg)
        xf = plain.block_tridiag_solve_part(fk, bg)  # the kernels' factor alone
        xs = cuda_banded.banded_solve_part(fp, bg)  # the kernels' solve alone
        fc = cuda_banded.banded_factor(Dg, Eg)
        xc = cuda_banded.banded_solve(fc, bg)
        torch.cuda.synchronize()
        inertia = {name: [t.tolist() for t in counts] for name, counts in (
            ("kernels", plain.part_inertia(fk, EPS_INERTIA, K)),
            ("twin", plain.part_inertia(fp, EPS_INERTIA, K)),
            ("chain", plain.block_tridiag_inertia(fc, EPS_INERTIA)))}
        f1, fc1, b1 = take(fk, 0), take(fc, 0), bg[:1].contiguous()
        # K2 over the condensation columns: (B·P, L-1, w) with r = 2w.
        interior = plain.BlockTridiagFactor(*(t.reshape(B * P, *t.shape[2:]) for t in fk.interior))
        cols = torch.randn(B * P, L - 1, w, 2 * w, dtype=torch.float64, device=dev)
        cols_x = cuda_banded.banded_solve(interior, cols)
        cols_rel = rel_diff(cols_x, plain.block_tridiag_solve(interior, cols))
        entry = {
            "system": system, "P": P, "L": L,
            "rel_err": rel_diff(xk, xp), "factor_rel_err": rel_diff(xf, xp),
            "solve_rel_err": rel_diff(xs, xp), "chain_rel_err": rel_diff(xk, xc),
            "factor_max_abs_err": (xf - xp).abs().max().item(),
            "solve_max_abs_err": (xs - xp).abs().max().item(),
            "cols_rel_err": cols_rel,
            "inertia": inertia["kernels"],
            "inertia_equal": inertia["kernels"] == inertia["twin"] == inertia["chain"],
            "launches": launches,
            "factor_ms": cuda_ms(lambda: cuda_banded.banded_factor_part(Dg, Eg), 10),
            "factor_chain_ms": cuda_ms(lambda: cuda_banded.banded_factor(Dg, Eg), 2),
            "factor_plain_ms": cuda_ms(lambda: plain.block_tridiag_factor_part(Dg, Eg), 1),
            "solve_ms": cuda_ms(lambda: cuda_banded.banded_solve_part(f1, b1), 10),
            "solve_chain_ms": cuda_ms(lambda: cuda_banded.banded_solve(fc1, b1), 3),
            "solve_plain_ms": cuda_ms(lambda: plain.block_tridiag_solve_part(f1, b1), 1),
            "cols_ms": cuda_ms(lambda: cuda_banded.banded_solve(interior, cols), 10),
        }
        entry["factor_bound_ms"], entry["factor_bound_by"] = factor_bound(B, K, w)
        entry["solve_bound_ms"], entry["solve_bound_by"] = solve_bound(1, K, w)
        entry["cols_bound_ms"], entry["cols_bound_by"] = solve_bound(B * P, L - 1, w, 2 * w)
        shapes[B, K, w] = entry
        print(f"partitioned (B={B}, K={K}, w={w}, {system}; P={P} parts of L={L}): inertia "
              f"{inertia['kernels']} (twin {inertia['twin']}, chain {inertia['chain']}), rel diff "
              f"from the twin {entry['rel_err']:.3e} (factor alone {entry['factor_rel_err']:.3e}, "
              f"solve alone {entry['solve_rel_err']:.3e}), from the chain "
              f"{entry['chain_rel_err']:.3e}; factor {entry['factor_ms']:.3f} ms (chain "
              f"{entry['factor_chain_ms']:.3f}, twin {entry['factor_plain_ms']:.1f}, bound "
              f"{entry['factor_bound_ms']:.5f}), solve {entry['solve_ms']:.3f} ms (chain "
              f"{entry['solve_chain_ms']:.3f}, twin {entry['solve_plain_ms']:.1f}), K2 at "
              f"({B * P}, {L - 1}, {w}, r={2 * w}) {entry['cols_ms']:.3f} ms (rel diff "
              f"{cols_rel:.3e}, bound {entry['cols_bound_ms']:.5f}); launches {launches}",
              flush=True)
        if not entry["inertia_equal"]:
            fail("partitioned", f"{(B, K, w)}: inertia {inertia}")
        for key in ("rel_err", "factor_rel_err", "solve_rel_err", "chain_rel_err", "cols_rel_err"):
            if not entry[key] <= REL_TOL:
                fail("partitioned", f"{(B, K, w)}: {key} {entry[key]:.3e} > {REL_TOL}")
        del Dg, Eg, bg, fk, xk, fp, xp, xf, xs, fc, xc, f1, fc1, b1, interior, cols, cols_x
    torch.cuda.empty_cache()
    return shapes


def crossover() -> list:
    """Phase 16 (b): K1's chain against the partitioned factor at B=4, K2's
    chain against the partitioned solve at B=1, over CROSSOVER_K and
    CROSSOVER_W."""
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import take

    systems, on_card = _SYSTEMS, _on_card
    rows = []
    for w in CROSSOVER_W:
        for K in CROSSOVER_K:
            system = "conditioned" if w == 37 else "random"
            Dg, Eg, bg = on_card(*systems[system](np.random.default_rng(K + w), 4, K, w))
            fc, fk = cuda_banded.banded_factor(Dg, Eg), cuda_banded.banded_factor_part(Dg, Eg)
            fc1, f1, b1 = take(fc, 0), take(fk, 0), bg[:1].contiguous()
            rel = rel_diff(cuda_banded.banded_solve_part(fk, bg), cuda_banded.banded_solve(fc, bg))
            reps = 2 if K * w > 20000 else 10
            row = {
                "K": K, "w": w, "system": system,
                "partitioned": K >= plain.PART_MIN_BLOCKS,
                "chain_factor_ms": cuda_ms(lambda: cuda_banded.banded_factor(Dg, Eg), reps),
                "part_factor_ms": cuda_ms(lambda: cuda_banded.banded_factor_part(Dg, Eg), 10),
                "chain_solve_ms": cuda_ms(lambda: cuda_banded.banded_solve(fc1, b1), reps),
                "part_solve_ms": cuda_ms(lambda: cuda_banded.banded_solve_part(f1, b1), 10),
                "rel_diff": rel,
            }
            rows.append(row)
            print(f"crossover (4, {K}, {w}): factor chain {row['chain_factor_ms']:.3f} ms, "
                  f"partitioned {row['part_factor_ms']:.3f} ms; solve (B=1) chain "
                  f"{row['chain_solve_ms']:.3f} ms, partitioned {row['part_solve_ms']:.3f} ms; "
                  f"rel diff {rel:.3e}", flush=True)
            del Dg, Eg, bg, fc, fk, fc1, f1, b1
    torch.cuda.empty_cache()
    return rows


def dry_run() -> dict:
    """Phase 16 (c): the JAX package's multi-device dry run
    (__graft_entry__.py:65-252) on a mesh of every card, or of
    DRYRUN_SHARDS shards of the one card."""
    from sleipnir_tpu_torch import ExitStatus, Options
    from sleipnir_tpu_torch.models import flywheel
    from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA
    from sleipnir_tpu_torch.parallel import Mesh, solve_ipm_batched
    from sleipnir_tpu_torch.parallel import time_axis as ta

    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    if cards > 1:
        devices, case = [f"cuda:{i}" for i in range(cards)], f"every card ({cards})"
    else:
        devices, case = ["cuda:0"] * DRYRUN_SHARDS, f"{DRYRUN_SHARDS} shards of cuda:0"
    n = len(devices)
    print(f"time axis: torch.cuda.device_count() = {cards}; the mesh is {case}", flush=True)
    dry = {"device_count": cards, "mesh": case}

    problem, _X, _U = cart_pole_problem(N=DRYRUN_LANES_N, total_time=TOTAL_TIME)
    rng = np.random.default_rng(0)
    guesses = [0.01 * k * rng.standard_normal(problem._compile()["n"]) for k in range(n)]
    cuda_banded.reset_counters()
    t0 = time.monotonic()
    statuses, costs, _xs, finals = solve_ipm_batched(
        problem, guesses, Options(device="cuda"), mesh=Mesh.of(devices, "batch"))
    for d in set(devices):
        torch.cuda.synchronize(d)
    batch_s = time.monotonic() - t0
    iterations = [int(i) for f in finals for i in f.iterations.tolist()]
    dry["batch"] = {"statuses": statuses.tolist(), "iterations": iterations, "seconds": batch_s}
    print(f"time axis, batch over the mesh (cart-pole N={DRYRUN_LANES_N}, one guess per shard, "
          f"one thread per shard): statuses {statuses.tolist()}, iterations {iterations}, costs "
          f"{costs.tolist()}, {batch_s:.2f} s with the groups' captures, launches "
          f"{dict(cuda_banded.LAUNCHES_BY_SHAPE)}", flush=True)
    if statuses.tolist() != [int(ExitStatus.SUCCESS)] * n or not np.isfinite(costs).all():
        fail("time axis", f"batch over the mesh: statuses {statuses.tolist()}, costs {costs}")

    N_t = 8 * n
    ref, RX, _RU = flywheel.flywheel_problem(N=N_t, total_time=TOTAL_TIME)
    if ref.solve(device="cuda") != ExitStatus.SUCCESS:
        fail("time axis", f"the unsharded flywheel N={N_t} failed")
    sharded, SX, _SU = flywheel.flywheel_problem(N=N_t, total_time=TOTAL_TIME)
    t_mesh = Mesh.of(devices, "t")
    sharded.set_time_axis_mesh(t_mesh, "t")
    cuda_banded.reset_counters()
    status = sharded.solve(device="cuda")
    [cached] = [v for k, v in sharded._solver_cache.items() if k[0] == "ipm"]
    err = float(np.abs(SX.value() - RX.value()).max())
    dry["flywheel"] = {"N": N_t, "status": str(status), "iterations":
                       sharded.last_solve_stats.iterations, "x_err": err,
                       "unsharded_iterations": ref.last_solve_stats.iterations}
    print(f"time axis, flywheel N={N_t} through set_time_axis_mesh: {status}, "
          f"{sharded.last_solve_stats.iterations} iterations (unsharded "
          f"{ref.last_solve_stats.iterations}), |x - x_ref| = {err:.3e}, launches "
          f"{dict(cuda_banded.LAUNCHES_BY_SHAPE)}", flush=True)
    if status != ExitStatus.SUCCESS or cached[-1].mesh is not t_mesh or not err < 1e-6:
        fail("time axis", f"flywheel through the mesh: {status}, mesh taken "
             f"{cached[-1].mesh is t_mesh}, |x - x_ref| = {err}")

    # __graft_entry__.py's system: D + Dᵀ + 10I, E = randn, seed 0.
    rng = np.random.default_rng(0)
    D = rng.standard_normal((SHARDED_K, SHARDED_W, SHARDED_W))
    D = D + np.swapaxes(D, 1, 2) + 10 * np.eye(SHARDED_W)
    E = rng.standard_normal((SHARDED_K - 1, SHARDED_W, SHARDED_W))
    rhs = rng.standard_normal((SHARDED_K, SHARDED_W))
    Dg, Eg, bg = (t[None] for t in _on_card(D, E, rhs))
    f0 = cuda_banded.banded_factor_part(Dg, Eg)
    x0 = cuda_banded.banded_solve_part(f0, bg)
    inertia0 = [t.tolist() for t in plain.part_inertia(f0, EPS_INERTIA, SHARDED_K)]
    table = [{"shards": 0, "ms": mesh_ms(lambda: cuda_banded.banded_solve_part(
        cuda_banded.banded_factor_part(Dg, Eg), bg), ["cuda:0"]), "rel_err": 0.0}]
    for nd in sorted({1, 2, max(n // 2, 1), n}):
        mesh = Mesh.of(devices[:nd], "t")
        Dp, Ep, bp, K0 = ta.pad_to_devices(Dg, Eg, bg, nd)
        fac = ta.sharded_factor(mesh, "t", Dp, Ep)
        x = ta.sharded_solve(mesh, "t", fac, bp)[:, :K0].to(dev)
        inertia = [t.tolist() for t in ta.sharded_inertia(fac, EPS_INERTIA, K0)]
        row = {"shards": nd, "devices": sorted({str(d) for d in mesh.devices}),
               "rel_err": rel_diff(x, x0), "inertia_equal": inertia == inertia0,
               "ms": mesh_ms(lambda: ta.sharded_block_tridiag_solve(mesh, "t", Dp, Ep, bp),
                             mesh.devices)}
        table.append(row)
        if not (row["rel_err"] <= 1e-8 and row["inertia_equal"]):
            fail("time axis", f"sharded factor+solve over {nd} shards: rel diff "
                 f"{row['rel_err']:.3e}, inertia {inertia} (unsharded {inertia0})")
    dry["sharded_solve"] = {"K": SHARDED_K, "w": SHARDED_W, "table": table}
    print(f"time axis, sharded factor+solve K={SHARDED_K}, w={SHARDED_W} (shards 0: the "
          f"unsharded partitioned form): " + "; ".join(
              f"{r['shards']} shards {r['ms']:.3f} ms (rel diff {r['rel_err']:.2e})"
              for r in table), flush=True)
    return dry


def variants_phase(path_iterations: dict) -> dict:
    """Phase 17: (a) cart-pole at N=100 with its DSL dynamics, (b) block
    cyclic reduction and the explicit-inverse factor against K1/K2's
    chain and timed beside the partitioned form, (c) the flywheel at
    N=5000 under each opt-in variable."""
    out = {"dsl_cart_pole": dsl_cart_pole(path_iterations["cart-pole"]),
           "shapes": variant_kernels(), "crossover": variant_crossover(),
           "flywheel": variant_solves(path_iterations["flywheel"])}
    print(json.dumps({"factor_variants": out}), flush=True)
    return out


def dsl_cart_pole(fast_iterations: int) -> dict:
    """Phase 17 (a): `cart_pole_problem(fast=False)` at N=100 on the card.
    Its symbolic dynamics do not fit the band, so it takes the dense
    backend with the JAX package's warning; it must reach SUCCESS, the
    target state and the RK4 oracle."""
    from sleipnir_tpu_torch import ExitStatus
    from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem, dynamics_numpy, rk4_numpy
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend

    t0 = time.monotonic()
    problem, X, U = cart_pole_problem(N=N, total_time=TOTAL_TIME, fast=False)
    build_s = time.monotonic() - t0
    reset_graph_counts()
    t0 = time.monotonic()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        status = problem.solve(device="cuda")
    torch.cuda.synchronize()
    solve_s = time.monotonic() - t0
    stats = problem.last_solve_stats
    [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
    warned = any("does not fit the block-tridiagonal" in str(w.message) for w in caught)
    Xv, Uv = X.value(), U.value()
    final_err = float(np.abs(Xv[:, N] - TARGET).max())
    dyn_err = max(float(np.abs(
        Xv[:, k + 1] - rk4_numpy(dynamics_numpy, Xv[:, k:k + 1], Uv[:, k:k + 1],
                                 TOTAL_TIME / N).ravel()).max()) for k in range(N))
    out = {"status": str(status), "iterations": stats.iterations,
           "fast_iterations": fast_iterations, "build_s": build_s, "solve_s": solve_s,
           "ms_per_iteration": solve_s * 1e3 / max(stats.iterations, 1),
           "host_syncs_per_iteration": stats.host_syncs_per_iteration,
           "backend": type(cached[-1]).__name__, "warned": warned,
           "final_err": final_err, "rk4_err": dyn_err}
    print(f"cart-pole N={N} with DSL dynamics (fast=False): {status}, {stats.iterations} "
          f"iterations (fast=True: {fast_iterations}), build {build_s:.2f} s, first solve "
          f"{solve_s:.2f} s ({out['ms_per_iteration']:.2f} ms/iteration, setup and captures "
          f"included), host syncs/iteration {stats.host_syncs_per_iteration:.2f}, "
          f"{out['backend']}, warned {warned}, final state error {final_err:.3e}, RK4 oracle "
          f"error {dyn_err:.3e}, {graph_note()}", flush=True)
    if status != ExitStatus.SUCCESS:
        fail("factor variants", f"cart-pole with DSL dynamics ended {status}")
    if not isinstance(cached[-1], DenseBackend) or not warned:
        fail("factor variants", f"cart-pole with DSL dynamics took {out['backend']}, "
             f"warned {warned}; the JAX package takes the dense backend with a warning")
    if not (final_err <= 1e-6 and dyn_err <= 1e-8):
        fail("factor variants", f"cart-pole with DSL dynamics: final state error "
             f"{final_err:.3e}, RK4 oracle error {dyn_err:.3e}")
    return out


def banded_residual(D, E, x, b) -> float:
    """‖M x − b‖∞ / ‖b‖∞ of block-tridiagonal systems, D (B, K, w, w), E
    (B, K-1, w, w), x and b (B, K, w)."""
    r = (D @ x[..., None])[..., 0] - b
    r[:, 1:] += (E @ x[:, :-1, :, None])[..., 0]
    r[:, :-1] += (E.transpose(-1, -2) @ x[:, 1:, :, None])[..., 0]
    return (r.abs().max() / b.abs().max()).item()


def variant_kernels() -> dict:
    """Phase 17 (b): BCR (its coarsest two blocks on K1/K2) and the
    explicit-inverse partitioned factor against K1/K2's chain at
    VARIANT_SHAPES; then the explicit inverse's residual on the
    interior-point-like chain beside the chain's and BCR's, printed and
    not gated (the documented instability, docs/tpu_numerics.md:144-155)."""
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import take
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA

    shapes = {}
    for K, w in VARIANT_SHAPES:
        Dg, Eg, bg = _on_card(*conditioned_system(np.random.default_rng(K + w + 17), 4, K, w))
        b1 = bg[:1].contiguous()
        fc = cuda_banded.banded_factor(Dg, Eg)
        xc = cuda_banded.banded_solve(take(fc, 0), b1)
        cuda_banded.reset_counters()
        fb = plain.bcr_factor(Dg, Eg, cuda_banded.banded_factor)
        xb = plain.bcr_solve(take(fb, 0), b1, cuda_banded.banded_solve)
        torch.cuda.synchronize()
        launches = {",".join(map(str, k)): n for k, n in cuda_banded.LAUNCHES_BY_SHAPE.items()}
        fi = plain.block_tridiag_factor_part_inv(Dg, Eg)
        xi = plain.block_tridiag_solve_part_inv(take(fi, 0), b1)
        inertia = {name: [t.tolist() for t in counts] for name, counts in (
            ("chain", plain.block_tridiag_inertia(fc, EPS_INERTIA)),
            ("bcr", plain.bcr_inertia(fb, EPS_INERTIA, K)),
            ("inv", plain.inv_part_inertia(fi, EPS_INERTIA, K)))}
        entry = {"bcr_rel_err": rel_diff(xb, xc), "inv_rel_err": rel_diff(xi, xc),
                 "bcr_max_abs_err": (xb - xc).abs().max().item(),
                 "inv_max_abs_err": (xi - xc).abs().max().item(),
                 "bcr_levels": len(fb.levels), "inertia": inertia["chain"],
                 "inertia_equal": inertia["chain"] == inertia["bcr"] == inertia["inv"],
                 "bcr_launches": launches}
        shapes[f"K={K},w={w}"] = entry
        print(f"factor variants (4, {K}, {w}), conditioned: inertia chain {inertia['chain']}, "
              f"BCR {inertia['bcr']}, inverse {inertia['inv']}; solve (B=1) rel diff from "
              f"K1/K2's chain: BCR {entry['bcr_rel_err']:.3e} ({len(fb.levels)} levels), "
              f"inverse {entry['inv_rel_err']:.3e}; BCR's K1/K2 launches {launches}", flush=True)
        if not entry["inertia_equal"]:
            fail("factor variants", f"(4, {K}, {w}): inertia {inertia}")
        if launches != {f"factor,4,2,{w}": 1, f"solve,1,2,{w}": 1}:
            fail("factor variants", f"(4, {K}, {w}): BCR's coarsest system launched {launches}")
        if not entry["bcr_rel_err"] <= BCR_REL_TOL:
            fail("factor variants", f"(4, {K}, {w}): BCR rel diff {entry['bcr_rel_err']:.3e}")
        if not entry["inv_rel_err"] <= INV_REL_TOL:
            fail("factor variants", f"(4, {K}, {w}): inverse rel diff {entry['inv_rel_err']:.3e}")
        del Dg, Eg, bg, b1, fc, xc, fb, xb, fi, xi

    D, E, b = ipm_like_chain(np.random.default_rng(2024))
    Dg, Eg, bg = _on_card(D, E, b)
    residual = {
        "chain": banded_residual(Dg, Eg, cuda_banded.banded_solve(
            cuda_banded.banded_factor(Dg, Eg), bg), bg),
        "bcr": banded_residual(Dg, Eg, plain.bcr_solve(
            plain.bcr_factor(Dg, Eg, cuda_banded.banded_factor), bg, cuda_banded.banded_solve), bg),
        "inv": banded_residual(Dg, Eg, plain.block_tridiag_solve_part_inv(
            plain.block_tridiag_factor_part_inv(Dg, Eg), bg), bg),
    }
    shapes["ipm_like_chain_residual"] = residual
    print(f"factor variants on the interior-point-like chain (1, 40, 13; cond(S_k) ~ 1e9), "
          f"relative residual without refinement: K1/K2's chain {residual['chain']:.3e}, BCR "
          f"{residual['bcr']:.3e}, explicit inverse {residual['inv']:.3e} (not gated)",
          flush=True)
    torch.cuda.empty_cache()
    return shapes


def variant_crossover() -> list:
    """Phase 17 (b): BCR and the explicit inverse timed beside the
    partitioned form at the crossover's shapes, factors at B=4 and solves
    at B=1, on well-conditioned stages."""
    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import take

    rows = []
    for w in CROSSOVER_W:
        for K in CROSSOVER_K:
            Dg, Eg, bg = _on_card(*conditioned_system(np.random.default_rng(K + w + 18), 4, K, w))
            b1 = bg[:1].contiguous()
            fp = take(cuda_banded.banded_factor_part(Dg, Eg), 0)
            fb = take(plain.bcr_factor(Dg, Eg, cuda_banded.banded_factor), 0)
            fi = take(plain.block_tridiag_factor_part_inv(Dg, Eg), 0)
            reps = 2 if K * w > 20000 else 5
            row = {
                "K": K, "w": w,
                "part_factor_ms": cuda_ms(lambda: cuda_banded.banded_factor_part(Dg, Eg), reps),
                "bcr_factor_ms": cuda_ms(
                    lambda: plain.bcr_factor(Dg, Eg, cuda_banded.banded_factor), reps),
                "inv_factor_ms": cuda_ms(
                    lambda: plain.block_tridiag_factor_part_inv(Dg, Eg), reps),
                "part_solve_ms": cuda_ms(lambda: cuda_banded.banded_solve_part(fp, b1), reps),
                "bcr_solve_ms": cuda_ms(
                    lambda: plain.bcr_solve(fb, b1, cuda_banded.banded_solve), reps),
                "inv_solve_ms": cuda_ms(lambda: plain.block_tridiag_solve_part_inv(fi, b1), reps),
            }
            rows.append(row)
            print(f"factor variants timed (4, {K}, {w}): factor partitioned "
                  f"{row['part_factor_ms']:.3f} ms, BCR {row['bcr_factor_ms']:.3f}, inverse "
                  f"{row['inv_factor_ms']:.3f}; solve (B=1) partitioned {row['part_solve_ms']:.3f}"
                  f", BCR {row['bcr_solve_ms']:.3f}, inverse {row['inv_solve_ms']:.3f}", flush=True)
            del Dg, Eg, bg, b1, fp, fb, fi
    torch.cuda.empty_cache()
    return rows


def variant_solves(default_iterations: int) -> dict:
    """Phase 17 (c): the flywheel IPM at N=5000 on a fresh problem under
    each opt-in variable, solved once and then once timed from the zero
    guess, as phase 6 does; SUCCESS, the JAX package's iterations within
    2, the numpy oracle with the misses of the JAX package's solution
    (VARIANT_FLYWHEEL_JAX) and no other, and the factor through the
    selected form only."""
    from sleipnir_tpu_torch import ExitStatus
    from sleipnir_tpu_torch.models import flywheel
    from sleipnir_tpu_torch.ops import cuda_banded

    out = {}
    for form, name in VARIANT_VARIABLES.items():
        os.environ[name] = "1"
        try:
            fly, FX, FU = flywheel.flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)
            cuda_banded.reset_counters()
            reset_graph_counts()
            t0 = time.monotonic()
            first = fly.solve(device="cuda")
            torch.cuda.synchronize()
            first_s = time.monotonic() - t0
            FX.set_value(np.zeros((1, FLYWHEEL_N + 1)))
            FU.set_value(np.zeros((1, FLYWHEEL_N + 1)))
            reset_graph_counts()
            t0 = time.monotonic()
            status = fly.solve(device="cuda")
            torch.cuda.synchronize()
            solve_s = time.monotonic() - t0
        finally:
            del os.environ[name]
        backends = [v[-1] for k, v in fly._solver_cache.items() if k[0] == "ipm"]
        launches, part, _ = path_counts()
        stats = fly.last_solve_stats
        failures = flywheel.oracle_failures(FX.value(), FU.value(), TOTAL_TIME)
        jax_iterations, jax_misses = VARIANT_FLYWHEEL_JAX[form]
        Uv = FU.value().reshape(-1)
        misses_equal = ([f.split(" = ")[0] for f in failures] == [f"u_{k}" for k in jax_misses]
                        and all("at steady state" in f for f in failures)
                        and all(abs(Uv[k] - u) <= 1e-6 for k, u in jax_misses.items()))
        entry = {"status": str(status), "first_status": str(first), "iterations": stats.iterations,
                 "jax_iterations": jax_iterations, "oracle_misses": failures,
                 "default_iterations": default_iterations, "first_solve_s": first_s,
                 "solve_s": solve_s, "ms_per_iteration": solve_s * 1e3 / max(stats.iterations, 1),
                 "host_syncs_per_iteration": stats.host_syncs_per_iteration,
                 "launches": {",".join(map(str, k)): n for k, n in launches.items()}}
        out[form] = entry
        print(f"flywheel N={FLYWHEEL_N} under {name}=1: first solve {first} in {first_s:.2f} s, "
              f"timed solve {status}, {stats.iterations} iterations (default {default_iterations},"
              f" the JAX package {jax_iterations}), {solve_s:.2f} s "
              f"({entry['ms_per_iteration']:.1f} ms/iteration), host syncs/iteration "
              f"{stats.host_syncs_per_iteration:.2f}, K1/K2 launches {entry['launches']}, oracle "
              f"misses {failures} (the JAX package's: {jax_misses}), {graph_note()}", flush=True)
        if status != ExitStatus.SUCCESS or first != ExitStatus.SUCCESS:
            fail("factor variants", f"flywheel under {name}: {first}, then {status}")
        if abs(stats.iterations - jax_iterations) > 2:
            fail("factor variants", f"flywheel under {name}: {stats.iterations} iterations, the "
                 f"JAX package {jax_iterations}")
        if not misses_equal:
            fail("factor variants", f"flywheel under {name}: oracle misses {failures[:5]}, the "
                 f"JAX package's {jax_misses}")
        if [(b.use_bcr, b.use_inv) for b in backends] != [(form == "bcr", form == "inv")] or part:
            fail("factor variants", f"flywheel under {name} did not take that form: "
                 f"{[(b.use_bcr, b.use_inv) for b in backends]}, partitioned calls {part}")
        if form == "bcr" and not (launches and {K for _k, _b, K, _w in launches} == {2}):
            fail("factor variants", f"BCR's K1/K2 launches are not its coarsest system's: "
                 f"{launches}")
        if form == "inv" and launches:
            fail("factor variants", f"the explicit inverse launched K1/K2: {launches}")
    return out


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
    card = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {card}", flush=True)

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
    reset_graph_counts()
    t0 = time.monotonic()
    status = problem.solve(device="cuda")
    torch.cuda.synchronize()
    solve_s = time.monotonic() - t0
    launches = {"factor": cuda_banded.FACTOR_LAUNCHES, "solve": cuda_banded.SOLVE_LAUNCHES}
    stats = problem.last_solve_stats
    # Iterations of each path, for phase 13.
    path_iterations = {"cart-pole": stats.iterations}
    print(f"solve: {status}, {stats.iterations} iterations, {solve_s * 1e3:.1f} ms "
          f"({solve_s * 1e3 / max(stats.iterations, 1):.2f} ms/iteration), "
          f"host syncs/iteration {stats.host_syncs_per_iteration:.2f}, "
          f"launches factor {launches['factor']} solve {launches['solve']}, {graph_note()} "
          f"(before the graphs: {EARLIER['cart-pole']})", flush=True)
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
    # The first solve of the process also pays one-time costs (lazy
    # imports, the first calls of every torch.func transform); a second
    # problem built and solved the same way shows a new problem's time in
    # a warm process, its captures included.
    again, AX, _AU = cart_pole_problem(N=N, total_time=TOTAL_TIME)
    reset_graph_counts()
    t0 = time.monotonic()
    again_status = again.solve(device="cuda")
    torch.cuda.synchronize()
    again_s = time.monotonic() - t0
    print(f"a second cart-pole problem: {again_status}, {again.last_solve_stats.iterations} "
          f"iterations, {again_s * 1e3:.1f} ms "
          f"({again_s * 1e3 / max(again.last_solve_stats.iterations, 1):.2f} ms/iteration), "
          f"{graph_note()}", flush=True)
    if again_status != ExitStatus.SUCCESS or not np.array_equal(AX.value(), Xv):
        fail("main path", f"a second solve ended {again_status} or differs from the first")
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
    reset_graph_counts()
    t0 = time.monotonic()
    status = fly.solve(device="cuda")
    first_s = time.monotonic() - t0
    first_note = graph_note()
    if status != ExitStatus.SUCCESS:
        fail("long horizon", f"first flywheel solve ended {status}")
    FX.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    FU.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    reset_graph_counts()
    t0 = time.monotonic()
    status = fly.solve(device="cuda")
    torch.cuda.synchronize()
    fly_s = time.monotonic() - t0
    fly_shapes, fly_part, fly_part_launches = path_counts()
    fly_iters = fly.last_solve_stats.iterations
    path_iterations["flywheel"] = fly_iters
    if status != ExitStatus.SUCCESS:
        fail("long horizon", f"timed flywheel solve ended {status}")
    failures = flywheel.oracle_failures(FX.value(), FU.value(), TOTAL_TIME)
    print(f"flywheel N={FLYWHEEL_N}: {status}, {fly_iters} iterations (the JAX package: "
          f"18 on a TPU, docs/scalability_results.md:123), first solve {first_s:.2f} s, "
          f"timed solve {fly_s:.2f} s ({fly_s * 1e3 / fly_iters:.1f} ms/iteration), "
          f"launches {fly_shapes}, partitioned {fly_part}, oracle failures {len(failures)}; "
          f"first solve {first_note}; "
          f"timed solve {graph_note()} (before the graphs: {EARLIER['flywheel']})", flush=True)
    if failures:
        fail("long horizon", "flywheel oracle: " + "; ".join(failures[:5]))
    check_partitioned("long horizon", fly_shapes, fly_part, ("factor", 4, FLYWHEEL_N + 1, 4),
                      [("solve", 1, FLYWHEEL_N + 1, 4)])
    print(f"long horizon phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 7. restoration: cart-pole N=2000 -----------------------------------
    t_phase = time.monotonic()
    funcs, state, options, backend, violation = restoration_start(RESTORATION_N, dev)
    v0 = violation(state.x)
    cuda_banded.reset_counters()
    reset_graph_counts()
    t0 = time.monotonic()
    outcome, x_new, _s, _y, _z, fr_iters = restore(funcs, state, options, parent_backend=backend)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    fr_shapes, fr_part, fr_part_launches = path_counts()
    v1 = violation(x_new)
    path_iterations["restoration"] = fr_iters
    print(f"restoration cart-pole N={RESTORATION_N}: {outcome} after {fr_iters} iterations, "
          f"{restore_s:.2f} s ({restore_s * 1e3 / max(fr_iters, 1):.1f} ms/iteration with the "
          f"entry's captures), violation {v0:.6g} -> {v1:.6g} ({v1 / v0:.4f} of the start), "
          f"launches {fr_shapes}, partitioned {fr_part}, {graph_note()} (before the graphs: "
          f"{EARLIER['restoration']})", flush=True)
    if outcome != "resume":
        fail("restoration", f"outcome {outcome}")
    if not v1 < 0.95 * v0:
        fail("restoration", f"violation {v1} is not below 0.95 x {v0}")
    check_partitioned("restoration", fr_shapes, fr_part, ("factor", 4, RESTORATION_N + 1, 37),
                      [("solve", 1, RESTORATION_N + 1, 37)])
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
    reset_graph_counts()
    t0 = time.monotonic()
    status = sqp.solve(device="cuda")
    torch.cuda.synchronize()
    sqp_s = time.monotonic() - t0
    sqp_shapes, sqp_part, sqp_part_launches = path_counts()
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
          f"launches {sqp_shapes}, partitioned {sqp_part}, timed solve {graph_note()} (before "
          f"the graphs: "
          f"{EARLIER['banded SQP']})", flush=True)
    if not abs(Xs[0, 0]) < 1e-9:
        fail("banded SQP", f"x_0 = {Xs[0, 0]}")
    if not Xs[0, FLYWHEEL_N] > 9.9:
        fail("banded SQP", f"x_N = {Xs[0, FLYWHEEL_N]} is not above 9.9")
    if not sqp_dyn <= 1e-7:
        fail("banded SQP", f"dynamics residual {sqp_dyn:.3e} above 1e-7")
    check_partitioned("banded SQP", sqp_shapes, sqp_part,
                      ("factor", 4, FLYWHEEL_N + 1, sqp_backend.w),
                      [("solve", 1, FLYWHEEL_N + 1, sqp_backend.w)])
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
          f"y = {ry.value()} (before the graphs: {EARLIER['README']})", flush=True)
    if status != ExitStatus.SUCCESS or not (abs(rx.value() - 18.0) <= 1e-8
                                            and abs(ry.value() - 6.0) <= 1e-8):
        fail("dense path", f"README example: {status}, x = {rx.value()}, y = {ry.value()}")
    # Again with diagnostics=True and spy=True: the iteration table, one
    # row per iteration, and H.spy and A_e.spy with one frame per
    # iteration, written in build/spy of the checkout.
    spy_dir = pathlib.Path(__file__).resolve().parent / "build" / "spy"
    spy_dir.mkdir(parents=True, exist_ok=True)
    rx.set_value(1.0)
    ry.set_value(2.0)
    cwd, table = os.getcwd(), io.StringIO()
    os.chdir(spy_dir)
    try:
        with contextlib.redirect_stdout(table):
            status = readme.solve(device="cuda", diagnostics=True, spy=True)
        spy = {name: read_spy(f"{name}.spy") for name in ("H", "A_e")}
    finally:
        os.chdir(cwd)
    table = table.getvalue()
    print(table, flush=True)
    readme_iters = readme.last_solve_stats.iterations
    rows = [line for line in table.splitlines()
            if line.startswith("│") and line[1:5].strip().isdigit()]
    print(f"README example with diagnostics and spy: {status}, {readme_iters} iterations, "
          f"{len(rows)} table rows, H.spy {spy['H'][:5]} with {len(spy['H'][5])} frames, "
          f"A_e.spy {spy['A_e'][:5]} with {len(spy['A_e'][5])} frames", flush=True)
    if status != ExitStatus.SUCCESS or len(rows) != readme_iters or not table.rstrip().endswith(
            "Exit: success"):
        fail("dense path", f"diagnostics: {status}, {len(rows)} rows for {readme_iters} iterations")
    if (spy["H"][:5] != ("Hessian", "Decision variables", "Decision variables", 2, 2)
            or spy["A_e"][3:5] != (1, 2) or len(spy["H"][5]) != readme_iters
            or any(frame != [(0, 0, "+"), (0, 1, "+")] for frame in spy["A_e"][5])
            or len(spy["A_e"][5]) != readme_iters):
        fail("dense path", f"spy files: H {spy['H'][:5]}, A_e {spy['A_e']}")
    dense_fly, DX, DU = flywheel.flywheel_problem(N=DENSE_FLYWHEEL_N, total_time=TOTAL_TIME,
                                                  fast=False)
    cuda_banded.reset_counters()
    reset_graph_counts()
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
          f"failures {len(dense_failures)}, banded launches {dict(cuda_banded.LAUNCHES_BY_SHAPE)}, "
          f"{graph_note()} (before the graphs: {EARLIER['dense flywheel']})", flush=True)
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
    reset_graph_counts()
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        status = mt.solve(mt_options)
    torch.cuda.synchronize()
    mt_s = time.monotonic() - t0
    mt_shapes, mt_part, mt_part_launches = path_counts()
    mt_stats = mt.last_solve_stats
    path_iterations["minimum time"] = mt_stats.iterations
    mt_total = float(mt.dt().value(0, 0)) * MIN_TIME_N
    t_star = flywheel.min_time_optimum()
    mt_x, mt_u = MX.value(), MU.value()
    print(f"minimum-time flywheel N={MIN_TIME_N} (VARIABLE_SINGLE, border nb=1, K="
          f"{mt_backend.K}, w={mt_backend.w}): {status}, {mt_stats.iterations} iterations (the "
          f"JAX package on a CPU: 31 at N=200, 228 at N=1000), set-up {mt_setup_s:.2f} s, solve "
          f"{mt_s:.2f} s ({mt_s * 1e3 / max(mt_stats.iterations, 1):.1f} ms/iteration), host syncs "
          f"{mt_stats.host_syncs} ({mt_stats.host_syncs_per_iteration:.3f}/iteration), N·dt "
          f"{mt_total:.10f} s against T* {t_star:.10f} s (rel {abs(mt_total / t_star - 1):.3e}), "
          f"x_N {mt_x[0, -1]:.9f}, launches {mt_shapes}, partitioned {mt_part}, {graph_note()} "
          f"(before the graphs: "
          f"{EARLIER['minimum time']})", flush=True)
    if status != ExitStatus.SUCCESS:
        fail("minimum time", f"solve ended {status}")
    if not abs(mt_total / t_star - 1.0) <= 1e-3:
        fail("minimum time", f"N·dt = {mt_total} is not within 1e-3 of T* = {t_star}")
    if not (np.isfinite(mt_x).all() and np.isfinite(mt_u).all() and abs(mt_x[0, 0]) <= 1e-8
            and abs(mt_x[0, -1] - 50.0) <= 1e-6 and np.abs(mt_u).max() <= 12.0 + 1e-9):
        fail("minimum time", f"x_0 {mt_x[0, 0]}, x_N {mt_x[0, -1]}, max |u| {np.abs(mt_u).max()}")
    K_mt = MIN_TIME_N + 1
    check_partitioned("minimum time", mt_shapes, mt_part, ("factor", 4, K_mt, 4),
                      [("solve", 4, K_mt, 4), ("solve", 1, K_mt, 4)])
    print(f"minimum time phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 11. the rest of the OCP layer --------------------------------------
    t_phase = time.monotonic()
    rest_shapes: collections.Counter = collections.Counter()
    rest_part_launches: collections.Counter = collections.Counter()

    def solve_path(label, problem):
        cuda_banded.reset_counters()
        reset_graph_counts()
        t0 = time.monotonic()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            status = problem.solve(device="cuda")
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        shapes, part, part_launches = path_counts()
        rest_shapes.update(shapes)
        rest_part_launches.update(part_launches)
        [cached] = [v for k, v in problem._solver_cache.items() if k[0] == "ipm"]
        backend = cached[-1]
        stats = problem.last_solve_stats
        print(f"{label}: {status}, {stats.iterations} iterations, {seconds:.2f} s "
              f"({seconds * 1e3 / max(stats.iterations, 1):.1f} ms/iteration), "
              f"{type(backend).__name__}"
              + (f" K={backend.K} w={backend.w}" if hasattr(backend, "K") else "")
              + f", host syncs {stats.host_syncs_per_iteration:.3f}/iteration, "
              f"launches {shapes}, partitioned {part}, {graph_note()}", flush=True)
        if status != ExitStatus.SUCCESS:
            fail("OCP layer", f"{label} ended {status}")
        return backend, (shapes, part), stats

    # Per-step timesteps fold into the stage: m = 4, and stage 0 holds x₀
    # beside its dynamics rows, p = 4.
    per_step = double_integrator.min_time_problem(PER_STEP_N, TimestepMethod.VARIABLE)
    backend, shapes, stats = solve_path(
        f"minimum-time double integrator N={PER_STEP_N} (VARIABLE; the JAX package on a CPU: "
        f"{PER_STEP_JAX_ITERATIONS} iterations; before the graphs: {EARLIER['per-step']})",
        per_step)
    per_step_total = float(per_step.dt().value()[0, :PER_STEP_N].sum())
    print(f"  total time {per_step_total:.10f} s", flush=True)
    if not abs(per_step_total - 2.0) <= 2e-2:
        fail("OCP layer", f"per-step minimum time {per_step_total} s, not 2 s")
    check_partitioned("OCP layer", *shapes, ("factor", 4, PER_STEP_N + 1, 8),
                      [("solve", 1, PER_STEP_N + 1, 8)])

    colloc = OCP(1, 1, COLLOCATION_T / COLLOCATION_N, COLLOCATION_N, lambda x, u: -x + u,
                 DynamicsType.EXPLICIT_ODE, TimestepMethod.FIXED,
                 TranscriptionMethod.DIRECT_COLLOCATION)
    colloc.constrain_initial_state(0.0)
    colloc.set_lower_input_bound(-12)
    colloc.set_upper_input_bound(12)
    colloc.minimize(((10.0 - colloc.X()) ** 2).sum())
    backend, shapes, stats = solve_path(
        f"direct collocation N={COLLOCATION_N} (before the graphs: {EARLIER['collocation']})",
        colloc)
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
    check_partitioned("OCP layer", *shapes, ("factor", 4, COLLOCATION_N + 1, backend.w),
                      [("solve", 1, COLLOCATION_N + 1, backend.w)])

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
    reset_graph_counts()
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
    path_iterations["lanes"] = lane_iterations
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
          f"{[f'{c[1]:.2e}' for c in lane_checks]}, launches {lanes_shapes}, {graph_note()} "
          f"(before the graphs: {EARLIER['lanes']})", flush=True)
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

    # -- 13. graphs: every graphed evaluation against its eager run --------
    t_phase = time.monotonic()
    from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

    def graph_path(name, run):
        """Run a path again with every graphed evaluation held against its
        eager function; its iterations must equal the unchecked run's."""
        cap = GRAPH_PATHS[name]
        reset_graph_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with GraphCheck() as check:
            iterations = run(cap)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        summary = check.summary()
        expected = path_iterations[name] if cap is None else cap
        print(f"graphs, {name}: {iterations} iterations (unchecked run: {expected}), "
              f"{seconds:.2f} s with the checks, {graph_note()}; per function (bitwise "
              f"equal, held, largest relative difference): {summary}", flush=True)
        if check.first_diff is not None:
            fail("graphs", f"{name}: graphed and eager first differ at (function, call, "
                 f"output) {check.first_diff}: {summary}")
        if iterations != expected:
            fail("graphs", f"{name}: {iterations} iterations, not {expected}")

    def cart_pole_run(cap):
        p = cart_pole_problem(N=N, total_time=TOTAL_TIME)[0]
        p.solve(device="cuda")
        return p.last_solve_stats.iterations

    def flywheel_run(cap):
        p = flywheel.flywheel_problem(N=FLYWHEEL_N, total_time=TOTAL_TIME)[0]
        p.solve(device="cuda")
        return p.last_solve_stats.iterations

    def restoration_run(cap):
        r_funcs, r_state, r_options, r_backend, _ = restoration_start(RESTORATION_N, dev)
        return restore(r_funcs, r_state, r_options, parent_backend=r_backend)[-1]

    def min_time_run(cap):
        p = flywheel.flywheel_min_time_problem(N=MIN_TIME_N)[0]
        p.solve(device="cuda", max_iterations=cap)
        return p.last_solve_stats.iterations

    def lanes_run(cap):
        p = cart_pole_problem(N=N, total_time=TOTAL_TIME)[0]
        return solve_ipm_batched(p, guesses, lanes_options)[3].iterations.tolist()

    def float32_run(cap):
        p = flywheel.flywheel_problem(N=F32_N, total_time=TOTAL_TIME)[0]
        p.solve(device="cuda", dtype="float32", tolerance=1e-2, max_iterations=cap)
        return p.last_solve_stats.iterations

    for name, run in (("cart-pole", cart_pole_run), ("flywheel", flywheel_run),
                      ("restoration", restoration_run), ("minimum time", min_time_run),
                      ("lanes", lanes_run), ("float32 flywheel", float32_run)):
        graph_path(name, run)

    # A model-predictive re-solve: new values of the initial state and the
    # reference reach the captured graphs of the cached solver, which
    # capture nothing new and give what a fresh problem gives.
    mpc, MPX, MPU, mpc_x0, mpc_r = flywheel.flywheel_mpc_problem(N=FLYWHEEL_N,
                                                                  total_time=TOTAL_TIME)
    reset_graph_counts()
    t0 = time.monotonic()
    first_status = mpc.solve(device="cuda")
    torch.cuda.synchronize()
    mpc_first_s, mpc_first_note = time.monotonic() - t0, graph_note()
    # From the fresh problem's starting point, not the last solution.
    MPX.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    MPU.set_value(np.zeros((1, FLYWHEEL_N + 1)))
    mpc_x0.set_value(3.0)
    mpc_r.set_value(5.0)
    reset_graph_counts()
    t0 = time.monotonic()
    status = mpc.solve(device="cuda")
    torch.cuda.synchronize()
    mpc_s, mpc_note, mpc_captures = time.monotonic() - t0, graph_note(), cuda_graph.CAPTURES
    mpc_iters = mpc.last_solve_stats.iterations
    fresh, FRX, _FRU, fresh_x0, fresh_r = flywheel.flywheel_mpc_problem(N=FLYWHEEL_N,
                                                                        total_time=TOTAL_TIME)
    fresh_x0.set_value(3.0)
    fresh_r.set_value(5.0)
    fresh_status = fresh.solve(device="cuda")
    mpc_diff = float(np.abs(MPX.value() - FRX.value()).max())
    print(f"graphs, re-solve with changed parameters (flywheel N={FLYWHEEL_N}, x0 0 -> 3, r 10 "
          f"-> 5): first solve {first_status} {mpc_first_s:.2f} s, {mpc_first_note}; re-solve "
          f"{status}, {mpc_iters} iterations, {mpc_s:.2f} s, {mpc_note}; fresh problem "
          f"{fresh_status}; largest difference {mpc_diff:.3e}, x_0 {MPX.value()[0, 0]}, "
          f"x_N {MPX.value()[0, -1]:.9f}", flush=True)
    if not (first_status == status == fresh_status == ExitStatus.SUCCESS):
        fail("graphs", f"re-solve: {first_status}, {status}, {fresh_status}")
    if mpc_captures != 0 or mpc_diff != 0.0 or not abs(MPX.value()[0, 0] - 3.0) <= 1e-9:
        fail("graphs", f"re-solve: {mpc_captures} captures, {mpc_diff} from a fresh problem, "
             f"x_0 {MPX.value()[0, 0]}")
    print(f"graphs phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 14. float32: Options(dtype="float32") on every solver ------------
    t_phase = time.monotonic()
    from sleipnir_tpu_torch.optimization.solver.kkt_backend import eps_inertia
    from sleipnir_tpu_torch.optimization.solver.util import cuda_graph

    eps32 = eps_inertia(torch.float32)
    f32_shapes: collections.Counter = collections.Counter()
    f32_part: collections.Counter = collections.Counter()

    def f32_path(name, run):
        """One float32 path with the launch counts at 0 just before it; its
        result, seconds, kernel shapes and graphs' dtype tally. It fails if
        a float64 kernel launched or a graphed call saw a float64 tensor."""
        cuda_banded.reset_counters()
        reset_graph_counts()
        torch.cuda.synchronize()
        with DtypeTally() as tally:
            t0 = time.monotonic()
            result = run()
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
        shapes, part, _part_launches = path_counts()
        if cuda_banded.FACTOR_LAUNCHES or cuda_banded.SOLVE_LAUNCHES:
            fail("float32", f"{name}: float64 kernel launches {shapes}")
        if sum(tally.float64_calls.values()):
            fail("float32", f"{name}: graphed calls with float64 tensors "
                 f"{dict(tally.float64_calls)}")
        f32_shapes.update(shapes)
        f32_part.update(part)
        return result, seconds, shapes, tally

    def hold_status(name, status, expected):
        if status != ExitStatus[expected]:
            fail("float32", f"{name} ended {status}; the JAX package's float32 path ends "
                 f"{expected}")

    def scalar_problem(solver):
        p = Problem()
        x = p.decision_variable()
        if solver == "Newton":
            x.set_value(20.0)
            p.minimize(x * x - 6.0 * x)
            return p, [x], [3.0]
        y = p.decision_variable()
        if solver == "SQP":
            x.set_value(1.0)
            y.set_value(1.0)
            p.minimize(x * x + 2.0 * y * y)
            p.subject_to(x + y == 3.0)
            return p, [x, y], [2.0, 1.0]
        x.set_value(3.0)
        y.set_value(2.0)
        p.minimize(x * x + y * y)
        p.subject_to(x + y >= 2.0)
        return p, [x, y], [1.0, 1.0]

    # The three scalar problems of tests/optimization/test_dtype_axis.py.
    for solver, jax_iters in F32_SCALAR_JAX_ITERATIONS.items():
        p, xs_, expected = scalar_problem(solver)
        status, seconds, _shapes, _tally = f32_path(
            solver, lambda: p.solve(device="cuda", dtype="float32", tolerance=1e-4))
        values = [v.value() for v in xs_]
        print(f"float32 {solver}: {status}, {p.last_solve_stats.iterations} iterations (the JAX "
              f"package: {jax_iters}), {seconds:.3f} s, solution {values} (expected {expected})",
              flush=True)
        hold_status(solver, status, "SUCCESS")
        if not all(abs(v - e) <= 1e-2 for v, e in zip(values, expected)):
            fail("float32", f"{solver}: solution {values} is not within 1e-2 of {expected}")
        if p._last_state.x.dtype != torch.float32:
            fail("float32", f"{solver}: the iterate is {p._last_state.x.dtype}")

    # The flywheel at N=60 (SUCCESS) and 1000 (restoration fails, its
    # banded system factored by float32 K1 too).
    f32_iterations = {}
    for n_fly, (expected, jax_iters) in F32_FLYWHEEL_JAX.items():
        p, FX32, _FU32 = flywheel.flywheel_problem(N=n_fly, total_time=TOTAL_TIME)
        f32_part.clear()
        status, seconds, shapes, tally = f32_path(
            f"flywheel N={n_fly}",
            lambda: p.solve(device="cuda", dtype="float32", tolerance=1e-2))
        # At K ≥ 256 the card takes the partitioned form: its calls by the
        # outer system's shape stand beside the launches.
        systems = {**shapes, **f32_part}
        iters = p.last_solve_stats.iterations
        f32_iterations[n_fly] = iters
        x_end = float(FX32.value()[0, n_fly])
        print(f"float32 flywheel N={n_fly}: {status}, {iters} iterations (the JAX package on a "
              f"CPU: {expected}, {jax_iters} iterations), {seconds:.2f} s "
              f"({seconds * 1e3 / max(iters, 1):.1f} ms/iteration), x_N {x_end:.6f}, launches "
              f"{shapes}, partitioned {dict(f32_part)}, graphs' dtypes {sorted(str(d) for d in tally.dtypes)}, {graph_note()}",
              flush=True)
        hold_status(f"flywheel N={n_fly}", status, expected)
        if p._last_state.x.dtype != torch.float32:
            fail("float32", f"flywheel N={n_fly}: the iterate is {p._last_state.x.dtype}")
        for k in ("factor_f32", "solve_f32"):
            if not any(kk == k and K == n_fly + 1 and w == 4 for kk, _b, K, w in systems):
                fail("float32", f"flywheel N={n_fly}: no {k} launch at (·, {n_fly + 1}, 4)")
        if expected == "SUCCESS" and not abs(x_end - 10.0) <= 5.0:
            fail("float32", f"flywheel N={n_fly}: x_N {x_end} is not within 5 of 10 (the JAX "
                 f"test's bound)")
        if n_fly + 1 >= 256:
            check_partitioned("float32", shapes, f32_part, ("factor_f32", 2, n_fly + 1, 4),
                              [("solve_f32", 1, n_fly + 1, 4)])
        if expected == "FEASIBILITY_RESTORATION_FAILED" and not any(
                kk == "factor_f32" and K == n_fly + 1 and w != 4 for kk, _b, K, w in systems):
            fail("float32", f"flywheel N={n_fly}: restoration's system was not factored in "
                 f"float32: {shapes}")

    # 4 lanes of the flywheel at N=60 as one batched solve.
    lanes32, _LX32, _LU32 = flywheel.flywheel_problem(N=F32_N, total_time=TOTAL_TIME)
    n32 = lanes32._compile()["n"]
    rng32 = np.random.default_rng(0)
    guesses32 = [0.01 * k * rng32.standard_normal(n32) for k in range(F32_LANES)]
    (l_status, _l_costs, _l_xs, l_final), seconds, shapes, _tally = f32_path(
        "lanes", lambda: solve_ipm_batched(
            lanes32, guesses32, Options(device="cuda", dtype="float32", tolerance=1e-2)))
    l_iters = l_final.iterations.tolist()
    print(f"float32 lanes, flywheel N={F32_N}, L={F32_LANES}: statuses {l_status.tolist()}, "
          f"iterations {l_iters} (the JAX package on a CPU: {F32_LANES_JAX}), {seconds:.2f} s, "
          f"launches {shapes}, {graph_note()}", flush=True)
    if l_status.tolist() != F32_LANES_JAX[0]:
        fail("float32", f"lanes ended {l_status.tolist()}, the JAX package's {F32_LANES_JAX[0]}")
    for key in (("factor_f32", 2 * F32_LANES, F32_N + 1, 4),
                ("solve_f32", F32_LANES, F32_N + 1, 4)):
        if not shapes.get(key):
            fail("float32", f"lanes: no launch at {key}: {shapes}")
    if l_final.x.dtype != torch.float32:
        fail("float32", f"lanes: the iterate is {l_final.x.dtype}")

    # A cached float64 problem re-solved in float32: its own graphs, and no
    # float64 graph replayed; then equal to a fresh float32 problem's solve.
    cached, CX, CU = flywheel.flywheel_problem(N=F32_N, total_time=TOTAL_TIME)
    if cached.solve(device="cuda") != ExitStatus.SUCCESS:
        fail("float32", "the cached problem's float64 solve failed")
    CX.set_value(np.zeros((1, F32_N + 1)))
    CU.set_value(np.zeros((1, F32_N + 1)))
    status, seconds, _shapes, tally = f32_path(
        "re-solve", lambda: cached.solve(device="cuda", dtype="float32", tolerance=1e-2))
    re_captures = sum(tally.captures.values())
    re_iters = cached.last_solve_stats.iterations
    fresh32, FX60, _ = flywheel.flywheel_problem(N=F32_N, total_time=TOTAL_TIME)
    fresh32.solve(device="cuda", dtype="float32", tolerance=1e-2)
    re_diff = float(np.abs(CX.value() - FX60.value()).max())
    print(f"float32 re-solve of a cached float64 flywheel N={F32_N}: {status}, {re_iters} "
          f"iterations, {seconds:.2f} s, {re_captures} captures, graphed calls with float64 "
          f"tensors {sum(tally.float64_calls.values())}, solver cache "
          f"{sorted(k[-2] for k in cached._solver_cache)}, largest difference from a fresh "
          f"float32 problem {re_diff:.3e}", flush=True)
    if status != ExitStatus.SUCCESS or re_captures == 0 or re_iters != f32_iterations[F32_N]:
        fail("float32", f"re-solve: {status}, {re_captures} captures, {re_iters} iterations "
             f"(fresh: {f32_iterations[F32_N]})")
    if re_diff != 0.0:
        fail("float32", f"re-solve differs from a fresh float32 problem by {re_diff}")

    # K1/K2 in float32 against the float32 twin at every float32 shape the
    # paths launched, the N=5000 path's shapes, (2, 40, 37) and the width edges;
    # each path shape timed beside the float64 kernels at the same shape.
    shape_set = sorted({(B, K, w) for (_k, B, K, w) in f32_shapes} | set(F32_LONG_SHAPES))
    cases32 = [(B, K, w, True) for B, K, w in shape_set] + [(2, 40, 37, False)]
    cases32 += [(B, 9, w, False) for w in EDGE_WIDTHS for B in (1, 2)]
    f32_kernels = {}
    for B, K, w, timed in cases32:
        D, E, b = conditioned_system(np.random.default_rng(B * K + w + 32), B, K, w)
        D32, E32, b32 = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (D, E, b))
        fk = cuda_banded.banded_factor(D32, E32)
        xk = cuda_banded.banded_solve(fk, b32)
        fp = plain.block_tridiag_factor(D32, E32)
        xp = plain.block_tridiag_solve(fp, b32)
        xf = plain.block_tridiag_solve(fk, b32)
        xs = cuda_banded.banded_solve(fp, b32)
        torch.cuda.synchronize()
        ik = [t.tolist() for t in plain.block_tridiag_inertia(fk, eps32)]
        ip = [t.tolist() for t in plain.block_tridiag_inertia(fp, eps32)]
        entry = {
            "B": B, "K": K, "w": w, "system": "conditioned",
            "rel_err": rel_diff(xk, xp),
            "factor_max_abs_err": (xf - xp).abs().max().item(),
            "factor_rel_err": rel_diff(xf, xp),
            "solve_max_abs_err": (xs - xp).abs().max().item(),
            "solve_rel_err": rel_diff(xs, xp),
            "inertia_equal": ik == ip, "perm_equal": torch.equal(fk.perm, fp.perm),
            "launches_factor": f32_shapes.get(("factor_f32", B, K, w), 0),
            "launches_solve": f32_shapes.get(("solve_f32", B, K, w), 0),
        }
        if timed:
            D64, E64, b64 = (t.double() for t in (D32, E32, b32))
            f64 = cuda_banded.banded_factor(D64, E64)
            reps, plain_reps = (3, 1) if K > 1000 else (50, 5)
            entry.update({
                "factor_ms": cuda_ms(lambda: cuda_banded.banded_factor(D32, E32), reps),
                "factor_f64_ms": cuda_ms(lambda: cuda_banded.banded_factor(D64, E64), reps),
                "factor_plain_ms": cuda_ms(lambda: plain.block_tridiag_factor(D32, E32),
                                           plain_reps),
                "solve_ms": cuda_ms(lambda: cuda_banded.banded_solve(fk, b32), reps),
                "solve_f64_ms": cuda_ms(lambda: cuda_banded.banded_solve(f64, b64), reps),
                "solve_plain_ms": cuda_ms(lambda: plain.block_tridiag_solve(fk, b32),
                                          plain_reps),
            })
            entry["factor_bound_ms"], entry["factor_bound_by"] = factor_bound(
                B, K, w, word=4, rate=F32_PER_S)
            entry["solve_bound_ms"], entry["solve_bound_by"] = solve_bound(
                B, K, w, word=4, rate=F32_PER_S)
            entry["factor_f64_bound_ms"] = factor_bound(B, K, w)[0]
            entry["solve_f64_bound_ms"] = solve_bound(B, K, w)[0]
            del D64, E64, b64, f64
        f32_kernels[B, K, w] = entry
        print(f"kernels float32 (B={B}, K={K}, w={w}): inertia {ik[0]}/{ik[1]}/{ik[2]} (plain "
              f"{ip[0]}/{ip[1]}/{ip[2]}), pivots equal {entry['perm_equal']}, rel diff "
              f"{entry['rel_err']:.3e} (factor alone {entry['factor_rel_err']:.3e}, solve alone "
              f"{entry['solve_rel_err']:.3e})"
              + (f"; factor {entry['factor_ms']:.4f} ms (float64 {entry['factor_f64_ms']:.4f}, "
                 f"plain {entry['factor_plain_ms']:.2f}, bound {entry['factor_bound_ms']:.6f}), "
                 f"solve {entry['solve_ms']:.4f} ms (float64 {entry['solve_f64_ms']:.4f}, plain "
                 f"{entry['solve_plain_ms']:.2f}, bound {entry['solve_bound_ms']:.6f}); path "
                 f"launches {entry['launches_factor']}/{entry['launches_solve']}"
                 if timed else ""), flush=True)
        if ik != ip or not entry["perm_equal"]:
            fail("float32", f"kernels {(B, K, w)}: inertia {ik} (plain {ip}) or pivots differ")
        for key in ("rel_err", "factor_rel_err", "solve_rel_err"):
            if not entry[key] <= F32_REL_TOL:
                fail("float32", f"kernels {(B, K, w)}: {key} {entry[key]:.3e} > {F32_REL_TOL}")
        del D32, E32, b32, fk, xk, fp, xp, xf, xs
    torch.cuda.empty_cache()
    print(f"float32 phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 15. the examples ---------------------------------------------------
    t_phase = time.monotonic()
    ocp_shapes = examples_phase()
    print(f"examples phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 16. the partitioned factor and the time axis ---------------------
    t_phase = time.monotonic()
    part_kernels = partitioned_phase()
    print(f"partitioned and time axis phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- 17. the opt-in factor forms and cart-pole's DSL dynamics ---------
    t_phase = time.monotonic()
    variants_phase(path_iterations)
    print(f"factor variants phase: {time.monotonic() - t_phase:.1f} s", flush=True)

    # -- results ----------------------------------------------------------
    path_shapes = (collections.Counter(fly_shapes) + collections.Counter(fr_shapes)
                   + collections.Counter(sqp_shapes) + collections.Counter(mt_shapes)
                   + rest_shapes)
    # The long paths' systems take the partitioned form on the card: the
    # K1/K2 launches it made, by the outer system's shape.
    path_part_launches = (collections.Counter(fly_part_launches)
                          + collections.Counter(fr_part_launches)
                          + collections.Counter(sqp_part_launches)
                          + collections.Counter(mt_part_launches) + rest_part_launches)
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
        part_launches = {f"B={B},K={K},w={w}": n for (k, B, K, w), n in path_part_launches.items()
                         if k == kind and K * w >= TPU_CHUNKED_ROWS}
        fly_part = part_kernels["shapes"][4, FLYWHEEL_N + 1, 4]
        return {
            "name": f"banded_{kind}_long",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": replaces,
            # The paths' long systems take the partitioned form: its K1/K2
            # launches, by the outer system's shape, and any chain launch
            # at a long shape.
            "launches": sum(long_launches(path_shapes, kind).values()) + sum(part_launches.values()),
            "launches_by_shape": long_launches(path_shapes, kind),
            "partitioned_launches_by_shape": part_launches,
            # At the flywheel path's shape (factor B=4, solve B=1, K=5001,
            # w=4): the partitioned form the path runs ("ms"), K1/K2's
            # chain ("chain_ms"); every long shape is under "shapes" and
            # "partitioned_shapes".
            "max_abs_err": fly_part[f"{kind}_max_abs_err"],
            "ms": fly_part[f"{kind}_ms"],
            "chain_ms": fly_long[f"{kind}_ms"],
            "us_per_stage": 1e3 * fly_long[f"{kind}_ms"] / (FLYWHEEL_N + 1),
            "plain_ms": fly_part[f"{kind}_plain_ms"],
            "chain_plain_ms": fly_long[f"{kind}_plain_ms"],
            "bound_ms": fly_long[f"{kind}_bound_ms"],
            "bound_by": fly_long[f"{kind}_bound_by"],
            "library_ms": None,
            "shapes": shapes,
            "partitioned_shapes": [
                {"B": B, "K": K, "w": w, **{k: v for k, v in e.items()
                                            if k.startswith(kind) or k in ("system", "P", "L")}}
                for (B, K, w), e in part_kernels["shapes"].items()],
            **({"ms_B1": fly_long["factor_b1_ms"],
                "crossover": part_kernels["crossover"]} if kind == "factor" else {}),
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
            # The flywheel OCP example's launches (phase 15), by shape.
            "examples": {f"flywheel_ocp B={B},K={K},w={w}": n
                         for (k, B, K, w), n in ocp_shapes.items() if k == "factor"},
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
            "examples": {f"flywheel_ocp B={B},K={K},w={w}": n
                         for (k, B, K, w), n in ocp_shapes.items() if k == "solve"},
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
    def f32_entry(kind, replaces, path_shape):
        """K1 or K2 in float32: launches over phase 14's paths, numbers at the
        float32 flywheel's shape at N=60, every float32 shape under
        "shapes"."""
        e = f32_kernels[path_shape]
        shapes = []
        for (B, K, w), c in f32_kernels.items():
            if f"{kind}_ms" not in c:
                continue
            shapes.append({
                "B": B, "K": K, "w": w, "system": c["system"],
                "max_abs_err": c[f"{kind}_max_abs_err"], "rel_err": c[f"{kind}_rel_err"],
                "inertia_equal": c["inertia_equal"], "perm_equal": c["perm_equal"],
                "launches": c[f"launches_{kind}"], "ms": c[f"{kind}_ms"],
                "f64_ms": c[f"{kind}_f64_ms"], "plain_ms": c[f"{kind}_plain_ms"],
                "bound_ms": c[f"{kind}_bound_ms"], "bound_by": c[f"{kind}_bound_by"],
                "f64_bound_ms": c[f"{kind}_f64_bound_ms"],
            })
        return {
            "name": f"banded_{kind}_f32",
            "route": "cuda",
            "source": "sleipnir_tpu_torch/csrc/banded.cu",
            "replaces": replaces,
            "launches": sum(n for (k, *_shape), n in f32_shapes.items() if k == f"{kind}_f32"),
            "max_abs_err": e[f"{kind}_max_abs_err"],
            "ms": e[f"{kind}_ms"],
            "f64_ms": e[f"{kind}_f64_ms"],
            "us_per_stage": 1e3 * e[f"{kind}_ms"] / path_shape[1],
            "plain_ms": e[f"{kind}_plain_ms"],
            "bound_ms": e[f"{kind}_bound_ms"],
            "bound_by": e[f"{kind}_bound_by"],
            "library_ms": None,
            "shapes": shapes,
        }

    kernels[0]["time_axis"] = part_kernels["time_axis"]
    kernels += [
        f32_entry("factor", "sleipnir_tpu/ops/pallas_banded.py:360", (2, F32_N + 1, 4)),
        f32_entry("solve", "sleipnir_tpu/ops/pallas_banded.py:421", (1, F32_N + 1, 4)),
    ]
    for entry in kernels[2:4]:
        if entry["launches"] == 0:
            fail("results", f"{entry['name']} was never launched at a long-horizon shape")
    for entry in kernels[5:]:
        if entry["launches"] == 0:
            fail("results", f"{entry['name']} was never launched by a float32 path")
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
