"""The interior-point step over a lane axis: L solves of one problem, one
iterate per lane, advanced together.

The counterpart of `jax.vmap(step_if_running)` in
`sleipnir_tpu/parallel/batch.py:52-68`. Per lane the arithmetic is the
serial step's (`optimization/solver/interior_point.py`), but where that
step reads a device boolean and branches on the host, this one turns the
branch into a per-lane mask and merges both sides with `torch.where`:

  - the state is an `IPMState` whose every tensor has a leading lane axis
    L; `status`, `iterations`, `infeas_streak` and the full-step
    rejection counter are int64 tensors of shape (L,);
  - the inner loops (δ/γ fallback, line search, second-order
    corrections, μ update) run while any lane is still in them, and a
    lane whose loop ended is frozen. Each trip reads one reduction over
    lanes (`any`) through `HostSyncs`; no host read is per lane, so the
    reads per iteration do not grow with L;
  - derivatives and every other per-lane function run under
    `torch.func.vmap` over lanes (the params are shared); the problem
    evaluations among them replay as CUDA graphs on the card, each graph
    holding the whole vmapped function;
  - the KKT factor and solves never run under `vmap`: the staged systems
    of all lanes and all ladder candidates are flattened into one batch,
    so K1 factors the 4·L systems of a ladder in one launch and K2 solves
    the L step systems in one launch (`ops/cuda_banded.py`; at long
    horizons on the card, one partitioned factor or solve of that batch,
    through the backend's `chain_solve`); the dense
    backend's LDLᵀ takes the same flattened batch.

A lane that leaves RUNNING stays as it is, as the JAX runner leaves it:
success, a failure, or a request for feasibility restoration, which ends
the lane with code FEASIBILITY_RESTORATION_REQUESTED (no restoration
runs in a batch, as in the JAX package).
"""

from __future__ import annotations

import functools

import torch
from torch.func import vmap

from sleipnir_tpu_torch.ops.ldlt import ldlt_unblocked
from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import (
    IPMFunctions,
    ScalingArrays,
    bind,
)
from sleipnir_tpu_torch.optimization.solver.interior_point import (
    ALPHA_MIN,
    ALPHA_REDUCTION_FACTOR,
    DIVERGENCE_LIMIT,
    GAMMA_MIN,
    KAPPA_EPSILON,
    KAPPA_MU,
    KAPPA_SOC,
    MAX_BACKTRACKS,
    MAX_LINE_SEARCH_TRIPS,
    MAX_SOC_ITERATIONS,
    TAU_MIN,
    THETA_MU,
    IPMState,
    _max_abs,
    _one_norm,
    _Trial,
    clamp_z,
    phi,
    viol,
)
from sleipnir_tpu_torch.optimization.solver.kkt_backend import (
    DenseFactor,
    eps_of,
    ladder_depth,
)
from sleipnir_tpu_torch.optimization.solver.kkt_banded import (
    BandedBackend,
    BandedFactor,
)
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.util.filter import (
    check_acceptance,
    make_filter,
    reset_filter,
    try_add,
)
from sleipnir_tpu_torch.optimization.solver.util.kkt_error import (
    kkt_error_ipm_inf_products,
    kkt_error_ipm_one_products,
    unscaled_kkt_error_ipm_products,
)
from sleipnir_tpu_torch.optimization.solver.util.step_rules import (
    fraction_to_the_boundary,
)
from sleipnir_tpu_torch.util.profiler import span

def merge(mask: torch.Tensor, new, old):
    """Per lane, `new` where `mask` (L,) holds, else `old`: tensors or
    (named) tuples of tensors with a leading lane axis."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)
    parts = [merge(mask, a, b) for a, b in zip(new, old)]
    return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)


def take(tree, idx: torch.Tensor):
    """Rows `idx` of the leading axis of every tensor in a (named) tuple."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    parts = [take(t, idx) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def lane_regularization_loop(factor_with, ideal_pos, ideal_neg, prev_delta, gamma_min,
                             need, syncs):
    """`kkt_backend.regularization_loop` for L lanes at once.

    `factor_with(deltas, gammas)` takes (L, C) regularizations and factors
    all L·C systems as one batch, returning (fac with leading axis L·C,
    pos, neg, zero, failed each (L, C)). Each lane picks its smallest
    ideal rung of the ladder (4 wide, 2 in float32, in the dtype of
    `prev_delta`) on the device; the sequential
    escalation runs only while some lane of `need` has none, one batch of
    L systems per trip. Returns (fac (L, ...), delta (L,), gamma (L,),
    ok (L,))."""
    L = prev_delta.shape[0]
    device, dtype = prev_delta.device, prev_delta.dtype
    ladder = ladder_depth(dtype)
    lane = torch.arange(L, device=device)
    delta0 = torch.where(
        prev_delta == 0.0,
        torch.full_like(prev_delta, 1e-4),
        torch.clamp(prev_delta / 2.0, min=eps_of(dtype)),
    )
    zeros = torch.zeros((L, 1), dtype=dtype, device=device)
    rungs = 10.0 ** torch.arange(ladder - 1, dtype=dtype, device=device)
    deltas = torch.cat([zeros, delta0[:, None] * rungs], dim=1)
    gammas = torch.cat(
        [zeros, torch.full((L, ladder - 1), gamma_min, dtype=dtype, device=device)], dim=1
    )

    lfac, lpos, lneg, lzero, lfailed = factor_with(deltas, gammas)
    lideal = (lpos == ideal_pos) & (lneg == ideal_neg) & (lzero == 0) & ~lfailed
    ranks = torch.arange(ladder, device=device)
    pick = torch.min(torch.where(lideal, ranks, ladder), dim=1).values
    have = pick < ladder
    rung = torch.clamp(pick, max=ladder - 1)
    fac = take(lfac, lane * ladder + rung)
    delta, gamma, ok = deltas[lane, rung], gammas[lane, rung], have
    todo = need & ~have
    if not syncs.read(todo.any()):
        return fac, delta, gamma, ok

    # Sequential fallback one decade above the top rung: the reference's
    # diagnosis-dependent δ/γ escalation (sparse_regularized_ldlt.hpp:118-143)
    # per lane, on device scalars.
    d_f = delta0 * 10.0 ** (ladder - 1)
    g_f = torch.full_like(d_f, gamma_min)
    while True:
        f1, pos, neg, zero, failed = factor_with(d_f[:, None], g_f[:, None])
        pos, neg, zero, failed = pos[:, 0], neg[:, 0], zero[:, 0], failed[:, 0]
        ideal = (pos == ideal_pos) & (neg == ideal_neg) & (zero == 0) & ~failed
        win = todo & ideal
        fac = merge(win, f1, fac)
        delta, gamma, ok = torch.where(win, d_f, delta), torch.where(win, g_f, gamma), ok | win
        has_zero = (zero > 0) & ~failed
        too_negative = (neg > ideal_neg) & ~failed & ~has_zero
        too_positive = (pos > ideal_pos) & ~failed & ~has_zero & ~too_negative
        g_zero = g_f == 0.0
        g_up = torch.where(g_zero, 1e-10, g_f * 10.0)
        new_d = torch.where(
            has_zero, torch.where(g_zero, d_f, d_f * 10.0),
            torch.where(too_positive & ~too_negative, d_f, d_f * 10.0),
        )
        new_g = torch.where(too_negative, g_f, g_up)
        todo = todo & ~ideal
        d_f, g_f = torch.where(todo, new_d, d_f), torch.where(todo, new_g, g_f)
        # Past 1e20 the lane's factorization failed; ok stays False.
        todo = todo & (d_f <= 1e20) & (g_f <= 1e20)
        if not syncs.read(todo.any()):
            return fac, delta, gamma, ok


class _BandedLanes:
    """Lane-axis factor and solve on the banded backend's kernels."""

    def __init__(self, backend: BandedBackend) -> None:
        self.b = backend

    def factor(self, d, sigma, prev_delta, gamma_min, need) -> BandedFactor:
        b = self.b

        def factor_with(deltas, gammas):
            L, C = deltas.shape
            D, E = vmap(b.assemble_staged)(d, sigma, deltas, gammas)
            E = E[:, None].expand(L, C, *E.shape[1:])
            out, pos, neg, zero, failed = b.factor_candidates(
                D.reshape(L * C, *D.shape[2:]), E.reshape(L * C, *E.shape[2:]),
                deltas.reshape(-1), gammas.reshape(-1),
                lambda fac, s_eq: self._border_schur(d, sigma, fac, s_eq, col0, e0, deltas, gammas),
            )
            return out, *(t.view(L, C) for t in (pos, neg, zero, failed))

        with span("slp.factor"):
            col0, e0 = vmap(b._assemble_border)(d, sigma)
            (fac, s_eq, X, Lb, db), delta, gamma, ok = lane_regularization_loop(
                factor_with, b.n, b.K * b.p, prev_delta, gamma_min, need, b.syncs
            )
        return BandedFactor(fac=fac, s=s_eq, col=col0, Xcols=X, e0=e0, Sb_L=Lb, Sb_d=db,
                            delta=delta, gamma=gamma, ok=ok)

    def _border_schur(self, d, sigma, fac, s_eq, col0, e0, deltas, gammas):
        """`BandedBackend._border_schur` for (L, C) candidates: T⁻¹·col of
        every border column of every candidate of every lane is one K2
        launch at (L·C, K, w, nb)."""
        b = self.b
        L, C = deltas.shape
        shape = col0.shape[1:]  # (nb, K, w)

        def tsolve(rhs):  # (L·C, nb, K, w)
            rhs = (s_eq[:, None] * rhs).permute(0, 2, 3, 1).contiguous()
            return s_eq[:, None] * b.chain_solve(fac, rhs).permute(0, 3, 1, 2)

        cols = col0[:, None].expand(L, C, *shape).reshape(L * C, *shape)
        X = tsolve(cols)
        def matvec(dl, sg, de, ga, Xl):
            return b._kkt_matvec_staged(dl, sg, de[:, None], ga[:, None], Xl)

        AX = vmap(matvec)(d, sigma, deltas, gammas, X.view(L, C, *shape))
        X = X + tsolve(cols - AX.reshape(X.shape))
        eye = torch.eye(b.nb, dtype=b.dtype, device=b.device)
        Sb = (e0[:, None] + deltas[..., None, None] * eye
              - torch.einsum("lakw,lcbkw->lcab", col0, X.view(L, C, *shape)))
        Lb, db = ldlt_unblocked(Sb.reshape(L * C, b.nb, b.nb))
        return X, Lb, db

    def _bordered_solve(self, fac: BandedFactor, rhs, rhs_b):
        """The arrowhead solve of every lane: the band in one K2 launch at
        (L, K, w), then the border's small Schur systems."""
        u0 = fac.s * self.b.chain_solve(fac.fac, (fac.s * rhs).contiguous())
        if self.b.nb == 0:
            return u0, rhs_b
        r = rhs_b - torch.einsum("lbkw,lkw->lb", fac.col, u0)
        y = torch.linalg.solve_triangular(fac.Sb_L, r[..., None], upper=False)[..., 0]
        y = y / torch.where(fac.Sb_d == 0.0, 1.0, fac.Sb_d)
        LT = fac.Sb_L.transpose(-1, -2)
        v = torch.linalg.solve_triangular(LT, y[..., None], upper=True)[..., 0]
        return u0 - torch.einsum("lbkw,lb->lkw", fac.Xcols, v), v

    def solve_refined(self, d, sigma, fac: BandedFactor, rhs_top, rhs_bottom, iterations: int = 2):
        """`BandedBackend.solve_refined` for every lane at once."""
        b = self.b
        with span("slp.solve_refined"):
            rhs, rhs_b = vmap(b._staged_rhs)(rhs_top, rhs_bottom)
            sol, v_b = self._bordered_solve(fac, rhs, rhs_b)
            for _ in range(iterations):
                r = rhs - vmap(b._kkt_matvec_staged)(d, sigma, fac.delta, fac.gamma, sol)
                r_b = rhs_b
                if b.nb > 0:
                    r = r - torch.einsum("lbkw,lb->lkw", fac.col, v_b)
                    r_b = (rhs_b - torch.einsum("lbkw,lkw->lb", fac.col, sol)
                           - torch.einsum("lab,lb->la", fac.e0, v_b) - fac.delta[:, None] * v_b)
                du, dv = self._bordered_solve(fac, r, r_b)
                sol, v_b = sol + du, v_b + dv
            return vmap(b._unpack_solution)(sol, v_b)


class _DenseLanes:
    """Lane-axis factor and solve on the dense backend's LDLᵀ."""

    def __init__(self, backend) -> None:
        self.b = backend

    def factor(self, d, sigma, prev_delta, gamma_min, need) -> DenseFactor:
        b = self.b
        lhs = vmap(b.kkt_lhs)(d, sigma)  # (L, N, N)
        reg_pos, reg_neg = b.regularization_diagonals()

        def factor_with(deltas, gammas):
            L, C = deltas.shape
            diag = deltas[..., None] * reg_pos + gammas[..., None] * reg_neg
            A = (lhs[:, None] + torch.diag_embed(diag)).reshape(L * C, *lhs.shape[1:])
            out, pos, neg, zero, failed = b.factor_candidates(
                A, deltas.reshape(-1), gammas.reshape(-1)
            )
            return out, *(t.view(L, C) for t in (pos, neg, zero, failed))

        (Lf, dd, s), delta, gamma, ok = lane_regularization_loop(
            factor_with, b.n, b.me, prev_delta, gamma_min, need, b.syncs
        )
        return DenseFactor(L=Lf, d=dd, s=s, delta=delta, gamma=gamma, ok=ok)

    def solve_refined(self, d, sigma, fac: DenseFactor, rhs_top, rhs_bottom):
        return vmap(self.b.solve_refined)(d, sigma, fac, rhs_top, rhs_bottom)


def make_lane_interior_point(funcs: IPMFunctions, options: Options, *, backend):
    """Build (init, step) of the interior-point method over a lane axis.

    `init(x0, s0, y0, z0, mu0, params, scaling)` takes per-lane starting
    points (L, ·), μ₀ (L,) and scaling arrays with a leading lane axis;
    the params are shared. `step(state, run)` advances the lanes of the
    (L,) mask `run` by one iteration and leaves the others as they are.

    The pair reads nothing of a call but its arguments, so one pair serves
    every batched call on the same backend and options, whatever its L
    (`parallel/batch.py` keeps it per bundle). Its problem evaluations
    capture one CUDA graph per input signature, so the graphs it holds
    grow with the number of distinct lane counts it has seen; none is
    evicted."""
    n = funcs.num_decision_variables
    me = funcs.num_equality_constraints
    mi = funcs.num_inequality_constraints
    if mi == 0:
        raise ValueError("the interior-point method needs inequality constraints")
    device, dtype = backend.device, backend.dtype
    syncs = backend.syncs
    tol = options.tolerance
    lanes = _BandedLanes(backend) if isinstance(backend, BandedBackend) else _DenseLanes(backend)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def on_lanes(fn):
        """vmap over lanes of fn(*lane_args, params), params shared."""
        @functools.wraps(fn)
        def call(*args):
            return vmap(fn, in_dims=(0,) * (len(args) - 1) + (None,))(*args)
        return call

    # The problem evaluations replay as CUDA graphs on the card, each one
    # captured whole around its `vmap` (`util/cuda_graph.py`).
    graphed = backend.graphs.wrap

    # -- per-lane functions (one lane's tensors, as in the serial step) ----

    def F_of(sc, params):
        return bind(funcs, params, sc, dtype)

    @graphed
    @on_lanes
    def lane_init(x0, s0, y0, z0, sc, params):
        F = F_of(sc, params)
        f, g, c_e, c_i = F.f(x0), F.g(x0), F.c_e(x0), F.c_i(x0)
        derivs = backend.eval_derivs(F, x0, y0, z0)
        finite = (
            torch.isfinite(f) & torch.isfinite(g).all() & torch.isfinite(c_e).all()
            & torch.isfinite(c_i).all() & backend.all_finite(derivs)
        )
        E0 = unscaled_kkt_error_ipm_products(
            sc, g, backend.AeT(derivs, y0), backend.AiT(derivs, z0), c_e, c_i, s0, y0, z0,
            torch.zeros((), dtype=dtype, device=device),
        )
        return f, g, c_e, c_i, derivs, finite, E0, make_filter(viol(c_e, c_i, s0))

    @on_lanes
    def top_checks(x, s, c_e, c_i, derivs, _params):
        """Local infeasibility and divergence (reference :387-408)."""
        norm = torch.linalg.vector_norm
        infeas = torch.zeros((), dtype=torch.bool, device=device)
        if me > 0:
            infeas = (norm(backend.AeT(derivs, c_e)) < 1e-6) & (norm(c_e) > 1e-2)
        c_i_plus = torch.clamp(c_i, max=0.0)
        infeas = infeas | ((norm(backend.AiT(derivs, c_i_plus)) < 1e-6) & (norm(c_i_plus) > 1e-6))
        diverging = (
            (_max_abs(x) > DIVERGENCE_LIMIT) | ~torch.isfinite(x).all()
            | (_max_abs(s) > DIVERGENCE_LIMIT) | ~torch.isfinite(s).all()
        )
        return infeas, diverging

    @on_lanes
    def kkt_rhs(g, derivs, y, v, _params):
        """The top of the Newton-KKT right-hand side, −∇f + Aₑᵀy + Aᵢᵀv
        (reference :442-448, :601-616)."""
        rhs = -g
        if me > 0:
            rhs = rhs + backend.AeT(derivs, y)
        return rhs + backend.AiT(derivs, v)

    @on_lanes
    def recover(derivs, p_x, cims, mu, s, z, sigma, _params):
        p_s = cims + backend.Ai(derivs, p_x)
        return p_s, mu / s - z - sigma * p_s

    def compute_step(derivs, sigma, fac, rhs_top, rhs_bottom, cims, mu, s, z, params):
        """Newton-KKT solve and slack/dual recovery (reference :470-481)."""
        p_x, p_y = lanes.solve_refined(derivs, sigma, fac, rhs_top, rhs_bottom)
        p_s, p_z = recover(derivs, p_x, cims, mu, s, z, sigma, params)
        return p_x, p_s, p_y, p_z

    @on_lanes
    def step_sizes(s, z, p_x, p_s, p_z, tau, f, c_e, c_i, g, mu, _params):
        D_phi = g @ p_x - mu * torch.sum(p_s / s)
        feasible_sub = (
            (c_i > 0.0).all() if options.feasible_ipm
            else torch.zeros((), dtype=torch.bool, device=device)
        )
        return (fraction_to_the_boundary(s, p_s, tau), fraction_to_the_boundary(z, p_z, tau),
                phi(f, s, mu), viol(c_e, c_i, s), D_phi, feasible_sub)

    def trial_at(F, a, px, ps, x, s, feasible_sub):
        tx = x + a * px
        tci = F.c_i(tx)
        ts = torch.where(feasible_sub, tci, s + a * ps)
        return tx, ts, F.f(tx), F.c_e(tx), tci

    @graphed
    @on_lanes
    def trip(alpha, alpha_z, p_x, p_s, p_y, p_z, x, s, y, z, mu, feasible_sub, filt,
             cost, cviol, D_phi, sc, params):
        """One trial of the backtracking line search (reference :512-556)."""
        tx, ts, tf, tce, tci = trial_at(F_of(sc, params), alpha, p_x, p_s, x, s, feasible_sub)
        nonfinite = ~(torch.isfinite(tf) & torch.isfinite(tce).all() & torch.isfinite(tci).all())
        next_viol = viol(tce, tci, ts)
        acc, filt1 = try_add(filt, cost, cviol, phi(tf, ts, mu), next_viol, D_phi, alpha)
        t = _Trial(tx, ts, y + alpha * p_y, z + alpha_z * p_z, tf, tce, tci)
        return t, nonfinite, next_viol, acc, filt1

    @graphed
    @on_lanes
    def soc_trial(x, s, y, z, p_x, p_s, p_y, p_z, tau, mu, filt, cost, cviol, D_phi, alpha, sc,
                  params):
        """A second-order correction's trial (reference :617-654)."""
        F = F_of(sc, params)
        a = fraction_to_the_boundary(s, p_s, tau)
        az = fraction_to_the_boundary(z, p_z, tau)
        tx, ts = x + a * p_x, s + a * p_s
        tf, tce, tci = F.f(tx), F.c_e(tx), F.c_i(tx)
        t = _Trial(tx, ts, y + a * p_y, z + az * p_z, tf, tce, tci)
        nv = viol(tce, tci, ts)
        acc, filt1 = try_add(filt, cost, cviol, phi(tf, ts, mu), nv, D_phi, alpha)
        return a, az, t, nv, acc, filt1

    @graphed
    @on_lanes
    def jump(alpha, p_x, p_s, x, s, mu, feasible_sub, filt_after, fsrc, cost, cviol, D_phi, sc,
             params):
        """The serial step's batched backtracking ladder (JAX step
        :587-656), per lane."""
        F = F_of(sc, params)
        idx = torch.arange(MAX_BACKTRACKS, device=device)
        alphas = alpha * ALPHA_REDUCTION_FACTOR ** torch.arange(
            1, MAX_BACKTRACKS + 1, dtype=dtype, device=device
        )
        below = alphas * ALPHA_REDUCTION_FACTOR < ALPHA_MIN
        jlast = torch.argmax(below.to(torch.uint8))

        def merit(a):
            tx, ts, tf, tce, tci = trial_at(F, a, p_x, p_s, x, s, feasible_sub)
            return phi(tf, ts, mu), viol(tce, tci, ts)

        tphis, tviols = vmap(merit)(alphas)
        accs, rejected_pres, in_filters, finites, _sw, _ar = check_acceptance(
            filt_after, cost, cviol, tphis, tviols, D_phi, alphas
        )
        rejf = finites & ~rejected_pres & in_filters
        reset_possible = (fsrc >= 4) & (filt_after.max_viol > cviol / 10.0)
        stop = accs | (reset_possible & ~accs & rejf)
        stop = (stop & (idx <= jlast)) | (idx == jlast)
        jstop = torch.argmax(stop.to(torch.uint8))
        prior = (idx < jstop) & finites
        lastp = torch.max(torch.where(prior, idx, -1))
        flag = torch.where(
            lastp >= 0, rejf[torch.clamp(lastp, min=0)], filt_after.last_rejection_due_to_filter
        )
        return alphas[jstop], flag

    @graphed
    @on_lanes
    def kkt_fallback(x, s, y, z, f, c_e, c_i, g, derivs, mu, alpha_max, alpha_z, p_x, p_s, p_y, p_z,
                     sc, params):
        """Accept the α_max step if it reduces the 1-norm KKT error
        (reference :691-716). Returns (ok, trial)."""
        F = F_of(sc, params)
        cur_err = kkt_error_ipm_one_products(
            g, backend.AeT(derivs, y), backend.AiT(derivs, z), c_e, c_i, s, y, z, mu
        )
        tx3, ts3 = x + alpha_max * p_x, s + alpha_max * p_s
        tf3, tce3, tci3, g3 = F.f(tx3), F.c_e(tx3), F.c_i(tx3), F.g(tx3)
        d3 = backend.eval_derivs(F, tx3, y, z)
        tz3 = z + alpha_z * p_z

        def err_with(ay):
            ty = y + ay * p_y
            return kkt_error_ipm_one_products(
                g3, backend.AeT(d3, ty), backend.AiT(d3, tz3), tce3, tci3, ts3, ty, tz3, mu
            )

        err_a, err_b = err_with(alpha_z), err_with(alpha_max)
        ay_best = torch.where(err_a <= err_b, alpha_z, alpha_max)
        ok = torch.minimum(err_a, err_b) <= 0.999 * cur_err
        return ok, _Trial(tx3, ts3, y + ay_best * p_y, tz3, tf3, tce3, tci3)

    @on_lanes
    def resync(x, s, y, z, f, c_e, c_i, mu, _params):
        """The slack resync's trial and whether it applies (JAX step
        :900-949)."""
        theta_after = _one_norm(c_e) + torch.sum(torch.where(c_i > 0.0, 0.0, torch.abs(c_i - s)))
        s1 = torch.where(c_i > 0.0, c_i, s)
        fixable = theta_after <= 0.1 * viol(c_e, c_i, s)
        return fixable, _Trial(x, s1, y, clamp_z(z, mu, s1), f, c_e, c_i)

    @on_lanes
    def clamp_trial_z(t, mu, _params):
        return t._replace(z=clamp_z(t.z, mu, t.s))

    @graphed
    @on_lanes
    def refresh(t, sc, params):
        """Derivatives and KKT error at an accepted iterate (reference
        :808-826)."""
        F = F_of(sc, params)
        g1 = F.g(t.x)
        d1 = backend.eval_derivs(F, t.x, t.y, t.z)
        AeT_y1, AiT_z1 = backend.AeT(d1, t.y), backend.AiT(d1, t.z)
        E0 = unscaled_kkt_error_ipm_products(
            sc, g1, AeT_y1, AiT_z1, t.c_e, t.c_i, t.s, t.y, t.z,
            torch.zeros((), dtype=dtype, device=device),
        )
        return g1, d1, AeT_y1, AiT_z1, E0

    @on_lanes
    def barrier_error(g1, AeT_y1, AiT_z1, t, mu, _params):
        return kkt_error_ipm_inf_products(g1, AeT_y1, AiT_z1, t.c_e, t.c_i, t.s, t.y, t.z, mu)

    def status_where(mask, code, status):
        return torch.where(mask, torch.full_like(status, int(code)), status)

    # -- init --------------------------------------------------------------

    def init(x0, s0, y0, z0, mu0, params, scaling) -> IPMState:
        params = tensor(params)
        scaling = ScalingArrays(*(tensor(a) for a in scaling))
        x0, s0, y0, z0, mu0 = (tensor(a) for a in (x0, s0, y0, z0, mu0))
        L = x0.shape[0]
        f, g, c_e, c_i, derivs, finite, E0, filt = lane_init(x0, s0, y0, z0, scaling, params)
        status = torch.full((L,), status_codes.RUNNING, dtype=torch.int64, device=device)
        if me > n:
            status = torch.full_like(status, int(ExitStatus.TOO_FEW_DOFS))
        else:
            status = status_where(E0 <= tol, ExitStatus.SUCCESS, status)
            status = status_where(~finite, ExitStatus.NONFINITE_INITIAL_GUESS, status)
        zero = torch.zeros(L, dtype=dtype, device=device)
        one = torch.ones(L, dtype=dtype, device=device)
        count = torch.zeros(L, dtype=torch.int64, device=device)
        return IPMState(
            x=x0, s=s0, y=y0, z=z0, mu=mu0, tau=torch.full_like(one, TAU_MIN),
            f=f, c_e=c_e, c_i=c_i, g=g, derivs=derivs, E0=E0, filt=filt,
            prev_delta=zero, delta=zero, gamma=zero,
            full_step_rejected_counter=count, iterations=count, status=status,
            alpha=one, alpha_max=one, alpha_z=one, p_pr_inf=zero, p_du_inf=zero,
            infeas_streak=count, params=params, scaling=scaling,
        )

    # -- one iteration -----------------------------------------------------

    def step(st: IPMState, run: torch.Tensor) -> IPMState:
        params, sc = st.params, st.scaling
        x, s, y, z, mu, tau = st.x, st.s, st.y, st.z, st.mu, st.tau
        f, c_e, c_i, g, derivs = st.f, st.c_e, st.c_i, st.g, st.derivs
        col = (slice(None), None)  # a (L,) scalar against (L, ·) vectors

        # Iteration-top checks; the certificate must hold 5 iterations
        # running (as the serial step).
        infeas, diverging = top_checks(x, s, c_e, c_i, derivs, params)
        streak = torch.where(run, torch.where(infeas, st.infeas_streak + 1, 0), st.infeas_streak)
        status = status_where(run & diverging, ExitStatus.DIVERGING_ITERATES, st.status)
        status = status_where(run & (streak >= 5), ExitStatus.LOCALLY_INFEASIBLE, status)
        go = run & (streak < 5) & ~diverging

        # Newton-KKT system and its factorization (reference :423-465)
        sigma = z / s
        rhs_top = kkt_rhs(g, derivs, y, -sigma * c_i + mu[col] / s + z, params)
        fac = lanes.factor(derivs, sigma, st.prev_delta, GAMMA_MIN, go)
        status = status_where(go & ~fac.ok, ExitStatus.FACTORIZATION_FAILED, status)
        go = go & fac.ok

        p_x, p_s, p_y, p_z = compute_step(
            derivs, sigma, fac, rhs_top, -c_e, c_i - s, mu, s, z, params
        )
        alpha_max, alpha_z, cost, cviol, D_phi, feasible_sub = step_sizes(
            s, z, p_x, p_s, p_z, tau, f, c_e, c_i, g, mu, params
        )

        # ---- backtracking filter line search (reference :512-717) --------
        alpha = alpha_max
        filt = st.filt
        fsrc = st.full_step_rejected_counter
        trial = _Trial(x, s, y, z, f, c_e, c_i)
        got = torch.zeros_like(go)
        ls = go & ~(alpha_max < ALPHA_MIN)
        more = syncs.read(ls.any())
        guard = 0
        while more and guard < MAX_LINE_SEARCH_TRIPS:
            guard += 1
            t, nonfinite, next_viol, acc, filt1 = trip(
                alpha, alpha_z, p_x, p_s, p_y, p_z, x, s, y, z, mu, feasible_sub, filt,
                cost, cviol, D_phi, sc, params,
            )
            at_max = alpha == alpha_max
            alpha_next = alpha * ALPHA_REDUCTION_FACTOR
            hit_min = alpha_next < ALPHA_MIN
            nf = ls & nonfinite
            live = ls & ~nonfinite

            # ---- second-order corrections (reference :557-664) ----------
            filt_after = filt1
            soc = live & ~acc & at_max & (next_viol >= cviol)
            soc_acc = torch.zeros_like(soc)
            if syncs.read(soc.any()):
                a, az, s_trial, s_p = alpha, alpha_z, t, (p_x, p_s, p_y, p_z)
                ce_soc, cims_soc, soc_viol = c_e, c_i - s, next_viol
                acc2 = torch.zeros_like(soc)
                for it in range(MAX_SOC_ITERATIONS):
                    # cₑˢᵒᶜ = αˢᵒᶜcₑ + cₑ(trial) (reference :601-616)
                    ce_new = a[col] * ce_soc + s_trial.c_e
                    cims_new = a[col] * cims_soc + s_trial.c_i - s_trial.s
                    rhs2 = kkt_rhs(g, derivs, y, mu[col] / s - sigma * cims_new, params)
                    p2 = compute_step(derivs, sigma, fac, rhs2, -ce_new, cims_new, mu, s, z, params)
                    a2, az2, t2, nv, acc2_new, filt2 = soc_trial(
                        x, s, y, z, *p2, tau, mu, filt_after, cost, cviol, D_phi, alpha, sc, params
                    )
                    # Stop when accepted, when the violation reduction
                    # stalls (reference :648-654), or after 5 corrections.
                    stalled = nv > KAPPA_SOC * soc_viol
                    ce_soc, cims_soc = merge(soc, ce_new, ce_soc), merge(soc, cims_new, cims_soc)
                    a, az = merge(soc, a2, a), merge(soc, az2, az)
                    s_trial, s_p = merge(soc, t2, s_trial), merge(soc, p2, s_p)
                    filt_after = merge(soc, filt2, filt_after)
                    acc2 = merge(soc, acc2_new, acc2)
                    soc_viol = merge(soc, nv, soc_viol)
                    soc = soc & ~acc2_new & ~stalled
                    if it + 1 < MAX_SOC_ITERATIONS and not syncs.read(soc.any()):
                        break
                soc_acc = live & acc2
                alpha, alpha_z = merge(soc_acc, a, alpha), merge(soc_acc, az, alpha_z)
                p_x, p_s, p_y, p_z = merge(soc_acc, s_p, (p_x, p_s, p_y, p_z))
                t = merge(soc_acc, s_trial, t)

            accepted = live & (acc | soc_acc)
            trial = merge(accepted, t, trial)
            filt = merge(accepted, filt_after, filt)
            got = got | accepted

            # Full-step rejection counter (reference :666-671)
            rej = live & ~accepted
            fsrc = fsrc + (rej & at_max).to(fsrc.dtype)
            # Filter reset heuristic (reference :673-684)
            reset = (rej & (fsrc >= 4) & (filt_after.max_viol > cviol / 10.0)
                     & filt_after.last_rejection_due_to_filter)
            cleared = reset_filter(filt_after)._replace(max_viol=filt_after.max_viol * 0.1)
            filt = merge(reset, cleared, filt)
            # KKT-error-reduction fallback at the minimum step (:691-716)
            at_floor = rej & ~reset & hit_min
            jumping = rej & ~reset & ~hit_min
            ls = (ls & ~accepted & ~at_floor & ~(nf & hit_min))
            more, any_floor, any_jump = syncs.read(ls.any(), at_floor.any(), jumping.any())
            alpha = torch.where(nf | at_floor, alpha_next, alpha)
            filt = merge(at_floor, filt_after, filt)
            if any_floor:
                ok3, t3 = kkt_fallback(x, s, y, z, f, c_e, c_i, g, derivs, mu, alpha_max, alpha_z,
                                       p_x, p_s, p_y, p_z, sc, params)
                trial = merge(at_floor & ok3, t3, trial)
                got = got | (at_floor & ok3)
            if any_jump:
                a_j, flag = jump(alpha, p_x, p_s, x, s, mu, feasible_sub, filt_after, fsrc,
                                 cost, cviol, D_phi, sc, params)
                alpha = torch.where(jumping, a_j, alpha)
                filt = merge(jumping, filt_after._replace(last_rejection_due_to_filter=flag), filt)

        # ---- post-line-search update (reference :721-862) ----------------
        fsrc = torch.where(got & (alpha == alpha_max), 0, fsrc)
        fixable, t_resync = resync(x, s, y, z, f, c_e, c_i, mu, params)
        resynced = go & ~got & fixable
        fin = got | resynced
        t_fin = merge(got, clamp_trial_z(trial, mu, params), t_resync)
        # θ changed discontinuously at a resync; old filter entries would
        # block the next steps, so clear them.
        filt = merge(resynced, reset_filter(filt), filt)
        g1, d1, AeT_y1, AiT_z1, E0 = refresh(t_fin, sc, params)

        # Barrier update (reference :827-831)
        mu_min = sc.f * tol / 10.0
        mu1, tau1 = mu, tau
        lowering = fin & (E0 > tol)
        while True:
            E_mu = barrier_error(g1, AeT_y1, AiT_z1, t_fin, mu1, params)
            lowering = lowering & (mu1 > mu_min) & (E_mu <= KAPPA_EPSILON * mu1)
            if not syncs.read(lowering.any()):
                break
            mu_next = torch.maximum(mu_min, torch.minimum(KAPPA_MU * mu1, mu1**THETA_MU))
            mu1 = torch.where(lowering, mu_next, mu1)
            tau1 = torch.where(lowering, torch.clamp(1.0 - mu1, min=TAU_MIN), tau1)
            filt = merge(lowering, reset_filter(filt), filt)

        iterations = st.iterations + fin.to(torch.int64)
        fin_status = torch.where(
            iterations >= options.max_iterations,
            int(ExitStatus.MAX_ITERATIONS_EXCEEDED),
            torch.where(E0 <= tol, int(ExitStatus.SUCCESS), status_codes.RUNNING),
        )
        status = torch.where(fin, fin_status, status)
        # A lane whose line search failed asks for restoration (:721-767).
        status = status_where(go & ~fin, status_codes.FEASIBILITY_RESTORATION_REQUESTED, status)
        p_pr = torch.maximum(vmap(_max_abs)(p_x), vmap(_max_abs)(p_s))
        p_du = torch.maximum(vmap(_max_abs)(p_y), vmap(_max_abs)(p_z))
        return st._replace(
            x=merge(fin, t_fin.x, x), s=merge(fin, t_fin.s, s),
            y=merge(fin, t_fin.y, y), z=merge(fin, t_fin.z, z),
            mu=merge(fin, mu1, mu), tau=merge(fin, tau1, tau),
            f=merge(fin, t_fin.f, f), c_e=merge(fin, t_fin.c_e, c_e),
            c_i=merge(fin, t_fin.c_i, c_i),
            g=merge(fin, g1, g), derivs=merge(fin, d1, derivs), E0=merge(fin, E0, st.E0),
            filt=merge(go, filt, st.filt),
            prev_delta=merge(go, fac.delta, st.prev_delta),
            delta=merge(go, fac.delta, st.delta), gamma=merge(go, fac.gamma, st.gamma),
            full_step_rejected_counter=merge(got, fsrc, st.full_step_rejected_counter),
            iterations=iterations, status=status,
            alpha=merge(go, alpha, st.alpha),
            alpha_max=merge(got, alpha_max, st.alpha_max),
            alpha_z=merge(got, alpha_z, st.alpha_z),
            p_pr_inf=merge(got, p_pr, st.p_pr_inf), p_du_inf=merge(got, p_du, st.p_du_inf),
            infeas_streak=streak,
        )

    return init, step
