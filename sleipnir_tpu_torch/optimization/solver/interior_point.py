"""Interior-point method: one host-driven step over device tensors.

Port of `sleipnir_tpu/optimization/solver/interior_point.py` (reference
solver/interior_point.hpp:63-866, a Wächter-Biegler primal-dual IPM with
filter line search). The arithmetic is the JAX step's, on torch tensors.
Where the JAX step branches on device with `lax.cond`/`lax.while_loop`
(line search, second-order corrections, barrier update), this one reads
the deciding booleans to the host through `HostSyncs` and branches in
Python. Counters (iterations, status, streaks) are host integers. The
problem evaluations of the step (values and derivatives at a point, a
line-search trial, the α ladder, the KKT-error fallback) are functions of
tensors that replay as CUDA graphs on the card (`util/cuda_graph.py`).

Feasibility restoration solves a problem of another shape, so a step
that needs it ends with status FEASIBILITY_RESTORATION_REQUESTED and
`run_solver` hands the state to a restoration handler
(`util/feasibility_restoration.py`), which runs a second instance of this
solver in restoration mode and gives the parent its iterate back through
`resume`. In restoration mode γ_min is 0, an early-stop check may end the
solve as CALLBACK_REQUESTED_STOP, and a step that would request
restoration again fails the solve (reference :721-767).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import (
    IPMFunctions,
    ScalingArrays,
    bind,
)
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.util.cuda_graph import at
from sleipnir_tpu_torch.optimization.solver.util.filter import (
    FilterState,
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

# Constants from the reference
TAU_MIN = 0.99  # interior_point.hpp:298
ALPHA_REDUCTION_FACTOR = 0.5  # :355
ALPHA_MIN = 1e-7  # :356
KAPPA_SOC = 0.99  # :646
KAPPA_SIGMA = 1e10  # :798
KAPPA_EPSILON = 10.0  # :821
KAPPA_MU = 0.2  # :310
THETA_MU = 1.5  # :314
MAX_SOC_ITERATIONS = 5  # :574
MAX_LINE_SEARCH_TRIPS = 64  # safety net (α halves from 1 past 1e-7 in 24)
MAX_BACKTRACKS = 24  # α ≤ 1 halves below ALPHA_MIN within 24 steps
DIVERGENCE_LIMIT = 1e10  # :405
GAMMA_MIN = 1e-10  # :350-352


class IPMState(NamedTuple):
    """Interior-point solver state: the reference's (x, s, y, z, μ,
    iterations) in/out parameters (interior_point.hpp:122-134) plus the
    cached callback values it keeps in locals."""

    x: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor
    tau: torch.Tensor
    f: torch.Tensor
    c_e: torch.Tensor
    c_i: torch.Tensor
    g: torch.Tensor
    #: Backend-specific derivative storage (dense matrices or banded blocks).
    derivs: object
    E0: torch.Tensor
    filt: FilterState
    prev_delta: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    full_step_rejected_counter: int
    iterations: int
    status: int
    alpha: torch.Tensor
    alpha_max: torch.Tensor
    alpha_z: torch.Tensor
    #: Diagnostics: ∞-norms of the last accepted primal/dual steps.
    p_pr_inf: torch.Tensor
    p_du_inf: torch.Tensor
    #: Consecutive iterations the local-infeasibility certificate has held.
    infeas_streak: int
    #: Runtime parameter vector (non-decision variables; see funcs.bind).
    params: torch.Tensor
    #: Problem scaling, recomputed per solve at x0 (reference problem.hpp:616).
    scaling: ScalingArrays


class _Trial(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    f: torch.Tensor
    c_e: torch.Tensor
    c_i: torch.Tensor


def _one_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(v)) if v.shape[0] > 0 else v.new_zeros(())


def _max_abs(v: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(v)) if v.numel() else v.new_zeros(())


def phi(f, s, mu):
    """Log-barrier merit φ_μ(x, s) = f − μ Σ ln sᵢ (reference :504)."""
    return f - mu * torch.sum(torch.log(s))


def viol(c_e, c_i, s):
    """Constraint violation θ = ‖cₑ‖₁ + ‖cᵢ − s‖₁ (filter.hpp:53-57)."""
    return _one_norm(c_e) + _one_norm(c_i - s)


def clamp_z(z, mu, s):
    """z clamped to the κ_Σ band around μ/s (reference :784-801)."""
    return torch.clamp(z, (1.0 / KAPPA_SIGMA) * mu / s, KAPPA_SIGMA * mu / s)


def make_interior_point(
    funcs: IPMFunctions,
    options: Options,
    *,
    backend,
    in_feasibility_restoration: bool = False,
    stop_check: Callable | None = None,
):
    """Build (init, step, resume) for the IPM on a fixed problem shape.

    `backend` is the KKT backend (`kkt_backend.DenseBackend`, or
    `kkt_banded.BandedBackend` for direct-transcription OCP structure).
    `stop_check(x, s, params) -> bool tensor` is read at the top of every
    iteration; when it holds the solve ends as CALLBACK_REQUESTED_STOP
    (feasibility restoration's early exit, reference
    interior_point.hpp:738-756)."""
    n = funcs.num_decision_variables
    me = funcs.num_equality_constraints
    mi = funcs.num_inequality_constraints
    if mi == 0:
        raise ValueError("the interior-point method needs inequality constraints")
    device, dtype = backend.device, backend.dtype
    syncs = backend.syncs
    tol = options.tolerance
    # Constraint regularization is forced to zero in feasibility
    # restoration because A_e can't be rank-deficient there (reference
    # :350-352).
    gamma_min = 0.0 if in_feasibility_restoration else GAMMA_MIN

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # -- problem evaluations (CUDA graphs on the card) ----------------------

    graphs = backend.graphs

    def trial_at(F, a, px, ps, x, s, feasible_sub):
        tx = x + a * px
        tci = F.c_i(tx)
        ts = torch.where(feasible_sub, tci, s + a * ps)
        return tx, ts, F.f(tx), F.c_e(tx), tci

    @graphs.wrap
    def evaluate(x, y, z, params, sc):
        """f, g, cₑ, cᵢ and the backend's derivatives at x."""
        F = bind(funcs, params, sc, dtype)
        return F.f(x), F.g(x), F.c_e(x), F.c_i(x), backend.eval_derivs(F, x, y, z)

    @graphs.wrap
    def values(x, params, sc):
        F = bind(funcs, params, sc, dtype)
        return F.f(x), F.c_e(x), F.c_i(x)

    @graphs.wrap
    def refresh(t: _Trial, params, sc):
        """Derivatives and KKT error at an accepted iterate (reference
        :808-826)."""
        F = bind(funcs, params, sc, dtype)
        g1 = F.g(t.x)
        d1 = backend.eval_derivs(F, t.x, t.y, t.z)
        AeT_y1, AiT_z1 = backend.AeT(d1, t.y), backend.AiT(d1, t.z)
        E0 = unscaled_kkt_error_ipm_products(
            sc, g1, AeT_y1, AiT_z1, t.c_e, t.c_i, t.s, t.y, t.z, t.x.new_zeros(())
        )
        return g1, d1, AeT_y1, AiT_z1, E0

    @graphs.wrap
    def trip(alpha, alpha_z, p_x, p_s, p_y, p_z, x, s, y, z, mu, feasible_sub, filt,
             cost, cviol, D_phi, params, sc):
        """One trial of the backtracking line search (reference :512-556)."""
        tx, ts, tf, tce, tci = trial_at(bind(funcs, params, sc, dtype), alpha, p_x, p_s, x, s,
                                        feasible_sub)
        nonfinite = ~(torch.isfinite(tf) & torch.isfinite(tce).all() & torch.isfinite(tci).all())
        next_viol = viol(tce, tci, ts)
        acc, filt1 = try_add(filt, cost, cviol, phi(tf, ts, mu), next_viol, D_phi, alpha)
        t = _Trial(tx, ts, y + alpha * p_y, z + alpha_z * p_z, tf, tce, tci)
        return t, nonfinite, next_viol, acc, filt1

    @graphs.wrap
    def soc_trial(x, s, y, z, p_x, p_s, p_y, p_z, tau, mu, filt, cost, cviol, D_phi, alpha,
                  params, sc):
        """A second-order correction's trial (reference :617-654)."""
        F = bind(funcs, params, sc, dtype)
        a = fraction_to_the_boundary(s, p_s, tau)
        az = fraction_to_the_boundary(z, p_z, tau)
        tx, ts = x + a * p_x, s + a * p_s
        tf, tce, tci = F.f(tx), F.c_e(tx), F.c_i(tx)
        # Equality duals step with the primal α (as the line search's).
        t = _Trial(tx, ts, y + a * p_y, z + az * p_z, tf, tce, tci)
        nv = viol(tce, tci, ts)
        acc, filt1 = try_add(filt, cost, cviol, phi(tf, ts, mu), nv, D_phi, alpha)
        return a, az, t, nv, acc, filt1

    @graphs.wrap
    def jump(alpha, p_x, p_s, x, s, mu, feasible_sub, filt_after, reset_counted: bool,
             cost, cviol, D_phi, params, sc):
        """Batched backtracking ladder (JAX step :587-656): evaluate all
        remaining halvings of α against the current filter at once —
        filter entries only change on acceptance, which ends the
        backtracking — and land on the first candidate the sequential
        loop would stop at. `reset_counted` is whether the full-step
        rejection counter has reached 4. Returns (α,
        last_rejection_due_to_filter)."""
        F = bind(funcs, params, sc, dtype)
        idx = torch.arange(MAX_BACKTRACKS, device=x.device)
        alphas = alpha * ALPHA_REDUCTION_FACTOR ** torch.arange(
            1, MAX_BACKTRACKS + 1, dtype=dtype, device=x.device
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
        reset_possible = reset_counted & (filt_after.max_viol > cviol / 10.0)
        stop = accs | (reset_possible & ~accs & rejf)
        stop = (stop & (idx <= jlast)) | (idx == jlast)
        jstop = torch.argmax(stop.to(torch.uint8))
        # last_rejection_due_to_filter entering the landing trip: set by
        # the last finite rejected trial jumped over.
        prior = (idx < jstop) & finites
        lastp = torch.max(torch.where(prior, idx, -1))
        flag = torch.where(
            lastp >= 0,
            at(rejf, torch.clamp(lastp, min=0)),
            filt_after.last_rejection_due_to_filter,
        )
        return at(alphas, jstop), flag

    @graphs.wrap
    def kkt_fallback(x, s, y, z, f, c_e, c_i, g, derivs, mu, alpha_max, alpha_z,
                     p_x, p_s, p_y, p_z, params, sc):
        """Whether the α_max step reduces the 1-norm KKT error (reference
        :691-716), and that step's trial."""
        F = bind(funcs, params, sc, dtype)
        cur_err = kkt_error_ipm_one_products(
            g, backend.AeT(derivs, y), backend.AiT(derivs, z), c_e, c_i, s, y, z, mu
        )
        tx3, ts3 = x + alpha_max * p_x, s + alpha_max * p_s
        tf3, tce3, tci3, g3 = F.f(tx3), F.c_e(tx3), F.c_i(tx3), F.g(tx3)
        # The Jacobians are independent of the duals: one evaluation
        # at tx3 serves both candidates below.
        d3 = backend.eval_derivs(F, tx3, y, z)
        tz3 = z + alpha_z * p_z

        def err_with(ay):
            ty = y + ay * p_y
            return kkt_error_ipm_one_products(
                g3, backend.AeT(d3, ty), backend.AiT(d3, tz3), tce3, tci3, ts3, ty, tz3, mu
            )

        # Candidate y-step sizes: the reference's α_z and Ipopt's primal
        # α; the lower 1-norm KKT error wins.
        err_a, err_b = err_with(alpha_z), err_with(alpha_max)
        ay_best = torch.where(err_a <= err_b, alpha_z, alpha_max)
        ok = torch.minimum(err_a, err_b) <= 0.999 * cur_err
        return ok, _Trial(tx3, ts3, y + ay_best * p_y, tz3, tf3, tce3, tci3)

    stop_graph = graphs.wrap(stop_check, "stop_check") if stop_check is not None else None

    # -- init --------------------------------------------------------------

    def init(x0, s0, y0, z0, mu0, iterations0, params, scaling) -> IPMState:
        params = tensor(params)
        scaling = ScalingArrays(*(tensor(a) for a in scaling))
        x0, s0, y0, z0 = (tensor(a) for a in (x0, s0, y0, z0))
        f, g, c_e, c_i, derivs = evaluate(x0, y0, z0, params, scaling)
        finite = (
            torch.isfinite(f)
            & torch.isfinite(g).all()
            & torch.isfinite(c_e).all()
            & torch.isfinite(c_i).all()
            & backend.all_finite(derivs)
        )
        E0 = unscaled_kkt_error_ipm_products(
            scaling, g, backend.AeT(derivs, y0), backend.AiT(derivs, z0),
            c_e, c_i, s0, y0, z0, tensor(0.0),
        )
        if me > n:
            status = int(ExitStatus.TOO_FEW_DOFS)
        else:
            finite_b, converged_b = syncs.read(finite, E0 <= tol)
            if not finite_b:
                status = int(ExitStatus.NONFINITE_INITIAL_GUESS)
            elif converged_b:
                status = int(ExitStatus.SUCCESS)
            else:
                status = status_codes.RUNNING
        zero = tensor(0.0)
        one = tensor(1.0)
        return IPMState(
            x=x0, s=s0, y=y0, z=z0,
            mu=tensor(mu0), tau=tensor(TAU_MIN),
            f=f, c_e=c_e, c_i=c_i, g=g, derivs=derivs, E0=E0,
            filt=make_filter(viol(c_e, c_i, s0)),
            prev_delta=zero, delta=zero, gamma=zero,
            full_step_rejected_counter=0,
            iterations=int(iterations0),
            status=status,
            alpha=one, alpha_max=one, alpha_z=one,
            p_pr_inf=zero, p_du_inf=zero,
            infeas_streak=0,
            params=params,
            scaling=scaling,
        )

    # -- per-iteration body ------------------------------------------------

    def finish_iteration(st: IPMState, t: _Trial, iterations: int) -> IPMState:
        """Refresh derivatives, the KKT error and the barrier parameter
        after an accepted step (reference :808-862)."""
        g1, derivs1, AeT_y1, AiT_z1, E0 = refresh(t, st.params, st.scaling)

        # Barrier parameter minimum μ_min = d_f·tol/10 (reference :294)
        mu_min = st.scaling.f * tol / 10.0
        mu, tau, filt = st.mu, st.tau, st.filt
        E0_h = syncs.read(E0)
        if E0_h > tol:
            while True:
                E_mu = kkt_error_ipm_inf_products(
                    g1, AeT_y1, AiT_z1, t.c_e, t.c_i, t.s, t.y, t.z, mu
                )
                if not syncs.read((mu > mu_min) & (E_mu <= KAPPA_EPSILON * mu)):
                    break
                mu = torch.maximum(mu_min, torch.minimum(KAPPA_MU * mu, mu**THETA_MU))
                tau = torch.clamp(1.0 - mu, min=TAU_MIN)
                filt = reset_filter(filt)

        if iterations >= options.max_iterations:
            status = int(ExitStatus.MAX_ITERATIONS_EXCEEDED)
        elif E0_h <= tol:
            status = int(ExitStatus.SUCCESS)
        else:
            status = status_codes.RUNNING
        return st._replace(
            x=t.x, s=t.s, y=t.y, z=t.z, mu=mu, tau=tau,
            f=t.f, c_e=t.c_e, c_i=t.c_i, g=g1, derivs=derivs1, E0=E0,
            filt=filt, iterations=iterations, status=status,
        )

    def iteration_body(st: IPMState) -> IPMState:
        params, sc = st.params, st.scaling
        x, s, y, z = st.x, st.s, st.y, st.z
        mu, tau = st.mu, st.tau
        f, c_e, c_i = st.f, st.c_e, st.c_i
        g, derivs = st.g, st.derivs

        # Σ = S⁻¹Z (reference :423-426)
        sigma = z / s

        # rhs = −[∇f − Aₑᵀy − Aᵢᵀ(−Σcᵢ + μS⁻¹e + z); cₑ] (reference :442-448)
        rhs_top = -g
        if me > 0:
            rhs_top = rhs_top + backend.AeT(derivs, y)
        rhs_top = rhs_top + backend.AiT(derivs, -sigma * c_i + mu / s + z)

        # Assemble and factor [H + AᵢᵀΣAᵢ, Aₑᵀ; Aₑ, 0] with inertia
        # correction (reference :428-465)
        fac = backend.factor(derivs, sigma, st.prev_delta, gamma_min)
        if not fac.ok:
            return st._replace(status=int(ExitStatus.FACTORIZATION_FAILED))

        def compute_step(rhs_top_vec, rhs_bottom_vec, c_i_minus_s):
            """Newton-KKT solve and slack/dual recovery (reference :470-481)."""
            p_x, p_y = backend.solve_refined(derivs, sigma, fac, rhs_top_vec, rhs_bottom_vec)
            p_s = c_i_minus_s + backend.Ai(derivs, p_x)
            p_z = mu / s - z - sigma * p_s
            return p_x, p_s, p_y, p_z

        p_x, p_s, p_y, p_z = compute_step(rhs_top, -c_e, c_i - s)

        # Fraction-to-the-boundary (reference :487-497)
        alpha_max = fraction_to_the_boundary(s, p_s, tau)
        alpha_z = fraction_to_the_boundary(z, p_z, tau)

        current_cost = phi(f, s, mu)
        current_viol = viol(c_e, c_i, s)

        # D_ϕ = ∇f·pˣ − μ Σᵢ pᵢˢ/sᵢ (reference :501-509)
        D_phi = g @ p_x - mu * torch.sum(p_s / s)

        # Feasible IPM: keep feasible inequalities feasible (reference :515-523)
        feasible_sub = (
            (c_i > 0.0).all()
            if options.feasible_ipm
            else torch.zeros((), dtype=torch.bool, device=device)
        )

        # ---- backtracking filter line search (reference :512-717) --------
        alpha = alpha_max
        filt = st.filt
        fsrc = st.full_step_rejected_counter
        trial = None
        guard = 0
        done = bool(syncs.read(alpha_max < ALPHA_MIN))
        while not done and guard < MAX_LINE_SEARCH_TRIPS:
            guard += 1
            t, nonfinite, next_viol, acc, filt1 = trip(
                alpha, alpha_z, p_x, p_s, p_y, p_z, x, s, y, z, mu, feasible_sub, filt,
                current_cost, current_viol, D_phi, params, sc,
            )
            at_max = alpha == alpha_max
            alpha_next = alpha * ALPHA_REDUCTION_FACTOR
            nonfinite_b, acc_b, at_max_b, hit_min_b, worse_b = syncs.read(
                nonfinite, acc, at_max, alpha_next < ALPHA_MIN, next_viol >= current_viol
            )
            if nonfinite_b:
                alpha = alpha_next
                done = bool(hit_min_b)
                continue

            # ---- second-order corrections (reference :557-664) -----------
            filt_after = filt1
            soc_accepted = False
            if not acc_b and at_max_b and worse_b:
                a, soc_t = alpha, t
                ce_soc, cims_soc, soc_viol = c_e, c_i - s, next_viol
                for it in range(MAX_SOC_ITERATIONS):
                    # cₑˢᵒᶜ = αˢᵒᶜcₑ + cₑ(trial) (reference :601-616)
                    ce_soc = a * ce_soc + soc_t.c_e
                    cims_soc = a * cims_soc + soc_t.c_i - soc_t.s
                    rhs_top2 = -g
                    if me > 0:
                        rhs_top2 = rhs_top2 + backend.AeT(derivs, y)
                    rhs_top2 = rhs_top2 + backend.AiT(derivs, mu / s - sigma * cims_soc)
                    soc_p = compute_step(rhs_top2, -ce_soc, cims_soc)
                    a, az2, soc_t, nv, acc2, filt_after = soc_trial(
                        x, s, y, z, *soc_p, tau, mu, filt_after, current_cost, current_viol,
                        D_phi, alpha, params, sc,
                    )
                    # Stop when accepted, when the violation reduction
                    # stalls (reference :648-654), or after 5 corrections.
                    acc2_b, stalled_b = syncs.read(acc2, nv > KAPPA_SOC * soc_viol)
                    soc_viol = nv
                    if acc2_b or stalled_b:
                        break
                soc_accepted = bool(acc2_b)

            if acc_b or soc_accepted:
                if soc_accepted:
                    alpha, alpha_z = a, az2
                    p_x, p_s, p_y, p_z = soc_p
                    trial = soc_t
                else:
                    trial = t
                filt = filt_after
                break

            # Full-step rejection counter (reference :666-671)
            if at_max_b:
                fsrc += 1

            # Filter reset heuristic (reference :673-684)
            if fsrc >= 4 and syncs.read(
                (filt_after.max_viol > current_viol / 10.0)
                & filt_after.last_rejection_due_to_filter
            ):
                filt = reset_filter(filt_after)._replace(max_viol=filt_after.max_viol * 0.1)
                continue

            if hit_min_b:
                # KKT-error-reduction fallback at minimum step (:691-716);
                # if it fails the line search ends and restoration is due.
                alpha, filt = alpha_next, filt_after
                ok, trial3 = kkt_fallback(
                    x, s, y, z, f, c_e, c_i, g, derivs, mu, alpha_max, alpha_z,
                    p_x, p_s, p_y, p_z, params, sc,
                )
                if syncs.read(ok):
                    trial = trial3
                break

            alpha, flag = jump(alpha, p_x, p_s, x, s, mu, feasible_sub, filt_after, fsrc >= 4,
                               current_cost, current_viol, D_phi, params, sc)
            filt = filt_after._replace(last_rejection_due_to_filter=flag)

        # ---- post-line-search update (reference :721-862) ----------------
        factored = dict(prev_delta=fac.delta, delta=fac.delta, gamma=fac.gamma)
        if trial is not None:
            if syncs.read(alpha == alpha_max):
                fsrc = 0
            p_pr = torch.maximum(_max_abs(p_x), _max_abs(p_s))
            p_du = torch.maximum(_max_abs(p_y), _max_abs(p_z))
            return finish_iteration(
                st._replace(
                    filt=filt, full_step_rejected_counter=fsrc, alpha=alpha,
                    alpha_max=alpha_max, alpha_z=alpha_z, p_pr_inf=p_pr, p_du_inf=p_du,
                    **factored,
                ),
                trial._replace(z=clamp_z(trial.z, mu, trial.s)),
                st.iterations + 1,
            )

        # ---- slack resync before restoration -------------------------------
        # The line search can collapse at an iterate that is feasible but
        # whose slacks drifted from cᵢ(x), so θ is dominated by slack
        # desynchronization. Resynchronize s ← cᵢ(x) wherever cᵢ > 0 when
        # that removes ≥90% of θ (JAX step :900-949); a repeat failure at
        # the same iterate has nothing left to remove and asks for
        # restoration instead.
        theta_after = _one_norm(c_e) + torch.sum(torch.where(c_i > 0.0, 0.0, torch.abs(c_i - s)))
        if syncs.read(theta_after <= 0.1 * viol(c_e, c_i, s)):
            s1 = torch.where(c_i > 0.0, c_i, s)
            # θ changed discontinuously; old filter entries would block the
            # next steps, so clear them.
            return finish_iteration(
                st._replace(filt=reset_filter(filt), alpha=alpha, **factored),
                _Trial(x, s1, y, clamp_z(z, mu, s1), f, c_e, c_i),
                st.iterations + 1,
            )
        # Request restoration from `run_solver` (reference :721-767); if
        # already restoring, fail (:726-728). The restoration early-stop
        # check reuses the line search's final α (reference :755).
        return st._replace(
            status=int(ExitStatus.FEASIBILITY_RESTORATION_FAILED)
            if in_feasibility_restoration
            else status_codes.FEASIBILITY_RESTORATION_REQUESTED,
            filt=filt, alpha=alpha, **factored,
        )

    def resume(st: IPMState, x1, s1, y1, z1, iterations: int) -> IPMState:
        """Resume the solve after feasibility restoration updated the
        iterates (reference :769-771 then :808-862)."""
        x1, s1, y1, z1 = (tensor(a) for a in (x1, s1, y1, z1))
        trial = _Trial(x1, s1, y1, z1, *values(x1, st.params, st.scaling))
        return finish_iteration(st, trial, int(iterations) + 1)

    # -- full step with iteration-top checks -------------------------------

    def step(st: IPMState) -> IPMState:
        # Local infeasibility and divergence checks (reference :387-408 and
        # solver/util/is_locally_infeasible.hpp:18-61)
        norm = torch.linalg.vector_norm
        infeas = torch.zeros((), dtype=torch.bool, device=device)
        if me > 0:
            infeas = (norm(backend.AeT(st.derivs, st.c_e)) < 1e-6) & (norm(st.c_e) > 1e-2)
        c_i_plus = torch.clamp(st.c_i, max=0.0)
        infeas = infeas | (
            (norm(backend.AiT(st.derivs, c_i_plus)) < 1e-6) & (norm(c_i_plus) > 1e-6)
        )
        diverging = (
            (_max_abs(st.x) > DIVERGENCE_LIMIT)
            | ~torch.isfinite(st.x).all()
            | (_max_abs(st.s) > DIVERGENCE_LIMIT)
            | ~torch.isfinite(st.s).all()
        )
        requested_stop = (
            stop_graph(st.x, st.s, st.params) if stop_graph is not None
            else torch.zeros((), dtype=torch.bool, device=device)
        )
        infeas_b, diverging_b, stop_b = syncs.read(infeas, diverging, requested_stop)
        # The certificate must persist for 5 consecutive iterations (a
        # robustness improvement over the reference's first crossing,
        # interior_point.hpp:387-403; JAX step :983-990).
        st = st._replace(infeas_streak=st.infeas_streak + 1 if infeas_b else 0)
        if st.infeas_streak >= 5:
            return st._replace(status=int(ExitStatus.LOCALLY_INFEASIBLE))
        if diverging_b:
            return st._replace(status=int(ExitStatus.DIVERGING_ITERATES))
        if stop_b:
            return st._replace(status=int(ExitStatus.CALLBACK_REQUESTED_STOP))
        return iteration_body(st)

    return init, step, resume
