"""Sequential quadratic programming for equality-constrained problems: one
host-driven step over device tensors.

Port of `sleipnir_tpu/optimization/solver/sqp.py` (reference
solver/sqp.hpp:91-596): the interior-point skeleton without slacks and
barrier. The KKT system [H Aₑᵀ; Aₑ 0] is factored by the backend with
inertia correction (dense, or banded for direct-transcription OCPs), and
a filter line search with second-order corrections, the batched
backtracking ladder and the accept-if-KKT-error-reduced fallback chooses
the step. A step that finds no acceptable point ends with status
FEASIBILITY_RESTORATION_REQUESTED for `run_solver`'s restoration handler.
Where the JAX step branches on device, this one reads the deciding
booleans through `HostSyncs` and branches in Python; the problem
evaluations replay as CUDA graphs on the card (`util/cuda_graph.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import (
    IPMFunctions,
    ScalingArrays,
    SQPFunctions,
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
    kkt_error_sqp_one_products,
    unscaled_kkt_error_sqp_products,
)

ALPHA_REDUCTION_FACTOR = 0.5  # sqp.hpp:237
ALPHA_MIN = 1e-7  # sqp.hpp:238
MAX_BACKTRACKS = 24  # α ≤ 1 halves below ALPHA_MIN within 24 steps
KAPPA_SOC = 0.99  # sqp.hpp:440
MAX_SOC_ITERATIONS = 5  # sqp.hpp:390
MAX_LINE_SEARCH_TRIPS = 64
DIVERGENCE_LIMIT = 1e10  # sqp.hpp:273
GAMMA_MIN = 1e-10


class SQPState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor
    c_e: torch.Tensor
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
    #: Consecutive iterations the local-infeasibility certificate has held.
    infeas_streak: int
    #: Runtime parameter vector (non-decision variables; see funcs.bind).
    params: torch.Tensor
    #: Problem scaling, recomputed per solve at x0 (reference problem.hpp:477).
    scaling: ScalingArrays


class _Trial(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor
    c_e: torch.Tensor


def _one_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(v)) if v.shape[0] > 0 else v.new_zeros(())


def make_sqp(funcs: SQPFunctions, options: Options, *, backend):
    """Build (init, step, resume) for SQP on a fixed problem shape, on the
    KKT backend `backend` (`kkt_backend.DenseBackend`, or
    `kkt_banded.BandedBackend` for direct-transcription OCP structure:
    the same seam as the interior-point method)."""
    n = funcs.num_decision_variables
    me = funcs.num_equality_constraints
    device, dtype = backend.device, backend.dtype
    syncs = backend.syncs
    tol = options.tolerance

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    empty = torch.zeros(0, dtype=dtype, device=device)
    # The backends take (y, z)-dual callbacks; with mᵢ = 0, Aᵢ and cᵢ
    # are empty.
    ipm_funcs = IPMFunctions(
        num_decision_variables=n,
        num_equality_constraints=me,
        num_inequality_constraints=0,
        f=funcs.f,
        g=funcs.g,
        c_e=funcs.c_e,
        c_i=lambda x, p, sc: empty,
        H=lambda x, y, z, p, sc: funcs.H(x, y, p, sc),
        H_c=lambda x, y, z, p, sc: funcs.H_c(x, y, p, sc),
        A_e=funcs.A_e,
        A_i=lambda x, p, sc: torch.zeros((0, n), dtype=dtype, device=device),
    )

    # -- problem evaluations (CUDA graphs on the card) ----------------------

    graphs = backend.graphs

    @graphs.wrap
    def evaluate(x, y, params, sc):
        """f, g, cₑ and the backend's derivatives at x."""
        F = bind(funcs, params, sc, dtype)
        Fi = bind(ipm_funcs, params, sc, dtype)
        return F.f(x), F.g(x), F.c_e(x), backend.eval_derivs(Fi, x, y, empty)

    @graphs.wrap
    def values(x, params, sc):
        F = bind(funcs, params, sc, dtype)
        return F.f(x), F.c_e(x)

    @graphs.wrap
    def refresh(x, y, c_e, params, sc):
        """Derivatives and KKT error at an accepted iterate (reference
        sqp.hpp:560-575)."""
        F = bind(funcs, params, sc, dtype)
        g1 = F.g(x)
        d1 = backend.eval_derivs(bind(ipm_funcs, params, sc, dtype), x, y, empty)
        return g1, d1, unscaled_kkt_error_sqp_products(sc, g1, backend.AeT(d1, y), c_e, y)

    @graphs.wrap
    def trial_at(a, px, py, x, y, params, sc):
        F = bind(funcs, params, sc, dtype)
        tx = x + a * px
        return _Trial(tx, y + a * py, F.f(tx), F.c_e(tx))

    @graphs.wrap
    def jump(alpha, p_x, x, f, filt_after, reset_counted: bool, current_viol, D_phi, params, sc):
        """Batched backtracking ladder (JAX step :416-470): every
        remaining halving of α against the current filter at once, and
        the first candidate the sequential loop would stop at.
        `reset_counted` is whether the full-step rejection counter has
        reached 4. Returns (α, last_rejection_due_to_filter)."""
        F = bind(funcs, params, sc, dtype)
        idx = torch.arange(MAX_BACKTRACKS, device=x.device)
        alphas = alpha * ALPHA_REDUCTION_FACTOR ** torch.arange(
            1, MAX_BACKTRACKS + 1, dtype=dtype, device=x.device
        )
        below = alphas * ALPHA_REDUCTION_FACTOR < ALPHA_MIN
        jlast = torch.argmax(below.to(torch.uint8))

        def merit(a):
            tx = x + a * p_x
            return F.f(tx), _one_norm(F.c_e(tx))

        tfs, tviols = vmap(merit)(alphas)
        accs, rejected_pres, in_filters, finites, _sw, _ar = check_acceptance(
            filt_after, f, current_viol, tfs, tviols, D_phi, alphas
        )
        rejf = finites & ~rejected_pres & in_filters
        reset_possible = reset_counted & (filt_after.max_viol > current_viol / 10.0)
        stop = accs | (reset_possible & ~accs & rejf)
        stop = (stop & (idx <= jlast)) | (idx == jlast)
        jstop = torch.argmax(stop.to(torch.uint8))
        prior = (idx < jstop) & finites
        lastp = torch.max(torch.where(prior, idx, -1))
        flag = torch.where(
            lastp >= 0,
            at(rejf, torch.clamp(lastp, min=0)),
            filt_after.last_rejection_due_to_filter,
        )
        return at(alphas, jstop), flag

    # -- init and iteration ------------------------------------------------

    def init(x0, params, scaling, y0=None, iterations0=0) -> SQPState:
        params = tensor(params)
        scaling = ScalingArrays(*(tensor(a) for a in scaling))
        x0 = tensor(x0)
        y0 = torch.zeros(me, dtype=dtype, device=device) if y0 is None else tensor(y0)
        f, g, c_e, derivs = evaluate(x0, y0, params, scaling)
        finite = (
            torch.isfinite(f) & torch.isfinite(g).all() & torch.isfinite(c_e).all()
            & backend.all_finite(derivs)
        )
        E0 = unscaled_kkt_error_sqp_products(scaling, g, backend.AeT(derivs, y0), c_e, y0)
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
        return SQPState(
            x=x0, y=y0, f=f, c_e=c_e, g=g, derivs=derivs, E0=E0,
            filt=make_filter(_one_norm(c_e)),
            prev_delta=zero, delta=zero, gamma=zero,
            full_step_rejected_counter=0, iterations=int(iterations0), status=status,
            alpha=tensor(1.0), infeas_streak=0, params=params, scaling=scaling,
        )

    def finish_iteration(st: SQPState, t: _Trial, iterations: int) -> SQPState:
        """Refresh derivatives, the KKT error and the exit conditions after
        an accepted step or a return from restoration (reference
        sqp.hpp:560-592)."""
        g1, derivs1, E0 = refresh(t.x, t.y, t.c_e, st.params, st.scaling)
        if iterations >= options.max_iterations:
            status = int(ExitStatus.MAX_ITERATIONS_EXCEEDED)
        elif syncs.read(E0 <= tol):
            status = int(ExitStatus.SUCCESS)
        else:
            status = status_codes.RUNNING
        return st._replace(
            x=t.x, y=t.y, f=t.f, c_e=t.c_e, g=g1, derivs=derivs1, E0=E0,
            iterations=iterations, status=status,
        )

    def resume(st: SQPState, x1, y1, iterations: int) -> SQPState:
        """Resume after feasibility restoration (reference sqp.hpp:544-545,
        then :560-592)."""
        x1, y1 = tensor(x1), tensor(y1)
        return finish_iteration(st, _Trial(x1, y1, *values(x1, st.params, st.scaling)),
                                int(iterations) + 1)

    def iteration_body(st: SQPState) -> SQPState:
        params, sc = st.params, st.scaling
        x, y, f, c_e = st.x, st.y, st.f, st.c_e
        g, derivs = st.g, st.derivs

        # [H Aₑᵀ; Aₑ 0] assembled and factored by the backend with inertia
        # correction (reference sqp.hpp:290-306).
        rhs_top = -g + backend.AeT(derivs, y) if me > 0 else -g
        fac = backend.factor(derivs, empty, st.prev_delta, GAMMA_MIN)
        if not fac.ok:
            return st._replace(status=int(ExitStatus.FACTORIZATION_FAILED))

        def compute_step(rhs_bottom):
            return backend.solve_refined(derivs, empty, fac, rhs_top, rhs_bottom)

        p_x, p_y = compute_step(-c_e)
        alpha_max = tensor(1.0)
        D_phi = g @ p_x
        current_viol = _one_norm(c_e)

        # ---- backtracking filter line search (reference sqp.hpp:318-533)
        alpha = alpha_max
        filt = st.filt
        fsrc = st.full_step_rejected_counter
        accepted = None
        for _ in range(MAX_LINE_SEARCH_TRIPS):
            t = trial_at(alpha, p_x, p_y, x, y, params, sc)
            nonfinite = ~(torch.isfinite(t.f) & torch.isfinite(t.c_e).all())
            next_viol = _one_norm(t.c_e)
            acc, filt1 = try_add(filt, f, current_viol, t.f, next_viol, D_phi, alpha)
            alpha_next = alpha * ALPHA_REDUCTION_FACTOR
            nonfinite_b, acc_b, at_max_b, hit_min_b, worse_b = syncs.read(
                nonfinite, acc, alpha == alpha_max, alpha_next < ALPHA_MIN,
                next_viol >= current_viol,
            )
            if nonfinite_b:
                alpha = alpha_next
                if hit_min_b:
                    break
                continue

            # Second-order corrections (reference sqp.hpp:375-456), at the
            # full step's α with the first step's right-hand side.
            filt_after = filt1
            soc_b = False
            if not acc_b and at_max_b and worse_b:
                ce_soc, soc_viol, soc = c_e, next_viol, t
                for _ in range(MAX_SOC_ITERATIONS):
                    ce_soc = alpha * ce_soc + soc.c_e
                    px2, py2 = compute_step(-ce_soc)
                    soc = trial_at(alpha, px2, py2, x, y, params, sc)
                    nv = _one_norm(soc.c_e)
                    acc2, filt_after = try_add(
                        filt_after, f, current_viol, soc.f, nv, D_phi, alpha
                    )
                    soc_b, stalled_b = syncs.read(acc2, nv > KAPPA_SOC * soc_viol)
                    soc_viol = nv
                    if soc_b or stalled_b:
                        break
            if acc_b or soc_b:
                if soc_b:
                    p_x, p_y, t = px2, py2, soc
                accepted = t
                filt = filt_after
                if at_max_b:
                    fsrc = 0
                break

            # Full-step rejection counter and filter reset (reference
            # sqp.hpp:458-478)
            if at_max_b:
                fsrc += 1
            if fsrc >= 4 and syncs.read(
                (filt_after.max_viol > current_viol / 10.0)
                & filt_after.last_rejection_due_to_filter
            ):
                filt = reset_filter(filt_after)._replace(max_viol=filt_after.max_viol * 0.1)
                continue

            if hit_min_b:
                # KKT-error-reduction fallback at the minimum step
                # (reference sqp.hpp:490-522); if it fails, restoration.
                alpha, filt = alpha_next, filt_after
                t3 = trial_at(alpha_max, p_x, p_y, x, y, params, sc)
                _f3, g3, _ce3, d3 = evaluate(t3.x, t3.y, params, sc)
                cur_err = kkt_error_sqp_one_products(g, backend.AeT(derivs, y), c_e, y)
                next_err = kkt_error_sqp_one_products(g3, backend.AeT(d3, t3.y), t3.c_e, t3.y)
                if syncs.read(next_err <= 0.999 * cur_err):
                    accepted = t3
                break

            alpha, flag = jump(alpha, p_x, x, f, filt_after, fsrc >= 4, current_viol, D_phi,
                               params, sc)
            filt = filt_after._replace(last_rejection_due_to_filter=flag)

        factored = dict(prev_delta=fac.delta, delta=fac.delta, gamma=fac.gamma)
        if accepted is not None:
            return finish_iteration(
                st._replace(filt=filt, full_step_rejected_counter=fsrc, alpha=alpha, **factored),
                accepted,
                st.iterations + 1,
            )
        return st._replace(
            status=status_codes.FEASIBILITY_RESTORATION_REQUESTED,
            filt=filt, alpha=alpha, **factored,
        )

    def step(st: SQPState) -> SQPState:
        # Local infeasibility (reference solver/util/is_locally_infeasible.hpp:
        # 18-38) must persist for 5 consecutive iterations, as in the IPM.
        norm = torch.linalg.vector_norm
        infeas = torch.zeros((), dtype=torch.bool, device=device)
        if me > 0:
            infeas = (norm(backend.AeT(st.derivs, st.c_e)) < 1e-6) & (norm(st.c_e) > 1e-2)
        diverging = (torch.max(torch.abs(st.x)) > DIVERGENCE_LIMIT) | ~torch.isfinite(st.x).all()
        infeas_b, diverging_b = syncs.read(infeas, diverging)
        st = st._replace(infeas_streak=st.infeas_streak + 1 if infeas_b else 0)
        if st.infeas_streak >= 5:
            return st._replace(status=int(ExitStatus.LOCALLY_INFEASIBLE))
        if diverging_b:
            return st._replace(status=int(ExitStatus.DIVERGING_ITERATES))
        return iteration_body(st)

    return init, step, resume
