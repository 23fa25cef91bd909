"""Feasibility restoration: minimize constraint violation near the current
iterate when the line search fails.

Port of `sleipnir_tpu/optimization/solver/util/feasibility_restoration.py`
(reference solver/util/feasibility_restoration.hpp). It solves

      min  ρ Σ (pₑ + nₑ + pᵢ + nᵢ) + ζ/2 (x − xᵣ)ᵀDᵣ(x − xᵣ)
  s.t. cₑ(x) − pₑ + nₑ = 0
       cᵢ(x) − pᵢ + nᵢ ≥ 0,  pₑ, nₑ, pᵢ, nᵢ ≥ 0

with ρ = 1e3, ζ = √μ_fr, Dᵣ = diag(min(1, 1/xᵣᵢ²)), with a second
interior-point instance in restoration mode. The relaxation variables of
a constraint row belong to that row's stage, so the subproblem of a
stage-banded parent is stage-banded too, with stage width m + 2(p + q),
and restoration costs O(N) like the parent solve. Any other parent (a
dense IPM, or SQP as an IPM without inequalities) restores on the dense
backend over the augmented n + 2mₑ + 2mᵢ variables.

An early-stop check replicates the reference's extra iteration callback
(reference interior_point.hpp:738-756): restoration stops as soon as the
parent filter would accept the candidate iterate with a 10% lower
constraint violation; the parent then resumes with least-squares
multiplier estimates (reference lagrange_multiplier_estimate.hpp:57-135).

The JAX package caches the compiled restoration solver per parent to
amortise XLA compiles, and passes the per-invocation values through a
runtime parameter vector. The port runs eagerly and has nothing to
amortise, so each invocation builds its restoration problem with those
values captured directly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import IPMFunctions, ScalingArrays
from sleipnir_tpu_torch.optimization.solver.interior_point import (
    KAPPA_SIGMA,
    make_interior_point,
)
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend, StageStructure
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.solve_driver import run_solver
from sleipnir_tpu_torch.optimization.solver.util.filter import try_add
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs

RHO = 1e3  # reference feasibility_restoration.hpp:391

#: Largest n + mᵢ for which a banded parent resumes with least-squares
#: dual estimates, which need dense Jacobians; longer horizons resume with
#: reset duals (JAX package feasibility_restoration.py:747-768). A dense
#: parent always estimates them, as in the JAX package.
DENSE_DUALS_MAX = 6000

def compute_p_n(c: np.ndarray, rho: float, mu: float):
    """Initialize relaxation slacks p, n via Ipopt eq (33)
    (reference feasibility_restoration.hpp:52-100)."""
    b = rho * c - mu
    n = (-b + np.sqrt(b * b + 2.0 * rho * mu * c)) / (2.0 * rho)
    p = c + n
    return p, n


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().astype(np.float64)
    return np.asarray(t, np.float64)


def restore(
    parent: IPMFunctions,
    parent_state,
    options: Options,
    *,
    base_mu: float | None = None,
    start_time: float | None = None,
    parent_backend=None,
):
    """Run feasibility restoration for an IPM parent, or an SQP parent as
    an IPM without inequalities (then `base_mu` stands in for its barrier
    parameter).

    With a banded `parent_backend` the restoration subproblem is banded
    too; with a dense one, or none, it is dense, on the augmented (n + 2mₑ + 2mᵢ)
    variables, and the parent's callbacks must include the dense H_c, A_e
    and A_i. Returns (outcome, x, s, y, z, iterations), numpy arrays,
    where outcome is "resume" (the parent continues) or a terminal
    ExitStatus.
    """
    x_r = _numpy(parent_state.x)
    s_r = _numpy(parent_state.s)
    c_e0 = _numpy(parent_state.c_e)
    c_i0 = _numpy(parent_state.c_i)
    mu = float(base_mu) if base_mu is not None else float(parent_state.mu)

    def inf_norm(v):
        return float(np.max(np.abs(v))) if v.shape[0] else 0.0

    # fr_μ = max(μ, ‖cₑ‖_∞, ‖cᵢ − s‖_∞) (reference :396-397)
    fr_mu = max(mu, inf_norm(c_e0), inf_norm(c_i0 - s_r))
    zeta = math.sqrt(fr_mu)
    p_e0, n_e0 = compute_p_n(c_e0, RHO, fr_mu)
    p_i0, n_i0 = compute_p_n(c_i0 - s_r, RHO, fr_mu)
    with np.errstate(divide="ignore"):
        D_r = np.minimum(1.0, 1.0 / np.square(x_r))
    init_viol = float(np.sum(np.abs(c_e0)) + np.sum(np.abs(c_i0 - s_r)))

    banded = isinstance(parent_backend, BandedBackend)
    if banded:
        solver = _banded_fr_solver(
            parent, parent_state, options, parent_backend, x_r, s_r, D_r, zeta, mu, init_viol,
        )
        n, me, mi = solver["dims"]
        pe_idx, ne_idx, pi_idx, ni_idx = solver["idx"]
        # Starting point: padded-slot dummies at fr_μ, slacks synchronized
        fr_x0 = np.concatenate([x_r, np.full(solver["n_extra"], fr_mu)])
        fr_x0[pe_idx] = p_e0
        fr_x0[ne_idx] = n_e0
        fr_x0[pi_idx] = p_i0
        fr_x0[ni_idx] = n_i0
        fr_s0 = np.concatenate([s_r, fr_x0[n:]])
        with np.errstate(divide="ignore"):
            fr_z0 = np.concatenate([fr_mu / s_r, fr_mu / fr_x0[n:]])
    else:
        syncs = parent_backend.syncs if parent_backend is not None else HostSyncs()
        solver = _dense_fr_solver(
            parent, parent_state, options, syncs, x_r, s_r, D_r, zeta, mu, init_viol
        )
        n, me, mi = solver["dims"]
        fr_x0 = np.concatenate([x_r, p_e0, n_e0, p_i0, n_i0])
        fr_s0 = np.concatenate([s_r, np.ones(solver["n_extra"])])
        with np.errstate(divide="ignore"):
            fr_z0 = np.concatenate([fr_mu / s_r, fr_mu / p_e0, fr_mu / n_e0, fr_mu / p_i0, fr_mu / n_i0])
    fr_y0 = np.zeros(me)

    # Inherit the parent's constraint scaling; cost and new rows unscaled
    # (reference :423-430).
    psc = parent_state.scaling
    fr_scaling = ScalingArrays(
        f=psc.c_e.new_ones(()),
        c_e=psc.c_e,
        c_i=torch.cat([psc.c_i, psc.c_i.new_ones(solver["n_extra"])]),
    )
    state = solver["init"](
        fr_x0, fr_s0, fr_y0, fr_z0, fr_mu, parent_state.iterations,
        parent_state.params, fr_scaling,
    )
    state = run_solver(state, solver["step"], options, start_time=start_time)

    status = ExitStatus(int(state.status))
    x_new = _numpy(state.x[:n])
    s_new = _numpy(state.s[:mi])
    iterations_out = int(state.iterations)
    params = parent_state.params

    def parent_rows(x):
        xt = torch.as_tensor(x, dtype=params.dtype, device=params.device)
        return _numpy(parent.c_e(xt, params, psc)), _numpy(parent.c_i(xt, params, psc))

    def resume_duals(x_res, s_res):
        # Dense least-squares dual estimation is O(m²n): fine for dense
        # problems and short horizons, prohibitive at long ones, where the
        # duals reset and the parent re-estimates them within a few
        # iterations.
        if not banded or n + mi <= DENSE_DUALS_MAX:
            xt = torch.as_tensor(x_res, dtype=params.dtype, device=params.device)
            g_new = _numpy(parent.g(xt, params, psc))
            if banded:
                A_e, A_i = _dense_jacobians(parent_backend, x_res, params, psc)
            else:
                A_e, A_i = _numpy(parent.A_e(xt, params, psc)), _numpy(parent.A_i(xt, params, psc))
            y_est, z_est = lagrange_multiplier_estimate(g_new, A_e, A_i, s_res, mu)
        else:
            y_est = np.zeros(me)
            z_est = np.clip(mu / s_res, mu / 1e10, 1e10)
        return "resume", x_res, s_res, y_est, z_est, iterations_out

    if status == ExitStatus.CALLBACK_REQUESTED_STOP:
        # The parent filter accepted.
        return resume_duals(x_new, s_new)
    if status == ExitStatus.SUCCESS:
        # Restoration converged. The reference translates this directly to
        # LOCALLY_INFEASIBLE (reference :623-624); the JAX package resumes
        # when the parent is feasible or its violation dropped tenfold, and
        # declares infeasibility only when restoration converged without
        # meaningful progress.
        ce_new, ci_new = parent_rows(x_new)
        eps_feas = max(options.tolerance * 100.0, 1e-10)
        ce_ok = ce_new.shape[0] == 0 or np.max(np.abs(ce_new)) <= eps_feas
        ci_ok = ci_new.shape[0] == 0 or np.min(ci_new) >= -eps_feas
        theta_old = np.sum(np.abs(c_e0)) + np.sum(np.abs(np.minimum(c_i0, 0.0)))
        theta_new = np.sum(np.abs(ce_new)) + np.sum(np.abs(np.minimum(ci_new, 0.0)))
        if (ce_ok and ci_ok) or theta_new < 0.1 * theta_old:
            return resume_duals(x_new, np.maximum(ci_new, mu) if mi > 0 else s_new)
        return ExitStatus.LOCALLY_INFEASIBLE, x_new, s_new, None, None, iterations_out
    return ExitStatus.FEASIBILITY_RESTORATION_FAILED, x_new, s_new, None, None, iterations_out


def lagrange_multiplier_estimate(g, A_e, A_i, s, mu: float):
    """Least-squares dual estimate [y; z] = (ÂÂᵀ)⁻¹Â[∇f; −μe] with
    Â = [Aₑ 0; Aᵢ −S], z clamped to the κ_Σ band
    (reference solver/util/lagrange_multiplier_estimate.hpp:57-135)."""
    me = A_e.shape[0]
    mi = A_i.shape[0]
    n = g.shape[0]
    A_hat = np.zeros((me + mi, n + mi))
    A_hat[:me, :n] = A_e
    A_hat[me:, :n] = A_i
    if mi > 0:
        A_hat[me:, n:] = -np.diag(s)
    rhs_temp = np.concatenate([g, -mu * np.ones(mi)])
    lhs = A_hat @ A_hat.T
    rhs = A_hat @ rhs_temp
    try:
        sol = np.linalg.solve(lhs, rhs)
    except np.linalg.LinAlgError:
        sol = np.linalg.lstsq(lhs, rhs, rcond=None)[0]
    y = sol[:me]
    z = sol[me:]
    if mi > 0:
        z = np.clip(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
    return y, z


def _dense_jacobians(backend: BandedBackend, x, params, scaling):
    """Scaled dense Aₑ (me, n) and Aᵢ (mi, n) at x, assembled on the host
    from the backend's banded Jacobian rows (its colored JVP probes)."""
    st = backend.structure
    ce_loc, ce_next, ci_rows, ci_cols = backend.setup_rows(x, _numpy(params))
    m = st.stage_width
    stages = np.asarray(st.var_perm).reshape(st.num_stages, m)
    border = np.asarray(st.border, dtype=np.int64)
    A_e = np.zeros((backend.me, backend.n))
    for r, k in enumerate(np.asarray(st.ce_stage)):
        A_e[r, stages[k]] = ce_loc[r, :m]
        A_e[r, border] = ce_loc[r, m:]  # the border columns follow the stage's
        if k + 1 < st.num_stages:
            A_e[r, stages[k + 1]] = ce_next[r]
    A_i = np.zeros((backend.mi, backend.n))
    for r in range(backend.mi):
        A_i[r, ci_cols[r]] = ci_rows[r]
    return _numpy(scaling.c_e)[:, None] * A_e, _numpy(scaling.c_i)[:, None] * A_i


def _stop_check(parent, parent_state, x_r, s_r, mu: float, init_viol: float):
    """The early-stop check: the parent filter accepts the candidate with
    a 10% violation reduction (reference interior_point.hpp:738-756), from
    the parent's barrier, step size, gradient and filter at the request."""
    n = parent.num_decision_variables
    mi = parent.num_inequality_constraints
    psc = parent_state.scaling
    device, dtype = parent_state.x.device, parent_state.x.dtype
    x_r_t = torch.as_tensor(x_r, dtype=dtype, device=device)
    s_r_t = torch.as_tensor(s_r, dtype=dtype, device=device)
    s_r_log = float(np.sum(np.log(s_r))) if mi > 0 else 0.0
    init_cost = torch.as_tensor(float(parent_state.f) - mu * s_r_log, dtype=dtype, device=device)
    init_viol_t = torch.as_tensor(init_viol, dtype=dtype, device=device)
    alpha = parent_state.alpha
    parent_g = parent_state.g
    parent_filter = parent_state.filt

    def stop_check(x, s, params):
        tx = x[:n]
        ts = s[:mi]
        tf = parent.f(tx, params, psc)
        tce = parent.c_e(tx, params, psc)
        tci = parent.c_i(tx, params, psc)
        trial_cost = tf - mu * torch.sum(torch.log(ts))
        trial_viol = torch.sum(torch.abs(tce)) + torch.sum(torch.abs(tci - ts))
        D_phi_r = parent_g @ (tx - x_r_t) - mu * torch.sum((ts - s_r_t) / s_r_t)
        acc, _ = try_add(
            parent_filter, init_cost, init_viol_t, trial_cost, trial_viol, D_phi_r, alpha
        )
        return (trial_viol < 0.9 * init_viol_t) & acc

    return stop_check


def _dense_fr_solver(parent, parent_state, options, syncs: HostSyncs, x_r, s_r, D_r,
                     zeta: float, mu: float, init_viol: float) -> dict:
    """The restoration interior-point solver of one invocation on the
    dense backend, over [x; pₑ; nₑ; pᵢ; nᵢ]: its init and step (JAX
    package feasibility_restoration.py:160-343)."""
    n = parent.num_decision_variables
    me = parent.num_equality_constraints
    mi = parent.num_inequality_constraints
    device, dtype = parent_state.x.device, parent_state.x.dtype
    psc = parent_state.scaling
    n_extra = 2 * me + 2 * mi
    N = n + n_extra
    MI = mi + n_extra
    x_r_t = torch.as_tensor(x_r, dtype=dtype, device=device)
    D_r_t = torch.as_tensor(D_r, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye_e = torch.eye(me, dtype=dtype, device=device)
    eye_i = torch.eye(mi, dtype=dtype, device=device)
    rho_tail = torch.full((n_extra,), RHO, dtype=dtype, device=device)

    def fr_f(xp, params, sc):
        diff = xp[:n] - x_r_t
        return RHO * torch.sum(xp[n:]) + 0.5 * zeta * diff @ (D_r_t * diff)

    def fr_g(xp, params, sc):
        return torch.cat([zeta * D_r_t * (xp[:n] - x_r_t), rho_tail])

    def fr_H(xp, yp, zp, params, sc):
        out = zeros(N, N)
        out[:n, :n] = torch.diag(zeta * D_r_t) + parent.H_c(xp[:n], yp, zp[:mi], params, psc)
        return out

    def fr_c_e(xp, params, sc):
        return parent.c_e(xp[:n], params, psc) - xp[n : n + me] + xp[n + me : n + 2 * me]

    def fr_A_e(xp, params, sc):
        out = zeros(me, N)
        out[:, :n] = parent.A_e(xp[:n], params, psc)
        out[:, n : n + me] = -eye_e
        out[:, n + me : n + 2 * me] = eye_e
        return out

    def fr_c_i(xp, params, sc):
        top = parent.c_i(xp[:n], params, psc) - xp[n + 2 * me : n + 2 * me + mi] + xp[n + 2 * me + mi :]
        return torch.cat([top, xp[n:]])

    def fr_A_i(xp, params, sc):
        out = zeros(MI, N)
        out[:mi, :n] = parent.A_i(xp[:n], params, psc)
        out[:mi, n + 2 * me : n + 2 * me + mi] = -eye_i
        out[:mi, n + 2 * me + mi :] = eye_i
        out[mi:, n:] = torch.eye(n_extra, dtype=dtype, device=device)
        return out

    fr_funcs = IPMFunctions(
        num_decision_variables=N,
        num_equality_constraints=me,
        num_inequality_constraints=MI,
        f=fr_f,
        g=fr_g,
        c_e=fr_c_e,
        c_i=fr_c_i,
        H=fr_H,
        H_c=lambda xp, yp, zp, params, sc: zeros(N, N),
        A_e=fr_A_e,
        A_i=fr_A_i,
    )
    fr_backend = DenseBackend(N, me, MI, device, syncs, dtype)
    fr_init, fr_step, _ = make_interior_point(
        fr_funcs, options, backend=fr_backend, in_feasibility_restoration=True,
        stop_check=_stop_check(parent, parent_state, x_r, s_r, mu, init_viol),
    )
    return {"init": fr_init, "step": fr_step, "dims": (n, me, mi), "n_extra": n_extra}


def _banded_fr_solver(parent, parent_state, options, parent_backend, x_r, s_r, D_r,
                      zeta: float, mu: float, init_viol: float) -> dict:
    """The restoration interior-point solver of one invocation, on a banded
    backend over the augmented stage structure: its init and step, and
    the flat layout of the relaxation variables."""
    n = parent.num_decision_variables
    me = parent.num_equality_constraints
    mi = parent.num_inequality_constraints
    device, dtype = parent_backend.device, parent_backend.dtype
    st = parent_backend.structure
    K, m, p, q = st.num_stages, st.stage_width, st.eq_pad, st.ineq_pad
    e2 = 2 * (p + q)  # relaxation slots per stage (incl. padded slots)
    m2 = m + e2
    nb = np.asarray(st.border).shape[0]
    N2 = K * m2 + nb
    MI2 = mi + K * e2

    ce_stage = np.asarray(st.ce_stage)
    ce_slot = np.asarray(st.ce_slot)
    ci_stage = np.asarray(st.ci_stage)
    ci_slot = np.asarray(st.ci_slot)

    # Flat layout: [x (n); extras (K*e2, stage-major)] with per-stage extras
    # ordered [p_e (p), n_e (p), p_i (q), n_i (q)]. Padded slots become
    # dummy variables with their own >=0 rows; they cost ρ·t, start at
    # fr_μ and decay with the barrier, and keep the stage width uniform.
    pe_idx = n + ce_stage * e2 + ce_slot
    ne_idx = n + ce_stage * e2 + p + ce_slot
    pi_idx = n + ci_stage * e2 + 2 * p + ci_slot
    ni_idx = n + ci_stage * e2 + 2 * p + q + ci_slot

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pe_t, ne_t, pi_t, ni_t = (dev(a) for a in (pe_idx, ne_idx, pi_idx, ni_idx))
    x_r_t, D_r_t = dev(x_r, dtype), dev(D_r, dtype)
    ones_sc = ScalingArrays(
        f=dev(1.0, dtype), c_e=torch.ones(me, dtype=dtype, device=device),
        c_i=torch.ones(mi, dtype=dtype, device=device),
    )

    def fr_f_raw(xp, prm):
        diff = xp[:n] - x_r_t
        return RHO * torch.sum(xp[n:]) + 0.5 * zeta * diff @ (D_r_t * diff)

    def fr_ce_raw(xp, prm):
        base = parent.c_e(xp[:n], prm, ones_sc)
        if me == 0:
            return base
        return base - xp[pe_t] + xp[ne_t]

    def fr_ci_raw(xp, prm):
        top = parent.c_i(xp[:n], prm, ones_sc)
        if mi > 0:
            top = top - xp[pi_t] + xp[ni_t]
        return torch.cat([top, xp[n:]])

    # Stage structure of the augmented problem: the relaxation variables
    # join their row's stage. A border (shared-dt) column of the parent
    # stays a border of the augmented problem at the same flat position
    # (< n), so the starting point [x_r; extras] carries it inside x_r.
    parent_staged = np.asarray(st.var_perm).reshape(K, m)
    var_perm2 = np.empty(K * m2, dtype=np.int64)
    for k in range(K):
        var_perm2[k * m2 : k * m2 + m] = parent_staged[k]
        var_perm2[k * m2 + m : (k + 1) * m2] = n + k * e2 + np.arange(e2)
    fr_structure = StageStructure(
        num_stages=K,
        stage_width=m2,
        var_perm=var_perm2,
        ce_stage=ce_stage,
        ce_slot=ce_slot,
        eq_pad=max(p, 1),
        ci_stage=np.concatenate([ci_stage, np.repeat(np.arange(K), e2)]).astype(np.int64),
        ci_slot=np.concatenate([ci_slot, np.tile(q + np.arange(e2), K)]).astype(np.int64),
        ineq_pad=q + e2,
        border=np.asarray(st.border),
    )
    fr_backend = BandedBackend(
        fr_structure, fr_f_raw, fr_ce_raw, fr_ci_raw, N2, me, MI2, device,
        parent_backend.syncs, dtype,
    )
    rho_tail = torch.full((N2 - n,), RHO, dtype=dtype, device=device)
    fr_funcs = IPMFunctions(
        num_decision_variables=N2,
        num_equality_constraints=me,
        num_inequality_constraints=MI2,
        f=lambda xp, prm, sc: sc.f * fr_f_raw(xp, prm),
        g=lambda xp, prm, sc: sc.f * torch.cat([zeta * D_r_t * (xp[:n] - x_r_t), rho_tail]),
        c_e=lambda xp, prm, sc: sc.c_e * fr_ce_raw(xp, prm),
        c_i=lambda xp, prm, sc: sc.c_i * fr_ci_raw(xp, prm),
    )

    stop_check = _stop_check(parent, parent_state, x_r, s_r, mu, init_viol)
    fr_init, fr_step, _ = make_interior_point(
        fr_funcs, options, backend=fr_backend,
        in_feasibility_restoration=True, stop_check=stop_check,
    )
    return {
        "init": fr_init,
        "step": fr_step,
        "dims": (n, me, mi),
        "n_extra": K * e2,
        "idx": (pe_idx, ne_idx, pi_idx, ni_idx),
    }
