"""Newton's method for unconstrained problems: one host-driven step over
device tensors.

Port of `sleipnir_tpu/optimization/solver/newton.py` (reference
solver/newton.hpp:51-290): solve Hpˣ = −∇f with the inertia-corrected
regularized LDLᵀ, a backtracking filter line search on the cost alone
(α_min = 1e-20), and LINE_SEARCH_FAILED when it runs out, after the
accept-if-KKT-error-reduced fallback. Where the JAX step branches on
device, this one reads the deciding booleans through `HostSyncs` and
branches in Python, as the port's interior-point step does; the problem
evaluations replay as CUDA graphs on the card (`util/cuda_graph.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sleipnir_tpu_torch.optimization.solver import status_codes
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import (
    IPMFunctions,
    NewtonFunctions,
    ScalingArrays,
    bind,
)
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.util.filter import (
    FilterState,
    make_filter,
    try_add,
)
from sleipnir_tpu_torch.optimization.solver.util.kkt_error import (
    kkt_error_newton_one,
    unscaled_kkt_error_newton,
)

ALPHA_REDUCTION_FACTOR = 0.5  # newton.hpp:141
ALPHA_MIN = 1e-20  # newton.hpp:142
MAX_LINE_SEARCH_TRIPS = 96  # α halves from 1 past 1e-20 in ~67 steps
DIVERGENCE_LIMIT = 1e10  # newton.hpp:166
GAMMA_MIN = 1e-10


class NewtonState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    #: Backend-specific derivative storage (dense H or banded blocks).
    derivs: object
    E0: torch.Tensor
    filt: FilterState
    prev_delta: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    iterations: int
    status: int
    alpha: torch.Tensor
    #: Runtime parameter vector (non-decision variables; see funcs.bind).
    params: torch.Tensor
    #: Problem scaling, recomputed per solve at x0 (reference problem.hpp:382).
    scaling: ScalingArrays


def make_newton(funcs: NewtonFunctions, options: Options, *, backend):
    """Build (init, step) for Newton on a fixed problem shape, on the KKT
    backend `backend` (`kkt_backend.DenseBackend` for a dense Hessian)."""
    n = funcs.num_decision_variables
    device, dtype = backend.device, backend.dtype
    syncs = backend.syncs
    tol = options.tolerance

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    empty = torch.zeros(0, dtype=dtype, device=device)
    # The backends take (y, z)-dual callbacks; Newton has neither.
    ipm_funcs = IPMFunctions(
        num_decision_variables=n,
        num_equality_constraints=0,
        num_inequality_constraints=0,
        f=funcs.f,
        g=funcs.g,
        c_e=lambda x, p, sc: empty,
        c_i=lambda x, p, sc: empty,
        H=lambda x, y, z, p, sc: funcs.H(x, p, sc),
        H_c=lambda x, y, z, p, sc: torch.zeros((n, n), dtype=dtype, device=device),
        A_e=lambda x, p, sc: torch.zeros((0, n), dtype=dtype, device=device),
        A_i=lambda x, p, sc: torch.zeros((0, n), dtype=dtype, device=device),
    )

    # -- problem evaluations (CUDA graphs on the card) ----------------------

    graphs = backend.graphs

    @graphs.wrap
    def evaluate(x, params, sc):
        """f, g and the backend's Hessian at x."""
        F = bind(funcs, params, sc, dtype)
        Fi = bind(ipm_funcs, params, sc, dtype)
        return F.f(x), F.g(x), backend.eval_derivs(Fi, x, empty, empty)

    @graphs.wrap
    def cost_at(a, p_x, x, params, sc):
        tx = x + a * p_x
        return tx, bind(funcs, params, sc, dtype).f(tx)

    @graphs.wrap
    def values(x, params, sc):
        F = bind(funcs, params, sc, dtype)
        return F.f(x), F.g(x)

    # -- init and iteration ------------------------------------------------

    def init(x0, params, scaling, iterations0=0) -> NewtonState:
        params = tensor(params)
        scaling = ScalingArrays(*(tensor(a) for a in scaling))
        x0 = tensor(x0)
        f, g, derivs = evaluate(x0, params, scaling)
        finite = torch.isfinite(f) & torch.isfinite(g).all() & backend.all_finite(derivs)
        E0 = unscaled_kkt_error_newton(scaling, g)
        finite_b, converged_b = syncs.read(finite, E0 <= tol)
        if not finite_b:
            status = int(ExitStatus.NONFINITE_INITIAL_GUESS)
        elif converged_b:
            status = int(ExitStatus.SUCCESS)
        else:
            status = status_codes.RUNNING
        zero = tensor(0.0)
        return NewtonState(
            x=x0, f=f, g=g, derivs=derivs, E0=E0, filt=make_filter(zero),
            prev_delta=zero, delta=zero, gamma=zero,
            iterations=int(iterations0), status=status, alpha=tensor(1.0),
            params=params, scaling=scaling,
        )

    def iteration_body(st: NewtonState) -> NewtonState:
        params, sc = st.params, st.scaling
        x, f, g, derivs = st.x, st.f, st.g, st.derivs

        fac = backend.factor(derivs, empty, st.prev_delta, GAMMA_MIN)
        if not fac.ok:
            return st._replace(status=int(ExitStatus.FACTORIZATION_FAILED))
        p_x, _p_y = backend.solve_refined(derivs, empty, fac, -g, empty)
        D_phi = g @ p_x
        zero = tensor(0.0)

        # Backtracking filter line search on the cost (reference
        # newton.hpp:191-246)
        alpha = tensor(1.0)
        filt = st.filt
        accepted = None
        for _ in range(MAX_LINE_SEARCH_TRIPS):
            tx, tf = cost_at(alpha, p_x, x, params, sc)
            alpha_next = alpha * ALPHA_REDUCTION_FACTOR
            nonfinite_b, hit_min_b = syncs.read(~torch.isfinite(tf), alpha_next < ALPHA_MIN)
            if nonfinite_b:
                # A nonfinite trial reduces α with no filter call
                # (reference newton.hpp:207-216).
                alpha = alpha_next
                if hit_min_b:
                    break
                continue
            acc, filt = try_add(filt, f, zero, tf, zero, D_phi, alpha)
            if syncs.read(acc):
                accepted = (tx, tf, alpha)
                break
            if hit_min_b:
                # KKT fallback at the minimum step (reference
                # newton.hpp:227-246): the full step, if it cuts the
                # 1-norm KKT error.
                tx3 = x + p_x
                f3, g3 = values(tx3, params, sc)
                if syncs.read(kkt_error_newton_one(g3) <= 0.999 * kkt_error_newton_one(g)):
                    accepted = (tx3, f3, alpha_next)
                break
            alpha = alpha_next

        if accepted is None:
            return st._replace(status=int(ExitStatus.LINE_SEARCH_FAILED), filt=filt)
        x1, f1, alpha = accepted
        _f, g1, derivs1 = evaluate(x1, params, sc)
        E0 = unscaled_kkt_error_newton(sc, g1)
        iterations = st.iterations + 1
        if iterations >= options.max_iterations:
            status = int(ExitStatus.MAX_ITERATIONS_EXCEEDED)
        elif syncs.read(E0 <= tol):
            status = int(ExitStatus.SUCCESS)
        else:
            status = status_codes.RUNNING
        return st._replace(
            x=x1, f=f1, g=g1, derivs=derivs1, E0=E0, filt=filt,
            prev_delta=fac.delta, delta=fac.delta, gamma=fac.gamma,
            iterations=iterations, status=status, alpha=alpha,
        )

    def step(st: NewtonState) -> NewtonState:
        x = st.x
        diverging = (torch.max(torch.abs(x)) > DIVERGENCE_LIMIT) | ~torch.isfinite(x).all()
        if syncs.read(diverging):
            return st._replace(status=int(ExitStatus.DIVERGING_ITERATES))
        return iteration_body(st)

    return init, step
