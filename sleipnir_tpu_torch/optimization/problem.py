"""Problem DSL (reference optimization/problem.hpp:78-822).

Port of `sleipnir_tpu/optimization/problem.py`. A Problem holds decision
variables, an optional cost and constraint lists; `solve()` classifies it
by linearity and dispatches (reference problem.hpp:303-669). The cost and
constraints are compiled once into torch functions of the flat decision
vector, and derivatives come from `torch.func`.

Problems with inequality constraints run the interior-point method,
equality-only problems SQP, unconstrained ones Newton's method, each on
the banded KKT backend where an OCP's stage structure allows it and on
the dense one otherwise, with feasibility restoration of the same kind.
Diagnostics printing and sparsity recording raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from sleipnir_tpu_torch.autodiff import expression as ex
from sleipnir_tpu_torch.autodiff.expression import ConstExpr, Expr
from sleipnir_tpu_torch.autodiff.expression_type import ExpressionType
from sleipnir_tpu_torch.autodiff.variable import (
    EqualityConstraints,
    InequalityConstraints,
    Variable,
    VariableBlock,
    VariableMatrix,
)
from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.optimization.solver.funcs import (
    IPMFunctions,
    NewtonFunctions,
    ScalingArrays,
    SQPFunctions,
)
from sleipnir_tpu_torch.optimization.solver.interior_point import make_interior_point
from sleipnir_tpu_torch.optimization.solver.iteration_info import IterationInfo
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseBackend
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedBackend
from sleipnir_tpu_torch.optimization.solver.newton import make_newton
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.solve_driver import run_solver
from sleipnir_tpu_torch.optimization.solver.sqp import make_sqp
from sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration import (
    restore,
)
from sleipnir_tpu_torch.optimization.solver.util.bounds import (
    get_bounds,
    get_bounds_rows,
    project_onto_bounds,
)
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs
from sleipnir_tpu_torch.optimization.solver.util.problem_scaling import (
    ProblemScaling,
)


def resolve_device(name: str) -> torch.device:
    """The torch device an `Options.device` names. A CUDA device without
    CUDA raises rather than running somewhere else."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} asks for CUDA, which is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class _FnBlock:
    """A functional constraint block: residuals given directly as a torch
    function of the flat decision vector (the OCP fast path: one vmapped
    program regardless of horizon length, instead of O(N) DSL nodes).

    `row_stage` assigns each residual row to an OCP stage for the banded
    KKT backend."""

    __slots__ = ("fn", "rows", "lin", "row_stage")

    def __init__(self, fn: Callable, rows: int, lin: ExpressionType, row_stage) -> None:
        self.fn = fn
        self.rows = rows
        self.lin = lin
        self.row_stage = row_stage


def _rows(block) -> int:
    return block.rows if isinstance(block, _FnBlock) else block.size


class SolveStats:
    """What the last solve counted: iterations and device-to-host reads."""

    def __init__(self, iterations: int, host_syncs: int) -> None:
        self.iterations = iterations
        self.host_syncs = host_syncs

    @property
    def host_syncs_per_iteration(self) -> float:
        return self.host_syncs / max(self.iterations, 1)


class Problem:
    """An optimization problem (reference optimization/problem.hpp:78)."""

    def __init__(self) -> None:
        self._var_ids: list[np.ndarray] = []
        self._f: Expr | None = None
        self._equality: list = []  # Expr | _FnBlock, in subject_to order
        self._inequality: list = []
        self._callbacks: list[Callable] = []
        self._persistent_callbacks: list[Callable] = []
        self._structure_version = 0
        self._solver_cache: dict = {}
        #: Enables projection of the initial guess into detected variable
        #: bounds (reference SLEIPNIR_ENABLE_BOUND_PROJECTION).
        self.enable_bound_projection = False
        self._last_state = None
        #: Iterations and host syncs of the last interior-point solve.
        self.last_solve_stats: SolveStats | None = None

    # -- variable / cost / constraint registration -------------------------

    def decision_variable(self, rows: int | None = None, cols: int = 1):
        """Create decision variables (reference problem.hpp:78-130): a
        scalar Variable with no arguments, else a rows x cols matrix."""
        self._structure_version += 1
        if rows is None:
            v = Variable()
            self._var_ids.append(v.expr.ids.reshape(1))
            return v
        m = VariableMatrix(int(rows), int(cols))
        self._var_ids.append(m.expr.ids.ravel())
        return m

    def symmetric_decision_variable(self, rows: int) -> VariableMatrix:
        """A symmetric matrix of decision variables whose upper triangle
        shares the lower triangle's variables (reference problem.hpp:132-150)."""
        self._structure_version += 1
        count = rows * (rows + 1) // 2
        flat = ex._registry.new_ids(count)
        ids = np.zeros((rows, rows), dtype=np.int64)
        k = 0
        for i in range(rows):
            for j in range(i + 1):
                ids[i, j] = flat[k]
                ids[j, i] = flat[k]
                k += 1
        self._var_ids.append(flat)
        return VariableMatrix(ex.DecVarExpr(ids))

    def minimize(self, cost) -> None:
        """Set the cost to minimize (reference problem.hpp:151-170)."""
        self._structure_version += 1
        self._f = _as_scalar_expr(cost)

    def maximize(self, objective) -> None:
        """Set the objective to maximize (reference problem.hpp:172-194)."""
        self._structure_version += 1
        self._f = ex.neg(_as_scalar_expr(objective))

    def subject_to(self, constraint) -> None:
        """Add constraints (reference problem.hpp:196-234)."""
        self._structure_version += 1
        if isinstance(constraint, EqualityConstraints):
            self._equality.extend(constraint.blocks)
        elif isinstance(constraint, InequalityConstraints):
            self._inequality.extend(constraint.blocks)
        elif isinstance(constraint, (list, tuple)):
            for c in constraint:
                self.subject_to(c)
        else:
            raise TypeError(f"subject_to() expects constraints, got {type(constraint)}")

    def _subject_to_fn(self, fn: Callable, rows: int, lin: ExpressionType, *,
                       equality: bool, row_stage=None) -> None:
        """Register a functional constraint block (OCP fast path)."""
        self._structure_version += 1
        block = _FnBlock(fn, rows, lin, row_stage)
        (self._equality if equality else self._inequality).append(block)

    def add_callback(self, callback: Callable) -> None:
        """Add a per-iteration callback; returning True stops the solve
        (reference problem.hpp:681-730)."""
        self._callbacks.append(callback)

    def add_persistent_callback(self, callback: Callable) -> None:
        """Add a callback that survives clear_callbacks() (reference
        problem.hpp:728)."""
        self._persistent_callbacks.append(callback)

    def clear_callbacks(self) -> None:
        """Remove non-persistent callbacks (reference problem.hpp:735)."""
        self._callbacks.clear()

    # -- classification ----------------------------------------------------

    def cost_function_type(self) -> ExpressionType:
        """(reference problem.hpp:239-245)"""
        return self._f.lin if self._f is not None else ExpressionType.NONE

    @staticmethod
    def _blocks_type(blocks) -> ExpressionType:
        t = ExpressionType.NONE
        for b in blocks:
            t = max(t, b.lin)
        return t

    def equality_constraint_type(self) -> ExpressionType:
        """(reference problem.hpp:250-258)"""
        return self._blocks_type(self._equality)

    def inequality_constraint_type(self) -> ExpressionType:
        """(reference problem.hpp:263-271)"""
        return self._blocks_type(self._inequality)

    # -- compilation -------------------------------------------------------

    def _all_ids(self) -> np.ndarray:
        if not self._var_ids:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self._var_ids)

    def _compile(self) -> dict:
        """Compile f, c_e, c_i into (x, params) -> tensor functions, batching
        isomorphic loop-built blocks (see autodiff/vectorize.py)."""
        from sleipnir_tpu_torch.autodiff.vectorize import BlockCompiler  # noqa: PLC0415

        all_ids = self._all_ids()
        f_expr = self._f if self._f is not None else ConstExpr(0.0)
        bc = BlockCompiler(f_expr, self._equality, self._inequality, all_ids)
        ineq_linear = [b.lin == ExpressionType.LINEAR for b in self._inequality for _ in range(_rows(b))]
        return {
            "compiled": bc,
            "all_ids": all_ids,
            "n": int(all_ids.shape[0]),
            "me": sum(_rows(b) for b in self._equality),
            "mi": sum(_rows(b) for b in self._inequality),
            "f": bc.f,
            "c_e": bc.c_e,
            "c_i": bc.c_i,
            "ineq_row_linear": np.array(ineq_linear, dtype=bool),
        }

    # -- solve -------------------------------------------------------------

    def solve(self, options: Options | None = None, spy: bool = False, **kwargs):
        """Solve the problem; the solution is written back into the original
        Variables (reference problem.hpp:281-679)."""
        if options is None:
            options = Options()
        if kwargs:
            fields = {k: getattr(options, k) for k in Options.__dataclass_fields__}
            options = Options(**{**fields, **kwargs})
        if options.diagnostics or spy:
            raise NotImplementedError(
                "diagnostics printing and sparsity recording are not ported "
                "yet (ROADMAP queue 1 item 6: util/{profiler,print_diagnostics,spy})"
            )

        f_type = self.cost_function_type()
        c_e_type = self.equality_constraint_type()
        c_i_type = self.inequality_constraint_type()

        # No-op problem (reference problem.hpp:303-313)
        if (
            f_type <= ExpressionType.CONSTANT
            and c_e_type <= ExpressionType.CONSTANT
            and c_i_type <= ExpressionType.CONSTANT
        ):
            return ExitStatus.SUCCESS

        start_time = time.monotonic()
        comp = self._compile()
        all_ids = comp["all_ids"]
        x0 = ex._registry.get(all_ids).astype(np.float64)
        params = comp["compiled"].gather_params()
        if comp["mi"] > 0:
            status, final_x = self._solve_ipm(comp, x0, params, options, start_time)
        elif comp["me"] > 0:
            status, final_x = self._solve_sqp(comp, x0, params, options, start_time)
        else:
            status, final_x = self._solve_newton(comp, x0, params, options, start_time)

        # Write the solution back into the decision variables
        # (reference problem.hpp:676).
        ex._registry.set(all_ids, np.asarray(final_x, dtype=np.float64))
        return status

    # -- derivative construction -------------------------------------------

    @staticmethod
    def _derivatives(comp: dict):
        """Dense derivative functions of the raw problem functions: g, the
        cost Hessian, Aₑ, Aᵢ and the constraint part of the Lagrangian
        Hessian, H_c(x, y, z) = ∇²(−yᵀcₑ − zᵀcᵢ)."""
        f_raw, ce_raw, ci_raw = comp["f"], comp["c_e"], comp["c_i"]

        def lag_c(x, y, z, params):
            out = torch.zeros((), dtype=x.dtype, device=x.device)
            if comp["me"] > 0:
                out = out - y @ ce_raw(x, params)
            if comp["mi"] > 0:
                out = out - z @ ci_raw(x, params)
            return out

        return grad(f_raw), hessian(f_raw), jacfwd(ce_raw), jacfwd(ci_raw), hessian(lag_c)

    def _cache_key(self, kind: str, options: Options, device: torch.device):
        return (
            kind, self._structure_version, options.tolerance,
            options.max_iterations, options.feasible_ipm, str(device),
        )

    @staticmethod
    def _unit_scaling(comp: dict, device: torch.device) -> ScalingArrays:
        """Scaling arrays of ones: the unscaled callbacks."""
        return ScalingArrays(
            *(torch.ones(size, dtype=torch.float64, device=device)
              for size in ((), comp["me"], comp["mi"]))
        )

    def _backend(self, comp: dict, device: torch.device, me: int, mi: int):
        """The stage-banded backend where the problem has OCP structure,
        else the dense one."""
        syncs = HostSyncs()
        backend = self._make_kkt_backend(comp, device, syncs)
        if backend is None:
            backend = DenseBackend(comp["n"], me, mi, device, syncs)
        return backend

    def _record(self, state, backend, syncs_before: int) -> tuple:
        self._last_state = state
        self.last_solve_stats = SolveStats(state.iterations, backend.syncs.count - syncs_before)
        return ExitStatus(state.status), state.x.cpu().numpy()

    # -- Newton (no constraints) -------------------------------------------

    def _solve_newton(self, comp, x0, params, options, start_time):
        """(reference problem.hpp:335-402)"""
        device = resolve_device(options.device)
        key = self._cache_key("newton", options, device)
        cached = self._solver_cache.get(key)
        if cached is None:
            comp["compiled"].prepare(device)
            f_raw = comp["f"]
            g_fn, H_f_fn = grad(f_raw), hessian(f_raw)
            funcs = NewtonFunctions(
                num_decision_variables=comp["n"],
                f=lambda x, p, sc: sc.f * f_raw(x, p),
                g=lambda x, p, sc: sc.f * g_fn(x, p),
                H=lambda x, p, sc: sc.f * H_f_fn(x, p),
            )
            backend = self._backend(comp, device, 0, 0)
            init, step = make_newton(funcs, options, backend=backend)
            cached = self._solver_cache[key] = (init, step, g_fn, backend)
        init, step, g_fn, backend = cached
        syncs_before = backend.syncs.count

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        # Scaling at the starting point (reference problem.hpp:379-382)
        scaling = ProblemScaling.for_newton(g_fn(on_device(x0), on_device(params)).cpu().numpy())
        sc = ScalingArrays(f=scaling.f, c_e=np.zeros(0), c_i=np.zeros(0))
        state = run_solver(
            init(x0, params, sc), step, options,
            callbacks=self._persistent_callbacks + self._callbacks,
            info_fn=lambda st: self._newton_info(st, backend),
            start_time=start_time,
        )
        return self._record(state, backend, syncs_before)

    @staticmethod
    def _newton_info(state, backend) -> IterationInfo:
        empty = np.zeros(0)
        H, _A_e, _A_i = backend.dense(state.derivs)
        n = state.x.shape[0]
        return IterationInfo(
            iteration=state.iterations, x=state.x.cpu().numpy(), s=empty, y=empty, z=empty,
            g=state.g.cpu().numpy(), H=H, A_e=np.zeros((0, n)), A_i=np.zeros((0, n)),
        )

    # -- SQP (equality constraints only) -------------------------------------

    def _prepare_sqp(self, comp: dict, options: Options, device: torch.device):
        key = self._cache_key("sqp", options, device)
        cached = self._solver_cache.get(key)
        if cached is not None:
            return cached
        comp["compiled"].prepare(device)
        f_raw, ce_raw = comp["f"], comp["c_e"]
        g_fn, H_f_fn, A_e_fn, _A_i_fn, H_c_fn = self._derivatives(comp)
        empty = torch.zeros(0, dtype=torch.float64, device=device)
        funcs = SQPFunctions(
            num_decision_variables=comp["n"],
            num_equality_constraints=comp["me"],
            f=lambda x, p, sc: sc.f * f_raw(x, p),
            g=lambda x, p, sc: sc.f * g_fn(x, p),
            H=lambda x, y, p, sc: sc.f * H_f_fn(x, p) + H_c_fn(x, sc.c_e * y, empty, p),
            H_c=lambda x, y, p, sc: H_c_fn(x, sc.c_e * y, empty, p),
            c_e=lambda x, p, sc: sc.c_e * ce_raw(x, p),
            A_e=lambda x, p, sc: sc.c_e[:, None] * A_e_fn(x, p),
        )
        backend = self._backend(comp, device, comp["me"], 0)
        init, step, resume = make_sqp(funcs, options, backend=backend)
        cached = self._solver_cache[key] = (init, step, resume, funcs, g_fn, backend)
        return cached

    def _solve_sqp(self, comp, x0, params, options, start_time):
        """(reference problem.hpp:403-511)"""
        device = resolve_device(options.device)
        init, step, resume, funcs, g_fn, backend = self._prepare_sqp(comp, options, device)
        syncs_before = backend.syncs.count
        n, me = comp["n"], comp["me"]

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        # Scaling at the starting point (reference problem.hpp:473-477):
        # per-row Jacobian norms from the banded probes, or the dense Aₑ.
        if isinstance(backend, BandedBackend):
            scaling = self._ipm_scaling(g_fn, backend, x0, params)[0]
        else:
            xd, pd = on_device(x0), on_device(params)
            A_e0 = funcs.A_e(xd, pd, self._unit_scaling(comp, device)).cpu().numpy()
            scaling = ProblemScaling.for_sqp(g_fn(xd, pd).cpu().numpy(), A_e0)
        sc = ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=np.zeros(0))

        def restoration_handler(state, st_time):
            # The SQP callbacks as an interior-point parent without
            # inequalities (reference sqp.hpp:118-325), restored densely
            # as in the JAX package.
            empty = torch.zeros(0, dtype=torch.float64, device=device)
            shim = _ShimState(
                x=state.x, s=empty, c_e=state.c_e, c_i=empty, mu=0.0, alpha=state.alpha,
                iterations=state.iterations, filt=state.filt, g=state.g, f=state.f,
                params=state.params,
                scaling=ScalingArrays(f=state.scaling.f, c_e=state.scaling.c_e, c_i=empty),
            )
            outcome, x_n, _s_n, y_n, _z_n, iters = restore(
                _sqp_as_ipm_parent(funcs, n, me, device), shim, options,
                base_mu=options.tolerance / 10.0, start_time=st_time,
            )
            if outcome == "resume":
                return resume(state, x_n, y_n, iters)
            return state._replace(status=int(outcome), x=on_device(x_n))

        state = run_solver(
            init(x0, params, sc), step, options,
            callbacks=self._persistent_callbacks + self._callbacks,
            info_fn=lambda st: self._sqp_info(st, backend),
            restoration_handler=restoration_handler,
            start_time=start_time,
        )
        return self._record(state, backend, syncs_before)

    @staticmethod
    def _sqp_info(state, backend) -> IterationInfo:
        empty = np.zeros(0)
        H, A_e, _A_i = backend.dense(state.derivs)
        return IterationInfo(
            iteration=state.iterations, x=state.x.cpu().numpy(), s=empty,
            y=state.y.cpu().numpy(), z=empty, g=state.g.cpu().numpy(), H=H, A_e=A_e,
            A_i=np.zeros((0, state.x.shape[0])),
        )

    # -- interior point (inequality constraints) ----------------------------

    def _prepare_ipm(self, comp: dict, options: Options, device: torch.device):
        key = self._cache_key("ipm", options, device)
        cached = self._solver_cache.get(key)
        if cached is not None:
            return cached
        comp["compiled"].prepare(device)
        f_raw, ce_raw, ci_raw = comp["f"], comp["c_e"], comp["c_i"]
        g_fn, H_f_fn, A_e_fn, A_i_fn, H_c_fn = self._derivatives(comp)
        # The dense backend reads H, Aₑ and Aᵢ; the banded backend probes
        # the raw functions and never calls them.
        funcs = IPMFunctions(
            num_decision_variables=comp["n"],
            num_equality_constraints=comp["me"],
            num_inequality_constraints=comp["mi"],
            f=lambda x, p, sc: sc.f * f_raw(x, p),
            g=lambda x, p, sc: sc.f * g_fn(x, p),
            c_e=lambda x, p, sc: sc.c_e * ce_raw(x, p),
            c_i=lambda x, p, sc: sc.c_i * ci_raw(x, p),
            H=lambda x, y, z, p, sc: sc.f * H_f_fn(x, p) + H_c_fn(x, sc.c_e * y, sc.c_i * z, p),
            H_c=lambda x, y, z, p, sc: H_c_fn(x, sc.c_e * y, sc.c_i * z, p),
            A_e=lambda x, p, sc: sc.c_e[:, None] * A_e_fn(x, p),
            A_i=lambda x, p, sc: sc.c_i[:, None] * A_i_fn(x, p),
        )
        backend = self._backend(comp, device, comp["me"], comp["mi"])
        init, step, resume = make_interior_point(funcs, options, backend=backend)
        cached = self._solver_cache[key] = (init, step, resume, funcs, g_fn, backend)
        return cached

    def _make_kkt_backend(self, comp: dict, device: torch.device, syncs: HostSyncs):
        """Hook for structured problems: OCP returns a banded backend when
        the stage structure allows it; None selects the dense backend."""
        return None

    @staticmethod
    def _ipm_scaling(g_fn, backend, x0, params):
        """Scaling at a starting point (reference problem.hpp:612-616) from
        per-row Jacobian norms of the banded backend (O(N·w) memory), on
        the solve device; SQP's too, with no inequality rows. Returns
        (ProblemScaling, ci_rows, ci_cols), the last two for bound
        detection."""

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=backend.device)

        g0 = g_fn(on_device(x0), on_device(params)).cpu().numpy()
        ce_loc, ce_next, ci_rows, ci_cols = backend.setup_rows(x0, params)
        ce_inf = np.maximum(
            np.max(np.abs(ce_loc), axis=1, initial=0.0),
            np.max(np.abs(ce_next), axis=1, initial=0.0),
        )
        ci_inf = np.max(np.abs(ci_rows), axis=1, initial=0.0)
        return ProblemScaling.from_row_norms(g0, ce_inf, ci_inf), ci_rows, ci_cols

    def prepare_ipm(self, options: Options | None = None):
        """Compile (or fetch cached) the interior-point solver of this
        problem: (comp, (init, step, resume, funcs, g_fn, backend)), on
        the device `options.device` names. `solve()` and the batched
        drivers of `sleipnir_tpu_torch.parallel` use it."""
        if options is None:
            options = Options()
        comp = self._compile()
        return comp, self._prepare_ipm(comp, options, resolve_device(options.device))

    def compute_ipm_scaling(self, comp: dict, bundle, x0, params):
        """Problem scaling at a starting point (reference
        problem.hpp:612-616), on the solve device. Returns (scaling, rows):
        the banded backend's per-row inequality Jacobian entries and their
        columns (ci_rows, ci_cols) from its probes, or the dense Aᵢ at x0;
        bound detection reads them."""
        *_, funcs, g_fn, backend = bundle
        if isinstance(backend, BandedBackend):
            scaling, ci_rows, ci_cols = self._ipm_scaling(g_fn, backend, x0, params)
            return scaling, (ci_rows, ci_cols)
        device = backend.device
        xd, pd = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in (x0, params))
        ones = self._unit_scaling(comp, device)
        A_e0 = funcs.A_e(xd, pd, ones).cpu().numpy()
        A_i0 = funcs.A_i(xd, pd, ones).cpu().numpy()
        return ProblemScaling.for_ipm(g_fn(xd, pd).cpu().numpy(), A_e0, A_i0), A_i0

    def _solve_ipm(self, comp, x0, params, options, start_time):
        """(reference problem.hpp:512-669)"""
        device = resolve_device(options.device)
        bundle = self._prepare_ipm(comp, options, device)
        init, step, resume, funcs, g_fn, backend = bundle
        syncs_before = backend.syncs.count
        banded = isinstance(backend, BandedBackend)

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        pd = on_device(params)

        # This set-up runs once per solve, on the solve device. The banded
        # path never materializes a Jacobian; the dense one scales from
        # Aₑ and Aᵢ at x0 (reference problem.hpp:612-616).
        c_i0 = comp["c_i"](on_device(x0), pd).cpu().numpy()
        scaling, rows = self.compute_ipm_scaling(comp, bundle, x0, params)
        if banded:
            ci_rows, ci_cols = rows
            bounds = get_bounds_rows(x0, c_i0, ci_cols, ci_rows, comp["ineq_row_linear"])
        else:
            bounds = get_bounds(x0, c_i0, rows, comp["ineq_row_linear"])
        sc = ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=scaling.c_i)

        # Bound conflict check (reference problem.hpp:597-610)
        if bounds.conflicting_bound_indices:
            return ExitStatus.GLOBALLY_INFEASIBLE, x0
        s0 = np.ones(comp["mi"])
        if self.enable_bound_projection:
            x0 = project_onto_bounds(x0, bounds.lower, bounds.upper)
            # sʲ = cᵢʲ(x₀) for bound rows (reference interior_point.hpp:288-291)
            c_i_start = comp["c_i"](on_device(x0), pd).cpu().numpy()
            mask = bounds.bound_constraint_mask
            s0[mask] = (scaling.c_i * c_i_start)[mask]

        # Default starting point (reference interior_point.hpp:74-87)
        y0 = np.zeros(comp["me"])
        z0 = np.ones(comp["mi"])
        mu0 = 0.1 * scaling.f

        def restoration_handler(state, st_time):
            # The restoration subproblem of a stage-banded problem is banded
            # too (its relaxation variables are stage-local), so it runs on
            # a banded backend of its own, on the parent's device; a dense
            # problem restores densely.
            outcome, x_n, s_n, y_n, z_n, iters = restore(
                funcs, state, options, start_time=st_time,
                parent_backend=backend if banded else None,
            )
            if outcome == "resume":
                return resume(state, x_n, s_n, y_n, z_n, iters)
            return state._replace(status=int(outcome), x=on_device(x_n), s=on_device(s_n))

        state = init(x0, s0, y0, z0, mu0, 0, params, sc)
        state = run_solver(
            state,
            step,
            options,
            callbacks=self._persistent_callbacks + self._callbacks,
            info_fn=lambda st: self._ipm_info(st, backend),
            restoration_handler=restoration_handler,
            start_time=start_time,
        )
        return self._record(state, backend, syncs_before)

    @staticmethod
    def _ipm_info(state, backend) -> IterationInfo:
        H, A_e, A_i = backend.dense(state.derivs)
        return IterationInfo(
            iteration=state.iterations,
            x=state.x.cpu().numpy(),
            s=state.s.cpu().numpy(),
            y=state.y.cpu().numpy(),
            z=state.z.cpu().numpy(),
            g=state.g.cpu().numpy(),
            H=H,
            A_e=A_e,
            A_i=A_i,
        )


class _ShimState:
    """Duck-typed parent state for SQP-entry feasibility restoration."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


def _sqp_as_ipm_parent(funcs: SQPFunctions, n: int, me: int, device) -> IPMFunctions:
    empty = torch.zeros(0, dtype=torch.float64, device=device)
    return IPMFunctions(
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
        A_i=lambda x, p, sc: torch.zeros((0, n), dtype=torch.float64, device=device),
    )


def _as_scalar_expr(cost) -> Expr:
    if isinstance(cost, Variable):
        return cost.expr
    if isinstance(cost, VariableBlock):
        cost = cost._as_matrix()
    if isinstance(cost, VariableMatrix):
        if cost.shape != (1, 1):
            raise ValueError(f"cost must be scalar, got shape {cost.shape}")
        return ex.reshape(cost.expr, ())
    if isinstance(cost, (int, float, np.integer, np.floating)):
        return ConstExpr(float(cost))
    raise TypeError(f"cannot use {type(cost)} as cost function")
