"""Problem DSL (reference optimization/problem.hpp:78-822).

Port of `sleipnir_tpu/optimization/problem.py`. A Problem holds decision
variables, an optional cost and constraint lists; `solve()` classifies it
by linearity and dispatches (reference problem.hpp:303-669). The cost and
constraints are compiled once into torch functions of the flat decision
vector, and derivatives come from `torch.func`.

This slice ports the interior-point branch on the banded KKT backend.
The Newton and SQP branches, the dense backend, feasibility restoration,
diagnostics printing and sparsity recording raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.func import grad

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
from sleipnir_tpu_torch.optimization.solver.funcs import IPMFunctions, ScalingArrays
from sleipnir_tpu_torch.optimization.solver.interior_point import make_interior_point
from sleipnir_tpu_torch.optimization.solver.iteration_info import IterationInfo
from sleipnir_tpu_torch.optimization.solver.options import Options
from sleipnir_tpu_torch.optimization.solver.solve_driver import run_solver
from sleipnir_tpu_torch.optimization.solver.util.bounds import (
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
            f"Options(device={name!r}) asks for CUDA, which is not available; "
            "pass device='cpu' to solve on the CPU"
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
                "yet (ROADMAP queue 1 item 1: util/{profiler,print_diagnostics,spy})"
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
        if comp["mi"] == 0:
            raise NotImplementedError(
                "problems without inequality constraints run the Newton or "
                "SQP solver, which is not ported yet (ROADMAP queue 1 item 10)"
            )
        all_ids = comp["all_ids"]
        x0 = ex._registry.get(all_ids).astype(np.float64)
        params = comp["compiled"].gather_params()
        status, final_x = self._solve_ipm(comp, x0, params, options, start_time)

        # Write the solution back into the decision variables
        # (reference problem.hpp:676).
        ex._registry.set(all_ids, np.asarray(final_x, dtype=np.float64))
        return status

    def _prepare_ipm(self, comp: dict, options: Options, device: torch.device):
        key = (
            "ipm", self._structure_version, options.tolerance,
            options.max_iterations, options.feasible_ipm, str(device),
        )
        cached = self._solver_cache.get(key)
        if cached is not None:
            return cached
        comp["compiled"].prepare(device)
        f_raw, ce_raw, ci_raw = comp["f"], comp["c_e"], comp["c_i"]
        g_fn = grad(f_raw)
        syncs = HostSyncs()
        backend = self._make_kkt_backend(comp, device, syncs)
        if backend is None:
            raise NotImplementedError(
                "problems without OCP stage structure need the dense KKT "
                "backend, which is not ported yet (ROADMAP queue 1 item 10)"
            )
        funcs = IPMFunctions(
            num_decision_variables=comp["n"],
            num_equality_constraints=comp["me"],
            num_inequality_constraints=comp["mi"],
            f=lambda x, p, sc: sc.f * f_raw(x, p),
            g=lambda x, p, sc: sc.f * g_fn(x, p),
            c_e=lambda x, p, sc: sc.c_e * ce_raw(x, p),
            c_i=lambda x, p, sc: sc.c_i * ci_raw(x, p),
        )
        init, step = make_interior_point(funcs, options, backend=backend)
        cached = (init, step, g_fn, backend)
        self._solver_cache[key] = cached
        return cached

    def _make_kkt_backend(self, comp: dict, device: torch.device, syncs: HostSyncs):
        """Hook for structured problems: OCP returns a banded backend when
        the stage structure allows it."""
        return None

    def _solve_ipm(self, comp, x0, params, options, start_time):
        """(reference problem.hpp:512-669)"""
        device = resolve_device(options.device)
        init, step, g_fn, backend = self._prepare_ipm(comp, options, device)
        syncs_before = backend.syncs.count

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        xd, pd = on_device(x0), on_device(params)

        # Scaling at the starting point (reference problem.hpp:612-616) from
        # per-row Jacobian norms (O(N·w) memory). This set-up runs once per
        # solve, on the solve device.
        g0 = g_fn(xd, pd).cpu().numpy()
        ce_loc, ce_next, ci_rows, ci_cols = backend.setup_rows(x0, params)
        ce_inf = np.maximum(
            np.max(np.abs(ce_loc), axis=1, initial=0.0),
            np.max(np.abs(ce_next), axis=1, initial=0.0),
        )
        ci_inf = np.max(np.abs(ci_rows), axis=1, initial=0.0)
        scaling = ProblemScaling.from_row_norms(g0, ce_inf, ci_inf)
        sc = ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=scaling.c_i)

        # Bound detection and conflict check (reference problem.hpp:597-610)
        c_i0 = comp["c_i"](xd, pd).cpu().numpy()
        bounds = get_bounds_rows(x0, c_i0, ci_cols, ci_rows, comp["ineq_row_linear"])
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

        callbacks = self._persistent_callbacks + self._callbacks
        state = init(x0, s0, y0, z0, mu0, 0, params, sc)
        state = run_solver(
            state,
            step,
            options,
            callbacks=callbacks,
            info_fn=lambda st: self._ipm_info(st, backend),
            restoration_handler=None,
            start_time=start_time,
        )
        self._last_state = state
        self.last_solve_stats = SolveStats(
            state.iterations, backend.syncs.count - syncs_before
        )
        return ExitStatus(state.status), state.x.cpu().numpy()

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
