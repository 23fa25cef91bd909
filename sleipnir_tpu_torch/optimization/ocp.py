"""Optimal control problem (OCP) layer
(reference optimization/ocp.hpp:49-406 and the ocp/ enum headers).

Port of `sleipnir_tpu/optimization/ocp.py` for a fixed timestep, direct
transcription and explicit-ODE or discrete dynamics. The dynamics
function runs on torch tensors: the N dynamics constraints are registered
as ONE functional block that `torch.func.vmap`s an RK4 step over the
horizon, instead of the reference's O(N·nodes) symbolic expansion
(ocp.hpp:359-379). The problem's stage structure then selects the banded
KKT backend.

Not ported yet, and raising NotImplementedError: direct collocation,
single shooting, the VARIABLE and VARIABLE_SINGLE timestep methods and
dynamics that only run on the DSL (ROADMAP queue 1 item 11). A problem
that does not fit the stage band solves on the dense backend, with a
warning.
"""

from __future__ import annotations

import datetime
import enum
import inspect
import warnings
from typing import Callable

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff.expression import DecVarExpr, element_stages
from sleipnir_tpu_torch.autodiff.expression_type import ExpressionType
from sleipnir_tpu_torch.autodiff.variable import Variable, VariableMatrix
from sleipnir_tpu_torch.optimization.problem import Problem, _FnBlock
from sleipnir_tpu_torch.optimization.solver.kkt_banded import (
    BandedBackend,
    StageStructure,
)


class DynamicsType(enum.Enum):
    """(reference ocp/dynamics_type.hpp)"""

    #: The dynamics are an explicit ODE dx/dt = f(t, x, u).
    EXPLICIT_ODE = 0
    #: The dynamics are a discrete state transition xₖ₊₁ = f(t, xₖ, uₖ).
    DISCRETE = 1


class TimestepMethod(enum.Enum):
    """(reference ocp/timestep_method.hpp)"""

    #: The timestep is a fixed constant.
    FIXED = 0
    #: Each timestep is a separate decision variable.
    VARIABLE = 1
    #: A single timestep decision variable shared across all steps.
    VARIABLE_SINGLE = 2


class TranscriptionMethod(enum.Enum):
    """(reference ocp/transcription_method.hpp)"""

    #: Each state is a decision variable constrained to the integrated
    #: dynamics of the previous state.
    DIRECT_TRANSCRIPTION = 0
    #: The trajectory is modeled as cubic polynomials with constrained
    #: centerpoint slopes.
    DIRECT_COLLOCATION = 1
    #: States depend explicitly on all previous states and inputs.
    SINGLE_SHOOTING = 2


_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 11)"


def _seconds(dt) -> float:
    if isinstance(dt, datetime.timedelta):
        return dt.total_seconds()
    return float(dt)


def _normalize_dynamics(dynamics: Callable) -> Callable:
    """Normalize f(x, u) or f(t, x, u, dt) to the 4-argument form
    (reference ocp.hpp:68-88)."""
    try:
        nparams = len(inspect.signature(dynamics).parameters)
    except (TypeError, ValueError):
        nparams = 2
    if nparams >= 4:
        return dynamics
    return lambda t, x, u, dt: dynamics(x, u)


def _rk4(f, x, u, t, h):
    """RK4 step (reference ocp.hpp:311-319); works on DSL values and
    tensors alike, with the JAX package's operation order."""
    half_h = h * 0.5
    k1 = f(t, x, u, h)
    k2 = f(t + half_h, x + k1 * half_h, u, h)
    k3 = f(t + half_h, x + k2 * half_h, u, h)
    k4 = f(t + h, x + k3 * h, u, h)
    return x + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (h / 6.0)


class OCP(Problem):
    """An optimal control problem (reference ocp.hpp:49)."""

    def __init__(
        self,
        num_states: int,
        num_inputs: int,
        dt,
        num_steps: int,
        dynamics: Callable,
        dynamics_type: DynamicsType = DynamicsType.EXPLICIT_ODE,
        timestep_method: TimestepMethod = TimestepMethod.FIXED,
        transcription_method: TranscriptionMethod = TranscriptionMethod.DIRECT_TRANSCRIPTION,
    ) -> None:
        super().__init__()
        if timestep_method != TimestepMethod.FIXED:
            raise NotImplementedError(f"TimestepMethod.{timestep_method.name} {_NOT_PORTED}")
        if transcription_method != TranscriptionMethod.DIRECT_TRANSCRIPTION:
            raise NotImplementedError(
                f"TranscriptionMethod.{transcription_method.name} {_NOT_PORTED}"
            )
        self._num_states = num_states
        self._num_inputs = num_inputs
        self._num_steps = num_steps
        self._dynamics = _normalize_dynamics(dynamics)
        self._dynamics_type = dynamics_type
        self._fixed_dt = _seconds(dt)

        N = num_steps
        # u is num_steps + 1 so the final constraint evaluation works
        # (reference ocp.hpp:120-121).
        self._U = self.decision_variable(num_inputs, N + 1)
        self._u_offset = self._flat_offset_of(self._U)
        self._DT = VariableMatrix(np.full((1, N + 1), self._fixed_dt))
        self._X = self.decision_variable(num_states, N + 1)
        self._x_offset = self._flat_offset_of(self._X)
        self._constrain_direct_transcription()

    # -- public accessors (reference ocp.hpp:254-288) ----------------------

    def X(self) -> VariableMatrix:
        """State variables, shaped (num_states)x(num_steps+1)."""
        return self._X

    def U(self) -> VariableMatrix:
        """Input variables, shaped (num_inputs)x(num_steps+1)."""
        return self._U

    def dt(self) -> VariableMatrix:
        """Timestep variables, shaped 1x(num_steps+1)."""
        return self._DT

    def initial_state(self):
        return self._X[:, 0:1]

    def final_state(self):
        return self._X[:, self._num_steps : self._num_steps + 1]

    def constrain_initial_state(self, initial_state) -> None:
        """(reference ocp.hpp:162-166)"""
        self.subject_to(self.initial_state() == initial_state)

    def constrain_final_state(self, final_state) -> None:
        """(reference ocp.hpp:171-175)"""
        self.subject_to(self.final_state() == final_state)

    def for_each_step(self, callback: Callable) -> None:
        """Invoke callback(x, u) (or callback(t, x, u, dt)) for every step
        (reference ocp.hpp:183-214)."""
        try:
            nparams = len(inspect.signature(callback).parameters)
        except (TypeError, ValueError):
            nparams = 2
        time = Variable(0.0)
        for i in range(self._num_steps + 1):
            x = self._X[:, i : i + 1]
            u = self._U[:, i : i + 1]
            if nparams >= 4:
                dt_i = self._DT[0, i]
                callback(time, x, u, dt_i)
                time = time + dt_i
            else:
                callback(x, u)

    def set_lower_input_bound(self, lower_bound) -> None:
        """(reference ocp.hpp:220-226)"""
        for i in range(self._num_steps + 1):
            self.subject_to(self._U[:, i : i + 1] >= lower_bound)

    def set_upper_input_bound(self, upper_bound) -> None:
        """(reference ocp.hpp:232-238)"""
        for i in range(self._num_steps + 1):
            self.subject_to(self._U[:, i : i + 1] <= upper_bound)

    # -- internals ---------------------------------------------------------

    def _flat_offset_of(self, v: VariableMatrix) -> int:
        """Offset of a registered decision-variable block in the flat
        decision vector (registration order, row-major within blocks)."""
        first = int(v.expr.ids.flat[0])
        offset = 0
        for ids in self._var_ids:
            if ids.shape[0] and int(ids[0]) == first:
                return offset
            offset += ids.shape[0]
        raise ValueError("block not registered")

    def _dynamics_runs_on_tensors(self) -> bool:
        """Probe whether the dynamics function runs on torch tensors."""
        ns, ni = self._num_states, self._num_inputs
        zero = torch.zeros((), dtype=torch.float64)
        try:
            out = self._dynamics(
                zero, torch.zeros((ns, 1), dtype=torch.float64),
                torch.zeros((ni, 1), dtype=torch.float64), zero,
            )
        except (TypeError, ValueError, IndexError, RuntimeError, AttributeError):
            return False
        return isinstance(out, torch.Tensor)

    def _step_linearity(self) -> ExpressionType:
        """Classify the dynamics rows by building one symbolic step through
        the DSL (reference expression_type.hpp). Dynamics that only run on
        tensors classify as NONLINEAR, as in the JAX package."""
        try:
            x_ph = VariableMatrix(self._num_states, 1)
            u_ph = VariableMatrix(self._num_inputs, 1)
            h_ph = Variable(self._fixed_dt)
            t_ph = Variable(0.0)
            if self._dynamics_type == DynamicsType.EXPLICIT_ODE:
                out = _rk4(self._dynamics, x_ph, u_ph, t_ph, h_ph)
            else:
                out = self._dynamics(t_ph, x_ph, u_ph, h_ph)
            return (out - x_ph).type()
        except Exception:  # noqa: BLE001 - any DSL failure means nonlinear
            return ExpressionType.NONLINEAR

    def _constrain_direct_transcription(self) -> None:
        """xₖ₊₁ = RK4(f, xₖ, uₖ) for each step (reference ocp.hpp:359-379)."""
        if not self._dynamics_runs_on_tensors():
            raise NotImplementedError(f"dynamics that only run on the DSL {_NOT_PORTED}")
        ns, ni, N = self._num_states, self._num_inputs, self._num_steps
        x_off, u_off = self._x_offset, self._u_offset
        f = self._dynamics
        fixed = self._fixed_dt
        explicit = self._dynamics_type == DynamicsType.EXPLICIT_ODE

        def step(x0, x1, u0, t0, h):
            if explicit:
                return _rk4(f, x0, u0, t0, h) - x1
            return f(t0, x0, u0, h) - x1

        def block_fn(xflat):
            X = xflat[x_off : x_off + ns * (N + 1)].reshape(ns, N + 1)
            U = xflat[u_off : u_off + ni * (N + 1)].reshape(ni, N + 1)
            dts = torch.full((N,), fixed, dtype=xflat.dtype, device=xflat.device)
            ts = torch.cat([dts.new_zeros(1), torch.cumsum(dts, 0)[:-1]])
            xk = X[:, :-1].T[..., None]  # (N, ns, 1)
            xk1 = X[:, 1:].T[..., None]
            uk = U[:, :-1].T[..., None]
            return torch.func.vmap(step)(xk, xk1, uk, ts, dts).reshape(-1)

        self._subject_to_fn(
            block_fn,
            N * ns,
            self._step_linearity(),
            equality=True,
            # Dynamics rows of step k anchor at stage k (couple z_k, z_{k+1})
            row_stage=np.repeat(np.arange(N), ns),
        )

    # -- banded KKT structure ----------------------------------------------

    def _make_kkt_backend(self, comp, device, syncs):
        """The block-tridiagonal KKT backend when the problem's constraints
        all fit the stage band; None (the dense backend) otherwise."""
        structure = self._stage_structure(comp)
        if structure is None:
            return None
        return BandedBackend(
            structure,
            comp["f"], comp["c_e"], comp["c_i"],
            comp["n"], comp["me"], comp["mi"],
            device, syncs,
        )

    @staticmethod
    def _dense_fallback(reason: str) -> None:
        """The O(N) banded path is a performance contract at long horizons;
        falling back to the dense O(N³) factorization is announced, as in
        the JAX package."""
        warnings.warn(
            f"OCP does not fit the block-tridiagonal KKT structure ({reason}); "
            "using the dense factorization, which does not scale with the "
            "horizon length",
            stacklevel=4,
        )

    def _stage_structure(self, comp) -> StageStructure | None:
        """The stage of every variable and constraint row, or None (with a
        warning) when the problem does not fit the band."""
        ns, ni, N = self._num_states, self._num_inputs, self._num_steps
        K = N + 1
        m = ns + ni
        all_ids = comp["all_ids"]
        if all_ids.shape[0] != K * m:
            return self._dense_fallback("extra decision variables outside the X/U stages")
        if not isinstance(self._X.expr, DecVarExpr) or not isinstance(self._U.expr, DecVarExpr):
            return self._dense_fallback("X/U were overwritten with expressions")
        x_ids = self._X.expr.ids  # (ns, K)
        u_ids = self._U.expr.ids  # (ni, K)
        if x_ids.shape != (ns, K) or u_ids.shape != (ni, K):
            return self._dense_fallback("X/U shape mismatch")

        stage_of_id = {}
        for k in range(K):
            for i in range(ns):
                stage_of_id[int(x_ids[i, k])] = k
            for i in range(ni):
                stage_of_id[int(u_ids[i, k])] = k

        # Staged variable order: z_k = (x_k, u_k); var_perm maps staged
        # position -> flat position
        pos_of_id = {int(g): i for i, g in enumerate(all_ids)}
        var_perm = np.zeros(K * m, dtype=np.int64)
        for k in range(K):
            for i in range(ns):
                var_perm[k * m + i] = pos_of_id[int(x_ids[i, k])]
            for i in range(ni):
                var_perm[k * m + ns + i] = pos_of_id[int(u_ids[i, k])]

        def classify(blocks):
            stages = []
            for b in blocks:
                if isinstance(b, _FnBlock):
                    if b.row_stage is None:
                        return None
                    stages.append(np.asarray(b.row_stage, dtype=np.int64))
                else:
                    es = element_stages(b, stage_of_id).ravel()
                    if np.any(es < 0):
                        return None
                    stages.append(es)
            if not stages:
                return np.zeros(0, dtype=np.int64)
            return np.concatenate(stages).astype(np.int64)

        ce_stage = classify(self._equality)
        ci_stage = classify(self._inequality)
        if ce_stage is None or ci_stage is None:
            return self._dense_fallback("a constraint row couples non-adjacent stages")
        if ce_stage.shape[0] != comp["me"] or ci_stage.shape[0] != comp["mi"]:
            return self._dense_fallback("constraint row count mismatch")

        def slots(stages):
            counters = np.zeros(K, dtype=np.int64)
            out = np.zeros(stages.shape[0], dtype=np.int64)
            for i, s_ in enumerate(stages):
                out[i] = counters[s_]
                counters[s_] += 1
            return out, int(counters.max()) if stages.shape[0] else 0

        ce_slot, p = slots(ce_stage)
        ci_slot, q = slots(ci_stage)
        if p > 4 * m or q > 8 * m:
            return self._dense_fallback("pathologically uneven per-stage constraint counts")

        return StageStructure(
            num_stages=K,
            stage_width=m,
            var_perm=var_perm,
            ce_stage=ce_stage,
            ce_slot=ce_slot,
            eq_pad=max(p, 1),
            ci_stage=ci_stage,
            ci_slot=ci_slot,
            ineq_pad=max(q, 1),
        )
