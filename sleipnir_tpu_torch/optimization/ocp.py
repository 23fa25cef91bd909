"""Optimal control problem (OCP) layer
(reference optimization/ocp.hpp:49-406 and the ocp/ enum headers).

Port of `sleipnir_tpu/optimization/ocp.py`: a fixed- or variable-timestep
trajectory optimization by one of three transcriptions (direct
transcription, direct collocation, single shooting) over explicit-ODE or
discrete dynamics, with RK4 integration.

When the dynamics function runs on torch tensors (it does whenever it is
written with this package's operators), the N dynamics constraints are
registered as ONE functional block that `torch.func.vmap`s a step over
the horizon, instead of the reference's O(N·nodes) symbolic expansion
(ocp.hpp:359-379). Dynamics that only run on the DSL take the reference's
symbolic path. The problem's stage structure then selects the banded KKT
backend: per-step timesteps widen the stage, a shared timestep becomes
the backend's border column. A problem that does not fit the stage band
solves on the dense backend, with a warning; single shooting takes the
dense backend without one.
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
        self._num_states = num_states
        self._num_inputs = num_inputs
        self._num_steps = num_steps
        self._dynamics = _normalize_dynamics(dynamics)
        self._dynamics_type = dynamics_type
        self._timestep_method = timestep_method
        self._transcription_method = transcription_method
        dt_s = _seconds(dt)

        N = num_steps
        # u is num_steps + 1 so the final constraint evaluation works
        # (reference ocp.hpp:120-121).
        self._U = self.decision_variable(num_inputs, N + 1)
        self._u_offset = self._flat_offset_of(self._U)

        if timestep_method == TimestepMethod.FIXED:
            self._DT = VariableMatrix(np.full((1, N + 1), dt_s))
            self._dt_offset = None
            self._fixed_dt = dt_s
        elif timestep_method == TimestepMethod.VARIABLE_SINGLE:
            single_dt = self.decision_variable()
            single_dt.set_value(dt_s)
            self._single_dt = single_dt
            self._dt_offset = self._flat_offset_of(single_dt)
            # The single decision variable broadcast across all steps as
            # one expression node: N+1 chained element assignments would
            # build an O(N)-deep tree that overflows recursion at long
            # horizons, and a row of N+1 parts costs every evaluation of
            # the dt bounds N+1 eager operations.
            self._DT = VariableMatrix(np.ones((1, N + 1))) * single_dt
        else:  # VARIABLE
            self._DT = self.decision_variable(1, N + 1)
            self._DT.set_value(np.full((1, N + 1), dt_s))
            self._dt_offset = self._flat_offset_of(self._DT)

        if transcription_method == TranscriptionMethod.SINGLE_SHOOTING:
            # States are expressions of the inputs, not decision variables
            # (reference ocp.hpp:151-156). Column 0 stays an unregistered
            # variable (a runtime parameter) so the initial state is
            # settable.
            self._X = VariableMatrix(num_states, N + 1)
            self._x_offset = None
            self._constrain_single_shooting()
        else:
            self._X = self.decision_variable(num_states, N + 1)
            self._x_offset = self._flat_offset_of(self._X)
            if transcription_method == TranscriptionMethod.DIRECT_TRANSCRIPTION:
                self._constrain_direct_transcription()
            else:
                if dynamics_type != DynamicsType.EXPLICIT_ODE:
                    raise ValueError(
                        "direct collocation requires an explicit ODE (reference ocp.hpp:323)"
                    )
                self._constrain_direct_collocation()

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

    def set_min_timestep(self, min_timestep) -> None:
        """(reference ocp.hpp:243-245)"""
        self.subject_to(self._DT >= _seconds(min_timestep))

    def set_max_timestep(self, max_timestep) -> None:
        """(reference ocp.hpp:250-252)"""
        self.subject_to(self._DT <= _seconds(max_timestep))

    # -- internals ---------------------------------------------------------

    def _flat_offset_of(self, v) -> int:
        """Offset of a registered decision-variable block (a VariableMatrix
        or a scalar Variable) in the flat decision vector (registration
        order, row-major within blocks)."""
        first = int(np.asarray(v.expr.ids).flat[0])
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
        the DSL (reference expression_type.hpp). A fixed timestep is a
        constant of the step; the variable-timestep methods make it a
        decision variable. Dynamics that only run on tensors classify as
        NONLINEAR, as in the JAX package."""
        try:
            x_ph = VariableMatrix(self._num_states, 1)
            u_ph = VariableMatrix(self._num_inputs, 1)
            if self._timestep_method == TimestepMethod.FIXED:
                h_ph = Variable(self._fixed_dt)
                t_ph = Variable(0.0)
            else:
                h_ph = Variable()
                t_ph = Variable()
            if self._dynamics_type == DynamicsType.EXPLICIT_ODE:
                out = _rk4(self._dynamics, x_ph, u_ph, t_ph, h_ph)
            else:
                out = self._dynamics(t_ph, x_ph, u_ph, h_ph)
            return (out - x_ph).type()
        except Exception:  # noqa: BLE001 - any DSL failure means nonlinear
            return ExpressionType.NONLINEAR

    def _dts_fn(self) -> Callable:
        """dts(xflat) -> the (N,) timesteps of the steps."""
        N = self._num_steps
        if self._timestep_method == TimestepMethod.FIXED:
            fixed = self._fixed_dt
            return lambda xflat: torch.full((N,), fixed, dtype=xflat.dtype, device=xflat.device)
        off = self._dt_offset
        if self._timestep_method == TimestepMethod.VARIABLE_SINGLE:
            return lambda xflat: (
                torch.ones((N,), dtype=xflat.dtype, device=xflat.device) * xflat[off]
            )
        return lambda xflat: xflat[off : off + N]

    def _constrain_direct_transcription(self) -> None:
        """xₖ₊₁ = RK4(f, xₖ, uₖ) for each step (reference ocp.hpp:359-379)."""
        if self._dynamics_runs_on_tensors():
            self._add_vmapped_dynamics_block(collocation=False)
        else:
            self._constrain_direct_transcription_dsl()

    def _constrain_direct_collocation(self) -> None:
        """Cubic Hermite collocation (reference ocp.hpp:322-356)."""
        if self._dynamics_runs_on_tensors():
            self._add_vmapped_dynamics_block(collocation=True)
        else:
            self._constrain_direct_collocation_dsl()

    def _add_vmapped_dynamics_block(self, *, collocation: bool) -> None:
        ns, ni, N = self._num_states, self._num_inputs, self._num_steps
        x_off, u_off = self._x_offset, self._u_offset
        f = self._dynamics
        dts_fn = self._dts_fn()
        explicit = self._dynamics_type == DynamicsType.EXPLICIT_ODE

        def transcription_step(x0, x1, u0, t0, h):
            if explicit:
                return _rk4(f, x0, u0, t0, h) - x1
            return f(t0, x0, u0, h) - x1

        def collocation_step(x0, x1, u0, u1, t0, h):
            # Derivation:
            # https://mec560sbu.github.io/2016/09/30/direct_collocation/
            # (reference ocp.hpp:327-354)
            xdot0 = f(t0, x0, u0, h)
            xdot1 = f(t0 + h, x1, u1, h)
            xdot_c = -3.0 / (2.0 * h) * (x0 - x1) - 0.25 * (xdot0 + xdot1)
            t_c = t0 + 0.5 * h
            x_c = 0.5 * (x0 + x1) + h / 8.0 * (xdot0 - xdot1)
            u_c = 0.5 * (u0 + u1)
            return f(t_c, x_c, u_c, h) - xdot_c

        def block_fn(xflat):
            X = xflat[x_off : x_off + ns * (N + 1)].reshape(ns, N + 1)
            U = xflat[u_off : u_off + ni * (N + 1)].reshape(ni, N + 1)
            dts = dts_fn(xflat)
            ts = torch.cat([dts.new_zeros(1), torch.cumsum(dts, 0)[:-1]])
            xk = X[:, :-1].T[..., None]  # (N, ns, 1)
            xk1 = X[:, 1:].T[..., None]
            uk = U[:, :-1].T[..., None]
            if collocation:
                uk1 = U[:, 1:].T[..., None]
                res = torch.func.vmap(collocation_step)(xk, xk1, uk, uk1, ts, dts)
            else:
                res = torch.func.vmap(transcription_step)(xk, xk1, uk, ts, dts)
            return res.reshape(-1)

        self._subject_to_fn(
            block_fn,
            N * ns,
            self._step_linearity(),
            equality=True,
            # Dynamics rows of step k anchor at stage k (couple z_k, z_{k+1})
            row_stage=np.repeat(np.arange(N), ns),
        )

    def _constrain_direct_transcription_dsl(self) -> None:
        """The symbolic path of the reference (ocp.hpp:358-379), for
        dynamics that only run on the DSL."""
        time = Variable(0.0)
        for i in range(self._num_steps):
            x_begin = self._X[:, i : i + 1]
            x_end = self._X[:, i + 1 : i + 2]
            u = self._U[:, i : i + 1]
            dt = self._DT[0, i]
            if self._dynamics_type == DynamicsType.EXPLICIT_ODE:
                self.subject_to(x_end == _rk4(self._dynamics, x_begin, u, time, dt))
            else:
                self.subject_to(x_end == self._dynamics(time, x_begin, u, dt))
            time = time + dt

    def _constrain_direct_collocation_dsl(self) -> None:
        """(reference ocp.hpp:321-356)"""
        f = self._dynamics
        time = Variable(0.0)
        for i in range(self._num_steps):
            h = self._DT[0, i]
            t_begin = time
            t_end = t_begin + h
            x_begin = self._X[:, i : i + 1]
            x_end = self._X[:, i + 1 : i + 2]
            u_begin = self._U[:, i : i + 1]
            u_end = self._U[:, i + 1 : i + 2]
            xdot_begin = f(t_begin, x_begin, u_begin, h)
            xdot_end = f(t_end, x_end, u_end, h)
            xdot_c = (x_begin - x_end) * (-3.0) / (2.0 * h) - (xdot_begin + xdot_end) * 0.25
            t_c = t_begin + h * 0.5
            x_c = (x_begin + x_end) * 0.5 + (xdot_begin - xdot_end) * (h / 8.0)
            u_c = (u_begin + u_end) * 0.5
            self.subject_to(xdot_c == f(t_c, x_c, u_c, h))
            time = time + h

    def _constrain_single_shooting(self) -> None:
        """(reference ocp.hpp:381-401)"""
        time = Variable(0.0)
        for i in range(self._num_steps):
            x_begin = self._X[:, i : i + 1]
            u = self._U[:, i : i + 1]
            dt = self._DT[0, i]
            if self._dynamics_type == DynamicsType.EXPLICIT_ODE:
                x_next = _rk4(self._dynamics, x_begin, u, time, dt)
            else:
                x_next = self._dynamics(time, x_begin, u, dt)
            self._X[:, i + 1 : i + 2] = x_next
            time = time + dt

    # -- banded KKT structure ----------------------------------------------

    def _make_kkt_backend(self, comp, device, dtype, syncs):
        """The block-tridiagonal KKT backend when the problem's constraints
        all fit the stage band; None (the dense backend) otherwise."""
        structure = self._stage_structure(comp)
        if structure is None:
            return None
        mesh, mesh_axis = self._time_mesh if self._time_mesh is not None else (None, "t")
        return BandedBackend(
            structure,
            comp["f"], comp["c_e"], comp["c_i"],
            comp["n"], comp["me"], comp["mi"],
            device, syncs, dtype, mesh=mesh, mesh_axis=mesh_axis,
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
        if self._transcription_method == TranscriptionMethod.SINGLE_SHOOTING:
            # Single shooting has no per-stage state variables: the dense
            # path is its natural one, with no warning.
            return None
        ns, ni, N = self._num_states, self._num_inputs, self._num_steps
        K = N + 1
        # Per-step timesteps (VARIABLE) couple like a stage variable (dt_k
        # appears only in stage k's dynamics rows and its own bound rows),
        # so they fold into the band with stage width ns+ni+1. The shared
        # dt of VARIABLE_SINGLE couples to every stage: it becomes a border
        # variable, and the KKT system an arrowhead (band + border).
        variable_per_step = self._timestep_method == TimestepMethod.VARIABLE
        single_dt = self._timestep_method == TimestepMethod.VARIABLE_SINGLE
        m = ns + ni + (1 if variable_per_step else 0)
        nb = 1 if single_dt else 0
        all_ids = comp["all_ids"]
        if all_ids.shape[0] != K * m + nb:
            return self._dense_fallback("extra decision variables outside the X/U stages")
        if not isinstance(self._X.expr, DecVarExpr) or not isinstance(self._U.expr, DecVarExpr):
            return self._dense_fallback("X/U were overwritten with expressions")
        x_ids = self._X.expr.ids  # (ns, K)
        u_ids = self._U.expr.ids  # (ni, K)
        if x_ids.shape != (ns, K) or u_ids.shape != (ni, K):
            return self._dense_fallback("X/U shape mismatch")
        staged_ids = [x_ids, u_ids]
        if variable_per_step:
            if not isinstance(self._DT.expr, DecVarExpr):
                return self._dense_fallback("DT was overwritten with an expression")
            if self._DT.expr.ids.shape != (1, K):
                return self._dense_fallback("DT shape mismatch")
            staged_ids.append(self._DT.expr.ids)
        # (m, K): the ids of stage k's variables z_k = (x_k, u_k[, dt_k])
        stage_ids = np.concatenate(staged_ids, axis=0)

        # The border dt is deliberately not in stage_of_id: element_stages
        # treats it like a constant, so rows mixing it with one stage keep
        # that stage, and rows touching only it classify as -1 (border).
        stage_of_id = {int(g): k for k in range(K) for g in stage_ids[:, k]}

        # Staged variable order: var_perm maps staged position -> flat
        # position
        pos_of_id = {int(g): i for i, g in enumerate(all_ids)}
        var_perm = np.array([pos_of_id[int(g)] for g in stage_ids.T.ravel()], dtype=np.int64)
        if single_dt:
            border = np.array([pos_of_id[int(self._single_dt.expr.ids)]], dtype=np.int64)
        else:
            border = np.zeros(0, dtype=np.int64)

        def classify(blocks, allow_border_rows):
            stages = []
            for b in blocks:
                if isinstance(b, _FnBlock):
                    if b.row_stage is None:
                        return None
                    stages.append(np.asarray(b.row_stage, dtype=np.int64))
                else:
                    es = element_stages(b, stage_of_id).ravel()
                    if np.any(es == -2):
                        return None
                    if np.any(es == -1) and not (allow_border_rows and nb > 0):
                        return None
                    stages.append(es)
            if not stages:
                return np.zeros(0, dtype=np.int64)
            out = np.concatenate(stages).astype(np.int64)
            # Border-only rows (the N+1 broadcast dt bounds) have all-zero
            # staged Jacobian rows, so their stage is only slot storage:
            # spread them round-robin so no stage's slot count blows up.
            border_rows = np.where(out == -1)[0]
            out[border_rows] = np.arange(border_rows.shape[0]) % K
            return out

        ce_stage = classify(self._equality, allow_border_rows=False)
        ci_stage = classify(self._inequality, allow_border_rows=True)
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
            border=border,
        )
