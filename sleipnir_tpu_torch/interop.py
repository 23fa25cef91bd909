"""Carry state across from the JAX package as numpy arrays.

Tests use these to start the port and the JAX package from the same
state. Only numpy crosses the boundary; this module never imports JAX.
Floating arrays become tensors of the solve's dtype (float64 unless
`dtype` says otherwise), as the JAX package converts them at its own
boundary.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
from sleipnir_tpu_torch.optimization.solver.interior_point import IPMState
from sleipnir_tpu_torch.optimization.solver.kkt_backend import DenseDerivs
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedDerivs
from sleipnir_tpu_torch.optimization.solver.util.filter import FilterState

#: Solver state fields the port keeps as host integers.
_HOST_INT_FIELDS = ("full_step_rejected_counter", "iterations", "status", "infeas_streak")


def _tensor(a, device, dtype=torch.float64) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def banded_system_from_numpy(D, E, b, device, dtype=torch.float64):
    """A block-tridiagonal system as tensors with a leading batch axis:
    D (K, w, w) or (B, K, w, w), E (K-1, w, w) or (B, K-1, w, w), b (K, w),
    (K, w, r) or with a leading B. Returns (D, E, b)."""
    D, E, b = (_tensor(a, device, dtype) for a in (D, E, b))
    if D.dim() == 3:
        D, E, b = D[None], E[None], b[None]
    return D.contiguous(), E.contiguous(), b.contiguous()


def ipm_state_from_numpy(fields: Mapping, device, dtype=torch.float64) -> IPMState:
    """The port's IPMState from the fields of a JAX `IPMState` turned into
    numpy: a mapping of field name to array, where `derivs`, `filt` and
    `scaling` are mappings of their own fields."""
    return state_from_numpy(IPMState, fields, device, dtype)


def state_from_numpy(state_cls, fields: Mapping, device, dtype=torch.float64):
    """A port solver state (`IPMState`, `sqp.SQPState`,
    `newton.NewtonState`) from the fields of the JAX package's state of
    the same name turned into numpy, as `ipm_state_from_numpy` takes them.
    The derivatives are dense (`DenseDerivs`) when they hold `H`, else
    banded, border fields (`Hb`, `Hbb`, `Aeb`, `Aib`) included."""
    derivs = fields["derivs"]
    derivs_cls = DenseDerivs if "H" in derivs else BandedDerivs
    values = {}
    for name in state_cls._fields:
        a = fields[name]
        if name == "derivs":
            values[name] = derivs_cls(*(_tensor(a[k], device, dtype) for k in derivs_cls._fields))
        elif name == "filt":
            values[name] = FilterState(*(_tensor(a[k], device, dtype) for k in FilterState._fields))
        elif name == "scaling":
            values[name] = ScalingArrays(
                *(_tensor(a[k], device, dtype) for k in ScalingArrays._fields)
            )
        elif name in _HOST_INT_FIELDS:
            values[name] = int(np.asarray(a))
        else:
            values[name] = _tensor(a, device, dtype)
    return state_cls(**values)
