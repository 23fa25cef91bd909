"""Carry state across from the JAX package as numpy arrays.

Tests use these to start the port and the JAX package from the same
state. Only numpy crosses the boundary; this module never imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays
from sleipnir_tpu_torch.optimization.solver.interior_point import IPMState
from sleipnir_tpu_torch.optimization.solver.kkt_banded import BandedDerivs
from sleipnir_tpu_torch.optimization.solver.util.filter import FilterState

#: IPMState fields the port keeps as host integers.
_HOST_INT_FIELDS = ("full_step_rejected_counter", "iterations", "status", "infeas_streak")

#: JAX BandedDerivs fields that hold the arrowhead border, which the port
#: does not carry; they must be empty.
_BORDER_FIELDS = ("Hb", "Hbb", "Aeb", "Aib")


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def banded_system_from_numpy(D, E, b, device):
    """A block-tridiagonal system as f64 tensors with a leading batch axis:
    D (K, w, w) or (B, K, w, w), E (K-1, w, w) or (B, K-1, w, w), b (K, w),
    (K, w, r) or with a leading B. Returns (D, E, b)."""
    D, E, b = (_tensor(a, device) for a in (D, E, b))
    if D.dim() == 3:
        D, E, b = D[None], E[None], b[None]
    return D.contiguous(), E.contiguous(), b.contiguous()


def ipm_state_from_numpy(fields: Mapping, device) -> IPMState:
    """The port's IPMState from the fields of a JAX `IPMState` turned into
    numpy: a mapping of field name to array, where `derivs`, `filt` and
    `scaling` are mappings of their own fields."""
    derivs = fields["derivs"]
    for name in _BORDER_FIELDS:
        if name in derivs and np.asarray(derivs[name]).size:
            raise NotImplementedError(
                "the arrowhead border is not ported yet (ROADMAP queue 1 item 11)"
            )
    values = {}
    for name in IPMState._fields:
        a = fields[name]
        if name == "derivs":
            values[name] = BandedDerivs(
                *(_tensor(a[k], device) for k in BandedDerivs._fields)
            )
        elif name == "filt":
            values[name] = FilterState(*(_tensor(a[k], device) for k in FilterState._fields))
        elif name == "scaling":
            values[name] = ScalingArrays(*(_tensor(a[k], device) for k in ScalingArrays._fields))
        elif name in _HOST_INT_FIELDS:
            values[name] = int(np.asarray(a))
        else:
            values[name] = _tensor(a, device)
    return IPMState(**values)
