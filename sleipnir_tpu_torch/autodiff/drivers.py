"""Gradient / Jacobian / Hessian drivers.

Port of `sleipnir_tpu/autodiff/drivers.py` (API parity with reference
autodiff/gradient.hpp:25, jacobian.hpp:31, hessian.hpp:35), computed by
`torch.func` transformation of the compiled expression.

`.value()` reflects the *current* values of all involved variables, as in
the reference's set_value-then-revalue workflow; variables other than
`wrt` enter the compiled function as runtime parameters. Evaluation runs
on the card unless the caller passes `device="cpu"`; a CUDA device that
is absent raises at the first `.value()`. `.get()` is symbolic and
works without one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev

from sleipnir_tpu_torch.autodiff import expression as ex
from sleipnir_tpu_torch.autodiff.expression import CompiledEval, Expr
from sleipnir_tpu_torch.autodiff.variable import Variable, VariableBlock, VariableMatrix

_STRUCTURAL_OPS = {
    "getitem",
    "setblock",
    "vstack",
    "hstack",
    "transpose",
    "reshape",
}


def leaf_id_array(expr: Expr) -> np.ndarray:
    """The decision-variable id of every element of a structural
    expression (leaves rearranged by slicing, stacking or assignment only)."""

    def rec(e: Expr) -> np.ndarray:
        if isinstance(e, ex.DecVarExpr):
            return e.ids.astype(np.float64)
        if isinstance(e, ex.ConstExpr):
            raise TypeError("wrt contains non-decision-variable entries")
        if isinstance(e, ex.OpExpr) and e.op in _STRUCTURAL_OPS:
            return ex._eval_host(e.op, e.static, [rec(a) for a in e.args])
        raise TypeError("wrt must be composed of pure decision variables")

    return rec(expr).astype(np.int64)


def _wrt_ids(wrt) -> np.ndarray:
    if isinstance(wrt, Variable):
        return leaf_id_array(wrt.expr).reshape(1)
    if isinstance(wrt, VariableBlock):
        wrt = wrt._as_matrix()
    if isinstance(wrt, VariableMatrix):
        return leaf_id_array(wrt.expr).ravel()
    raise TypeError(f"wrt must be Variable or VariableMatrix, got {type(wrt)}")


def _value_expr(v) -> Expr:
    if isinstance(v, Variable):
        return v.expr
    if isinstance(v, VariableBlock):
        v = v._as_matrix()
    if isinstance(v, VariableMatrix):
        return v.expr
    raise TypeError(f"expected Variable or VariableMatrix, got {type(v)}")


def _symbolic(expr, wrt_ids, kind):
    """Symbolic derivative as a VariableMatrix (reference `get()` returning
    expression-valued derivatives, jacobian.hpp:113-129), usable in further
    costs and constraints."""
    leaf = ex.DecVarExpr(np.asarray(wrt_ids, dtype=np.int64).reshape(-1))
    if kind == "grad":
        node = ex.reshape(ex.grad_of(expr, leaf), (leaf.ids.size, 1))
    elif kind == "jac":
        node = ex.jac_of(expr, leaf)
    else:  # hessian: Jacobian of the symbolic gradient
        node = ex.jac_of(ex.grad_of(expr, leaf), leaf)
    return VariableMatrix._from_expr(node)


class _Driver:
    """The compiled expression, its device, and the evaluation point. The
    device is resolved, and the constants prepared on it, at the first
    `.value()`: `.get()` is symbolic and needs no device, as in the JAX
    package, whose drivers compile lazily."""

    def __init__(self, expr: Expr, wrt, device: str) -> None:
        self._device_name = device
        self._device = None
        self._wrt_ids = _wrt_ids(wrt)
        self._expr = expr
        self._compiled = CompiledEval([expr], self._wrt_ids)

    def _point(self):
        if self._device is None:
            # Imported here: the optimization layer imports this package.
            from sleipnir_tpu_torch.optimization.problem import resolve_device  # noqa: PLC0415

            device = resolve_device(self._device_name)
            self._compiled.prepare(device)
            self._device = device

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float64, device=self._device)

        return on_device(ex._registry.get(self._wrt_ids)), on_device(self._compiled.gather_params())

    def _scalar(self, x, params):
        (v,) = self._compiled(x, params)
        return v.reshape(())

    def _vector(self, x, params):
        (v,) = self._compiled(x, params)
        return v.reshape(-1)


class Gradient(_Driver):
    """∇f of a scalar with respect to a variable vector (reference
    gradient.hpp:25). value() is an (n, 1) array, the reference's column
    SparseVector layout."""

    def __init__(self, variable, wrt, *, device: str = "cuda") -> None:
        super().__init__(_value_expr(variable), wrt, device)
        self._grad = grad(self._scalar)

    def value(self) -> np.ndarray:
        return self._grad(*self._point()).cpu().numpy().reshape(-1, 1)

    def get(self) -> VariableMatrix:
        return _symbolic(ex.reshape(self._expr, ()), self._wrt_ids, "grad")


class Jacobian(_Driver):
    """∂y/∂x of a vector with respect to a variable vector (reference
    jacobian.hpp:31): forward mode when x is no longer than y, else
    reverse mode."""

    def __init__(self, variables, wrt, *, device: str = "cuda") -> None:
        super().__init__(_value_expr(variables), wrt, device)
        self._m = self._expr.size
        n = self._wrt_ids.shape[0]
        self._jac = jacfwd(self._vector) if n <= self._m else jacrev(self._vector)

    def value(self) -> np.ndarray:
        out = self._jac(*self._point())
        return out.cpu().numpy().reshape(self._m, self._wrt_ids.shape[0])

    def get(self) -> VariableMatrix:
        return _symbolic(self._expr, self._wrt_ids, "jac")


class Hessian(_Driver):
    """∇²f of a scalar with respect to a variable vector (reference
    hessian.hpp:35)."""

    def __init__(self, variable, wrt, *, device: str = "cuda") -> None:
        super().__init__(_value_expr(variable), wrt, device)
        self._hess = hessian(self._scalar)

    def value(self) -> np.ndarray:
        n = self._wrt_ids.shape[0]
        return self._hess(*self._point()).cpu().numpy().reshape(n, n)

    def get(self) -> VariableMatrix:
        return _symbolic(ex.reshape(self._expr, ()), self._wrt_ids, "hessian")
