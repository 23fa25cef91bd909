"""Array-granularity expression DAG, evaluated with torch.

Port of `sleipnir_tpu/autodiff/expression.py`. The DAG is built on the
host with numpy (ids, shapes, folded constants) exactly as in the JAX
package; it is compiled once into a pure torch function of the flat
decision vector (`CompiledEval`), and derivatives come from `torch.func`
(`grad`, `jvp`, `jacfwd`, `vmap`) on that function. Every op in the
`_EVAL` table is out-of-place, so the compiled functions compose with
those transforms.

Like the reference, every node carries its linearity class
(`ExpressionType`), and operator constructors constant-fold and prune
identities (reference autodiff/expression.hpp:155-343).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff.expression_type import (
    ExpressionType,
    add_type,
    div_type,
    mul_type,
    nonlinear_type,
    pow_type,
)
from sleipnir_tpu_torch.ops import accurate_math

# ---------------------------------------------------------------------------
# Global decision-variable registry
#
# Every scalar decision variable has a unique integer id and a current value
# (reference autodiff/variable.hpp:137 and problem.hpp:676).
# ---------------------------------------------------------------------------


class _VariableRegistry:
    """Growable store of current values for all scalar decision variables."""

    def __init__(self) -> None:
        self._values = np.zeros(1024, dtype=np.float64)
        self._size = 0

    def new_ids(self, count: int) -> np.ndarray:
        start = self._size
        self._size += count
        while self._size > self._values.shape[0]:
            self._values = np.concatenate(
                [self._values, np.zeros_like(self._values)]
            )
        return np.arange(start, start + count, dtype=np.int64)

    def get(self, ids: np.ndarray) -> np.ndarray:
        return self._values[ids]

    def set(self, ids: np.ndarray, values) -> None:
        self._values[ids] = values


_registry = _VariableRegistry()


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base class for DAG nodes. Shape is () for scalars or (rows, cols)."""

    __slots__ = ("shape", "lin")

    shape: tuple[int, ...]
    lin: ExpressionType

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class ConstExpr(Expr):
    """A constant leaf (folded aggressively, like the reference's pruning)."""

    __slots__ = ("value",)

    def __init__(self, value) -> None:
        arr = np.asarray(value, dtype=np.float64)
        self.value = arr
        self.shape = arr.shape
        self.lin = ExpressionType.CONSTANT


class DecVarExpr(Expr):
    """A leaf of scalar decision variables, identified by global ids."""

    __slots__ = ("ids",)

    def __init__(self, ids: np.ndarray) -> None:
        self.ids = ids
        self.shape = ids.shape
        self.lin = ExpressionType.LINEAR


class ParamExpr(DecVarExpr):
    """A mutable constant leaf: CONSTANT for linearity, never folded, and
    fed to the compiled program as a runtime parameter (reference
    docs/usage.md:391-410)."""

    __slots__ = ()

    def __init__(self, ids: np.ndarray) -> None:
        super().__init__(ids)
        self.lin = ExpressionType.CONSTANT


def new_parameter(value) -> ParamExpr:
    """Create a mutable-constant (parameter) leaf holding `value`."""
    arr = np.asarray(value, dtype=np.float64)
    ids = _registry.new_ids(arr.size).reshape(arr.shape)
    _registry.set(ids, arr)
    return ParamExpr(ids)


class OpExpr(Expr):
    """An operation applied to child expressions."""

    __slots__ = ("op", "args", "static")

    def __init__(
        self,
        op: str,
        args: tuple[Expr, ...],
        static: tuple,
        shape: tuple[int, ...],
        lin: ExpressionType,
    ) -> None:
        self.op = op
        self.args = args
        self.static = static
        self.shape = shape
        self.lin = lin


def new_decision_vars(shape: tuple[int, ...]) -> DecVarExpr:
    """Create fresh decision variables registered in the global registry."""
    count = int(np.prod(shape)) if shape else 1
    ids = _registry.new_ids(count).reshape(shape)
    return DecVarExpr(ids)


def constant(value) -> ConstExpr:
    return ConstExpr(value)


# ---------------------------------------------------------------------------
# Op evaluation table
#
# Each entry maps an op name to fn(static, *child_values) on torch tensors.
# Host-side folding and structural analysis run the same table on CPU
# tensors wrapped around numpy arrays.
# ---------------------------------------------------------------------------


def _index(v: torch.Tensor, dim: int, rng: tuple) -> torch.Tensor:
    """v restricted to range(*rng) along dim (negative steps included)."""
    start, stop, step = rng
    if step > 0:
        return v[(slice(None),) * dim + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=v.device)
    return v.index_select(dim, idx)


def _getitem(static, v):
    rs, cs, outshape = static
    if v.dim() == 0:
        return v.reshape(outshape)
    return _index(_index(v, 0, rs), 1, cs).reshape(outshape)


def _setblock(static, base, value):
    rs, cs = static
    rows = torch.arange(*rs, device=base.device)
    cols = torch.arange(*cs, device=base.device)
    value = torch.broadcast_to(value.to(base.dtype), (len(rows), len(cols)))
    return torch.index_put(base, (rows[:, None], cols[None, :]), value)


def _solve(a, b):
    if b.dim() == 1:
        b = b.reshape(-1, 1)
    return torch.linalg.solve(a, b)


def _cbrt(a):
    return torch.sign(a) * torch.abs(a) ** (1.0 / 3.0)


def _cat(axis, parts):
    return torch.cat([torch.atleast_2d(p) for p in parts], dim=axis)


_EVAL: dict[str, Callable] = {
    "add": lambda s, a, b: a + b,
    "sub": lambda s, a, b: a - b,
    "mul": lambda s, a, b: a * b,
    "div": lambda s, a, b: a / b,
    "matmul": lambda s, a, b: a @ b,
    "neg": lambda s, a: -a,
    "pow_const": lambda s, a: a ** s[0],
    "pow_expr": lambda s, a, b: a**b,
    "abs": lambda s, a: torch.abs(a),
    "acos": lambda s, a: torch.acos(a),
    "asin": lambda s, a: torch.asin(a),
    "atan": lambda s, a: torch.atan(a),
    "atan2": lambda s, a, b: torch.atan2(a, b),
    "cbrt": lambda s, a: _cbrt(a),
    "cos": lambda s, a: accurate_math.cos(a),
    "cosh": lambda s, a: torch.cosh(a),
    "erf": lambda s, a: torch.erf(a),
    "exp": lambda s, a: torch.exp(a),
    "hypot": lambda s, a, b: torch.hypot(a, b),
    "log": lambda s, a: torch.log(a),
    "log10": lambda s, a: torch.log10(a),
    "maximum": lambda s, a, b: torch.maximum(a, b),
    "minimum": lambda s, a, b: torch.minimum(a, b),
    "sign": lambda s, a: torch.sign(a),
    "sin": lambda s, a: accurate_math.sin(a),
    "sinh": lambda s, a: torch.sinh(a),
    "sqrt": lambda s, a: torch.sqrt(a),
    "tan": lambda s, a: accurate_math.tan(a),
    "tanh": lambda s, a: torch.tanh(a),
    "transpose": lambda s, a: a.T,
    "reshape": lambda s, a: a.reshape(s[0]),
    "getitem": _getitem,
    "setblock": _setblock,
    "vstack": lambda s, *args: _cat(0, args),
    "hstack": lambda s, *args: _cat(1, args),
    "solve": lambda s, a, b: _solve(a, b),
    "expm": lambda s, a: torch.linalg.matrix_exp(a),
    "sum": lambda s, a: torch.sum(a),
}


def _eval_host(op: str, static: tuple, vals: Sequence[np.ndarray]) -> np.ndarray:
    """Run an `_EVAL` entry on host numpy values (CPU tensors around them)."""
    out = _EVAL[op](static, *(torch.as_tensor(np.asarray(v)) for v in vals))
    return out.numpy()


# ---------------------------------------------------------------------------
# Constructors with constant folding and identity pruning
# (reference autodiff/expression.hpp:155-343)
# ---------------------------------------------------------------------------


def _is_const_zero(e: Expr) -> bool:
    return isinstance(e, ConstExpr) and bool(np.all(e.value == 0.0))


def _is_const_one(e: Expr) -> bool:
    return isinstance(e, ConstExpr) and bool(np.all(e.value == 1.0))


def _fold(op: str, args: tuple[Expr, ...], static: tuple) -> ConstExpr:
    return ConstExpr(_eval_host(op, static, [a.value for a in args]))


def _broadcast_shapes(a: tuple, b: tuple) -> tuple:
    return tuple(np.broadcast_shapes(a, b))


def make_op(
    op: str,
    args: Sequence[Expr],
    static: tuple = (),
    shape: tuple | None = None,
    lin: ExpressionType | None = None,
) -> Expr:
    """Build an op node, constant-folding when all children are constant."""
    args = tuple(args)
    if all(isinstance(a, ConstExpr) for a in args):
        return _fold(op, args, static)
    if shape is None:
        shape = args[0].shape
    if lin is None:
        lin = ExpressionType.NONLINEAR
    return OpExpr(op, args, static, shape, lin)


def add(a: Expr, b: Expr) -> Expr:
    if _is_const_zero(a) and a.shape in ((), b.shape):
        return b
    if _is_const_zero(b) and b.shape in ((), a.shape):
        return a
    shape = _broadcast_shapes(a.shape, b.shape)
    return make_op("add", (a, b), shape=shape, lin=add_type(a.lin, b.lin))


def sub(a: Expr, b: Expr) -> Expr:
    if _is_const_zero(b) and b.shape in ((), a.shape):
        return a
    shape = _broadcast_shapes(a.shape, b.shape)
    if _is_const_zero(a) and a.shape in ((), b.shape):
        return neg(b)
    return make_op("sub", (a, b), shape=shape, lin=add_type(a.lin, b.lin))


def neg(a: Expr) -> Expr:
    return make_op("neg", (a,), shape=a.shape, lin=a.lin)


def mul(a: Expr, b: Expr) -> Expr:
    """Elementwise / scalar-broadcast product."""
    shape = _broadcast_shapes(a.shape, b.shape)
    if _is_const_zero(a) or _is_const_zero(b):
        return ConstExpr(np.zeros(shape))
    if _is_const_one(a) and shape == b.shape:
        return b
    if _is_const_one(b) and shape == a.shape:
        return a
    return make_op("mul", (a, b), shape=shape, lin=mul_type(a.lin, b.lin))


def div(a: Expr, b: Expr) -> Expr:
    if _is_const_one(b):
        return a
    shape = _broadcast_shapes(a.shape, b.shape)
    return make_op("div", (a, b), shape=shape, lin=div_type(a.lin, b.lin))


def matmul(a: Expr, b: Expr) -> Expr:
    if len(a.shape) != 2 or len(b.shape) != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"incompatible shapes for @: {a.shape} and {b.shape}")
    shape = (a.shape[0], b.shape[1])
    if _is_const_zero(a) or _is_const_zero(b):
        return ConstExpr(np.zeros(shape))
    return make_op("matmul", (a, b), shape=shape, lin=mul_type(a.lin, b.lin))


def pow_const(a: Expr, power: float) -> Expr:
    # Base pruning precedes exponent pruning, as in the reference
    # (expression.hpp:1722-1728): pow(0, p) = 0, including pow(0, 0), and
    # pow(1, p) = 1, folded elementwise.
    if isinstance(a, ConstExpr):
        vals = np.asarray(a.value, dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            folded = np.where(
                vals == 0.0,
                0.0,
                np.where(vals == 1.0, 1.0, vals**power),
            )
        return ConstExpr(folded.reshape(a.shape))
    if power == 1:
        return a
    if power == 0:
        return ConstExpr(np.ones(a.shape))
    # Integral exponents stay integers so pow lowers to repeated products,
    # whose higher derivatives stay finite at 0.
    if float(power).is_integer():
        power = int(power)
    return make_op(
        "pow_const", (a,), static=(power,), shape=a.shape, lin=pow_type(a.lin, power)
    )


def pow_expr(a: Expr, b: Expr) -> Expr:
    if isinstance(b, ConstExpr) and b.shape == ():
        return pow_const(a, float(b.value))
    shape = _broadcast_shapes(a.shape, b.shape)
    # A constant all-0/1 base fixes the result whatever the exponent
    # (reference expression.hpp:1722-1728).
    if isinstance(a, ConstExpr):
        vals = np.asarray(a.value, dtype=np.float64)
        if np.all((vals == 0.0) | (vals == 1.0)):
            return ConstExpr(np.broadcast_to(vals, shape).copy())
    return make_op("pow_expr", (a, b), shape=shape, lin=ExpressionType.NONLINEAR)


def unary(op: str, a: Expr) -> Expr:
    return make_op(op, (a,), shape=a.shape, lin=nonlinear_type(a.lin))


def binary_nonlinear(op: str, a: Expr, b: Expr) -> Expr:
    shape = _broadcast_shapes(a.shape, b.shape)
    lin = (
        ExpressionType.CONSTANT
        if (a.lin == ExpressionType.CONSTANT and b.lin == ExpressionType.CONSTANT)
        else ExpressionType.NONLINEAR
    )
    return make_op(op, (a, b), shape=shape, lin=lin)


def transpose(a: Expr) -> Expr:
    if len(a.shape) != 2:
        raise ValueError(f"transpose needs a 2-D expression, got {a.shape}")
    return make_op("transpose", (a,), shape=(a.shape[1], a.shape[0]), lin=a.lin)


def reshape(a: Expr, shape: tuple[int, ...]) -> Expr:
    if a.shape == shape:
        return a
    return make_op("reshape", (a,), static=(shape,), shape=shape, lin=a.lin)


def _normalize_slice(s, n: int) -> tuple:
    start, stop, step = s.indices(n)
    return (start, stop, step)


def getitem(a: Expr, rows, cols, outshape: tuple) -> Expr:
    """Slice rows/cols of a 2-D expression; `outshape` may drop dims to ()."""
    if a.shape == ():
        return reshape(a, outshape)
    rs = _normalize_slice(rows, a.shape[0])
    cs = _normalize_slice(cols, a.shape[1])
    # Slicing a decision-variable leaf yields another leaf
    if isinstance(a, DecVarExpr):
        return DecVarExpr(a.ids[slice(*rs), slice(*cs)].reshape(outshape))
    if isinstance(a, ConstExpr):
        return ConstExpr(a.value[slice(*rs), slice(*cs)].reshape(outshape))
    return make_op(
        "getitem", (a,), static=(rs, cs, outshape), shape=outshape, lin=a.lin
    )


def setblock(base: Expr, value: Expr, rows, cols) -> Expr:
    if len(base.shape) != 2:
        raise ValueError(f"setblock needs a 2-D base, got {base.shape}")
    rs = _normalize_slice(rows, base.shape[0])
    cs = _normalize_slice(cols, base.shape[1])
    nrow = len(range(*rs))
    ncol = len(range(*cs))
    value = reshape(value, (nrow, ncol)) if value.shape != (nrow, ncol) else value
    return make_op(
        "setblock",
        (base, value),
        static=(rs, cs),
        shape=base.shape,
        lin=add_type(base.lin, value.lin),
    )


def _as_2d(e: Expr) -> Expr:
    if e.shape == ():
        return reshape(e, (1, 1))
    return e


def vstack(parts: Sequence[Expr]) -> Expr:
    parts = [_as_2d(p) for p in parts]
    cols = parts[0].shape[1]
    rows = sum(p.shape[0] for p in parts)
    lin = ExpressionType.NONE
    for p in parts:
        lin = add_type(lin, p.lin)
    return make_op("vstack", tuple(parts), shape=(rows, cols), lin=lin)


def hstack(parts: Sequence[Expr]) -> Expr:
    parts = [_as_2d(p) for p in parts]
    rows = parts[0].shape[0]
    cols = sum(p.shape[1] for p in parts)
    lin = ExpressionType.NONE
    for p in parts:
        lin = add_type(lin, p.lin)
    return make_op("hstack", tuple(parts), shape=(rows, cols), lin=lin)


def linear_solve(a: Expr, b: Expr) -> Expr:
    lin = (
        ExpressionType.CONSTANT
        if a.lin == ExpressionType.CONSTANT and b.lin == ExpressionType.CONSTANT
        else ExpressionType.NONLINEAR
    )
    if a.lin == ExpressionType.CONSTANT:
        lin = mul_type(ExpressionType.CONSTANT, b.lin)
    return make_op("solve", (a, b), shape=(a.shape[0], b.shape[1]), lin=lin)


def expm(a: Expr) -> Expr:
    return make_op("expm", (a,), shape=a.shape, lin=nonlinear_type(a.lin))


def sum_all(a: Expr) -> Expr:
    """Sum of all elements as one reduction node."""
    return make_op("sum", (a,), shape=(), lin=a.lin)


def grad_of(of: Expr, wrt: DecVarExpr) -> Expr:
    """Symbolic gradient node d(of)/d(wrt), usable in further costs and
    constraints (reference variable_matrix.hpp:1757). Evaluates through
    `torch.func.grad` of the sub-DAG, so it nests and differentiates."""
    if of.shape != () or not isinstance(wrt, DecVarExpr):
        raise ValueError("grad_of needs a scalar expression and a variable leaf")
    return OpExpr("grad", (of, wrt), (), wrt.shape, ExpressionType.NONLINEAR)


def jac_of(of: Expr, wrt: DecVarExpr) -> Expr:
    """Symbolic Jacobian node: rows are gradients of `of`'s elements."""
    if not isinstance(wrt, DecVarExpr):
        raise ValueError("jac_of needs a variable leaf")
    return OpExpr(
        "jac", (of, wrt), (), (of.size, wrt.ids.size), ExpressionType.NONLINEAR
    )


# ---------------------------------------------------------------------------
# Evaluation and compilation
# ---------------------------------------------------------------------------


def collect_leaf_ids(exprs: Sequence[Expr]) -> np.ndarray:
    """All decision-variable ids in the given DAGs, in first-visit order
    (deduplicated)."""
    seen_nodes: set[int] = set()
    out: list[np.ndarray] = []
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if id(e) in seen_nodes:
            continue
        seen_nodes.add(id(e))
        if isinstance(e, DecVarExpr):
            out.append(e.ids.ravel())
        elif isinstance(e, OpExpr):
            stack.extend(e.args)
    if not out:
        return np.zeros(0, dtype=np.int64)
    flat = np.concatenate(out)
    _, first_idx = np.unique(flat, return_index=True)
    return flat[np.sort(first_idx)]


def evaluate(expr: Expr) -> np.ndarray:
    """Interpret the DAG on the host at the registry's current values
    (Variable.value()); the solver path uses `CompiledEval`."""
    if isinstance(expr, ConstExpr):
        return expr.value
    wrt = collect_leaf_ids([expr])
    compiled = CompiledEval([expr], wrt)
    compiled.prepare(torch.device("cpu"))
    x = torch.as_tensor(_registry.get(wrt))
    (v,) = compiled(x, torch.zeros(0, dtype=torch.float64))
    return v.numpy()


class CompiledEval:
    """A pure torch function of (x, params) evaluating a set of expressions.

    `x` is the flat vector of the `wrt` decision variables; `params` is the
    flat vector of all other decision variables appearing in the DAGs,
    gathered from the registry at call time, so re-solving after
    `set_value` needs no recompilation (reference docs/usage.md).

    `prepare(device)` moves constants and index vectors to a device once;
    it must run outside `torch.func` transforms, because a tensor made
    inside one is wrapped for that transform and must not outlive it.
    """

    def __init__(self, exprs: Sequence[Expr], wrt_ids: np.ndarray) -> None:
        self.exprs = list(exprs)
        self.wrt_ids = np.asarray(wrt_ids, dtype=np.int64).ravel()
        all_ids = collect_leaf_ids(self.exprs)
        wrt_set = set(self.wrt_ids.tolist())
        self.param_ids = np.array(
            [i for i in all_ids.tolist() if i not in wrt_set], dtype=np.int64
        )
        # Map global id -> position in concat([x, params])
        n = self.wrt_ids.shape[0]
        self._pos: dict[int, int] = {int(g): i for i, g in enumerate(self.wrt_ids)}
        for i, g in enumerate(self.param_ids):
            self._pos[int(g)] = n + i
        self._leaf_index: dict[int, tuple] = {}
        self._device_cache: dict[tuple, torch.Tensor] = {}

    def num_params(self) -> int:
        return int(self.param_ids.shape[0])

    def gather_params(self) -> np.ndarray:
        return _registry.get(self.param_ids)

    def on_device(self, key, array: np.ndarray, device: torch.device) -> torch.Tensor:
        """`array` as a tensor on `device`: the one `prepare` made, else a
        tensor made for this call only."""
        cached = self._device_cache.get((key, device))
        if cached is None:
            return torch.as_tensor(array, device=device)
        return cached

    def cache_on(self, key, array: np.ndarray, device: torch.device) -> None:
        self._device_cache[(key, device)] = torch.as_tensor(array, device=device)

    def prepare(self, device: torch.device) -> None:
        """Move every constant and index vector of the DAGs to `device`."""
        seen: set[int] = set()
        stack = list(self.exprs)
        while stack:
            e = stack.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            if isinstance(e, ConstExpr):
                self.cache_on(id(e), e.value, device)
            elif isinstance(e, DecVarExpr):
                plan = self._leaf_gather(e)
                if plan[0] == "gather":
                    self.cache_on(id(e), plan[1], device)
            else:
                if e.op in ("grad", "jac"):
                    self.cache_on(("wrt", id(e)), self._wrt_positions(e), device)
                stack.extend(e.args)

    def _wrt_positions(self, e: OpExpr) -> np.ndarray:
        return np.array([self._pos[int(g)] for g in e.args[1].ids.ravel()], np.int64)

    def _leaf_gather(self, e: DecVarExpr) -> tuple:
        """Index plan for a leaf: ('slice', start, size, shape) when its
        positions are contiguous ascending (the common case), else
        ('gather', idx)."""
        key = id(e)
        plan = self._leaf_index.get(key)
        if plan is None:
            if e.ids.size:
                idx = np.vectorize(self._pos.__getitem__, otypes=[np.int64])(e.ids)
            else:
                idx = np.zeros(e.ids.shape, dtype=np.int64)
            flat = idx.ravel()
            if flat.size and np.array_equal(
                flat, np.arange(flat[0], flat[0] + flat.size)
            ):
                plan = ("slice", int(flat[0]), int(flat.size), idx.shape)
            else:
                plan = ("gather", idx)
            self._leaf_index[key] = plan
        return plan

    def combine(self, x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.reshape(-1), params.reshape(-1).to(x.dtype)])

    def __call__(self, x: torch.Tensor, params: torch.Tensor) -> tuple:
        """Evaluate all expressions; composes with `torch.func` transforms."""
        combined = self.combine(x, params)
        cache: dict[int, torch.Tensor] = {}
        return tuple(self.eval_expr(e, combined, cache) for e in self.exprs)

    def leaf_value(self, e: Expr, combined: torch.Tensor) -> torch.Tensor:
        if isinstance(e, ConstExpr):
            return self.on_device(id(e), e.value, combined.device)
        plan = self._leaf_gather(e)
        if plan[0] == "slice":
            _, start, size, shape = plan
            return combined[start : start + size].reshape(shape)
        return combined[self.on_device(id(e), plan[1], combined.device)]

    def eval_expr(self, e: Expr, combined: torch.Tensor, cache: dict | None = None):
        """Evaluate one expression against a combined [x, params] vector."""
        if cache is None:
            cache = {}

        def rec(e: Expr):
            key = id(e)
            if key in cache:
                return cache[key]
            if isinstance(e, (ConstExpr, DecVarExpr)):
                v = self.leaf_value(e, combined)
            elif e.op in ("grad", "jac"):
                v = self._symbolic_derivative(e, combined)
            else:
                v = _EVAL[e.op](e.static, *[rec(a) for a in e.args])
            cache[key] = v
            return v

        return rec(e)

    def _symbolic_derivative(self, e: OpExpr, combined: torch.Tensor):
        """Evaluate a grad/jac node: differentiate the sub-DAG with respect
        to the referenced variables (every leaf sharing those ids sees the
        varied values), nesting and further differentiation included."""
        of = e.args[0]
        pos = self.on_device(("wrt", id(e)), self._wrt_positions(e), combined.device)

        def inner(wvals):
            varied = torch.index_put(combined, (pos,), wvals)
            out = self.eval_expr(of, varied, {})
            return out.reshape(-1) if e.op == "jac" else out.reshape(())

        cur = combined[pos]
        if e.op == "grad":
            return torch.func.grad(inner)(cur).reshape(e.shape)
        return torch.func.jacfwd(inner)(cur).reshape(e.shape)


# ---------------------------------------------------------------------------
# Structural analysis: per-element stage classification
# ---------------------------------------------------------------------------

_ELEMENTWISE_OPS = {
    "add", "sub", "mul", "div", "neg", "pow_const", "pow_expr",
    "abs", "acos", "asin", "atan", "atan2", "cbrt", "cos", "cosh", "erf",
    "exp", "hypot", "log", "log10", "maximum", "minimum", "sign", "sin",
    "sinh", "sqrt", "tan", "tanh",
}

_STRUCTURAL_OPS_ANALYSIS = {
    "getitem", "setblock", "vstack", "hstack", "transpose", "reshape",
}


def element_stages(expr: Expr, stage_of_id: dict) -> np.ndarray:
    """Classify each element of an expression by the OCP stage of the
    variables it references.

    Returns an array shaped like the expression: the stage index if every
    referenced decision variable in that element belongs to one stage, -1
    if the element references no staged variable (constants/parameters),
    -2 if it mixes stages or passes through a non-elementwise op. The
    banded KKT backend assigns constraint rows to stages with it.
    """

    def combine(a, b):
        a, b = np.broadcast_arrays(a, b)
        return np.where(a == -1, b, np.where((b == -1) | (a == b), a, -2))

    def rec(e: Expr) -> np.ndarray:
        if isinstance(e, ConstExpr):
            return np.full(e.shape, -1, dtype=np.int64)
        if isinstance(e, DecVarExpr):
            look = np.vectorize(lambda i: stage_of_id.get(int(i), -1), otypes=[np.int64])
            return look(e.ids) if e.ids.size else np.full(e.shape, -1, np.int64)
        if e.op in _STRUCTURAL_OPS_ANALYSIS:
            return _eval_host(e.op, e.static, [rec(a) for a in e.args])
        if e.op in _ELEMENTWISE_OPS:
            out = np.full((), -1, dtype=np.int64)
            for a in e.args:
                out = combine(out, rec(a))
            return np.broadcast_to(out, e.shape).copy()
        return np.full(e.shape, -2, dtype=np.int64)

    return rec(expr)
