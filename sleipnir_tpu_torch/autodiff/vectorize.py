"""Auto-vectorization of isomorphic expression blocks.

Port of `sleipnir_tpu/autodiff/vectorize.py`. Problems built in Python
loops add one block or cost term per timestep, all of one structure with
different variables and constants (reference
python/test/optimization/flywheel_problem_test.py:29-41). `BlockCompiler`
groups constraint blocks and flattened cost-sum terms by structural
signature and evaluates each group with one `torch.func.vmap` over stacked
leaf data, so a compiled function launches O(unique structures) kernels
instead of O(N·nodes).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sleipnir_tpu_torch.autodiff import expression as ex
from sleipnir_tpu_torch.autodiff.expression import (
    CompiledEval,
    ConstExpr,
    DecVarExpr,
    Expr,
    OpExpr,
)

#: Minimum isomorphic blocks worth batching.
MIN_GROUP = 4


class SigInterner:
    """Interns structural signatures to small integers so DAGs with heavy
    sharing hash in O(nodes), not O(expanded tree)."""

    def __init__(self) -> None:
        self._table: dict = {}
        self.special: set[int] = set()

    def intern(self, key, special: bool) -> int:
        sid = self._table.get(key)
        if sid is None:
            sid = len(self._table)
            self._table[key] = sid
            if special:
                self.special.add(sid)
        return sid


def _signature(e: Expr, memo: dict, interner: SigInterner) -> int:
    key = id(e)
    sig = memo.get(key)
    if sig is None:
        if isinstance(e, ConstExpr):
            sig = interner.intern(("c", e.shape), False)
        elif isinstance(e, DecVarExpr):
            sig = interner.intern(("v", e.shape), False)
        elif e.op in ("grad", "jac"):
            sig = interner.intern(("special", id(e)), True)
        else:
            child_sigs = tuple(_signature(a, memo, interner) for a in e.args)
            special = any(c in interner.special for c in child_sigs)
            sig = interner.intern(
                (e.op, _hashable(e.static), e.shape, child_sigs), special
            )
        memo[key] = sig
    return sig


def _hashable(static):
    def conv(v):
        if isinstance(v, np.ndarray):
            return ("nd", v.shape, tuple(v.ravel().tolist()))
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v

    return conv(static)


def _collect_leaves(e: Expr, seen: set, out: list) -> None:
    """Deterministic DFS leaf collection (first-visit order); isomorphic
    blocks yield aligned slots."""
    key = id(e)
    if key in seen:
        return
    seen.add(key)
    if isinstance(e, (ConstExpr, DecVarExpr)):
        out.append(e)
        return
    for a in e.args:
        _collect_leaves(a, seen, out)


def flatten_add_chain(e: Expr, out: list, sign: float = 1.0) -> None:
    """Flatten nested scalar adds/subs into a signed term list."""
    if isinstance(e, OpExpr) and e.shape == ():
        if e.op == "add":
            flatten_add_chain(e.args[0], out, sign)
            flatten_add_chain(e.args[1], out, sign)
            return
        if e.op == "sub":
            flatten_add_chain(e.args[0], out, sign)
            flatten_add_chain(e.args[1], out, -sign)
            return
        if e.op == "neg":
            flatten_add_chain(e.args[0], out, -sign)
            return
    out.append((sign, e))


class _Group:
    """A batch of isomorphic expressions evaluated with one vmap."""

    __slots__ = ("indices", "template", "leaves", "var_idx", "const_vals")

    def __init__(self, indices, template, leaves, var_idx, const_vals):
        self.indices = indices
        self.template = template
        self.leaves = leaves  # template leaves, one per slot
        self.var_idx = var_idx  # {slot: (k, *shape) position array}
        self.const_vals = const_vals  # {slot: (k, *shape) value array}

    def evaluate(self, compiled: CompiledEval, combined: torch.Tensor):
        """Returns the stacked (k, *shape) result."""
        args = []
        for slot in range(len(self.leaves)):
            if slot in self.var_idx:
                idx = compiled.on_device((id(self), slot), self.var_idx[slot], combined)
                args.append(combined[idx])
            else:
                args.append(
                    compiled.on_device((id(self), slot), self.const_vals[slot], combined)
                )
        leaves = self.leaves

        def block_eval(*leaf_vals):
            cache = {id(leaf): leaf_vals[s] for s, leaf in enumerate(leaves)}

            def rec(e: Expr):
                key = id(e)
                if key not in cache:
                    cache[key] = ex._EVAL[e.op](e.static, *[rec(a) for a in e.args])
                return cache[key]

            return rec(self.template)

        return torch.func.vmap(block_eval)(*args)


def _try_group(blocks: Sequence[Expr], indices: list, pos_of_id: dict):
    """Build a _Group from isomorphic blocks, or None."""
    leaf_lists = []
    for i in indices:
        leaves: list = []
        _collect_leaves(blocks[i], set(), leaves)
        leaf_lists.append(leaves)
        if len(leaves) != len(leaf_lists[0]):
            return None
    var_idx = {}
    const_vals = {}
    k = len(indices)
    for slot, leaf0 in enumerate(leaf_lists[0]):
        if isinstance(leaf0, DecVarExpr):
            var_idx[slot] = np.stack(
                [
                    np.vectorize(pos_of_id.__getitem__, otypes=[np.int64])(
                        leaf_lists[j][slot].ids
                    )
                    if leaf_lists[j][slot].ids.size
                    else np.zeros(leaf0.ids.shape, np.int64)
                    for j in range(k)
                ]
            )
        else:
            const_vals[slot] = np.stack([leaf_lists[j][slot].value for j in range(k)])
    return _Group(indices, blocks[indices[0]], leaf_lists[0], var_idx, const_vals)


class BlockCompiler:
    """Compiles (cost, equality blocks, inequality blocks) into torch
    functions of (x, params) with isomorphic structures batched.

    Functional blocks (entries with an `fn` of the flat x) pass through
    untouched. Returned constraint vectors keep the declaration row order
    (reference make_constraints row-major flattening).
    """

    def __init__(self, cost_expr, eq_entries, ineq_entries, wrt_ids) -> None:
        self.eq_entries = list(eq_entries)
        self.ineq_entries = list(ineq_entries)

        all_exprs = [cost_expr]
        for entry in self.eq_entries + self.ineq_entries:
            if isinstance(entry, Expr):
                all_exprs.append(entry)
        self.compiled = CompiledEval(all_exprs, wrt_ids)
        pos = self.compiled._pos
        interner = SigInterner()
        sig_memo: dict = {}

        # -- cost: flatten the Σ-chain and group isomorphic terms ----------
        terms: list = []
        flatten_add_chain(cost_expr, terms)
        self._cost_singles: list = []  # (sign, expr)
        self._cost_groups: list = []  # (signs (k,), _Group)
        by_sig: dict = {}
        for sign, term in terms:
            sig = _signature(term, sig_memo, interner)
            by_sig.setdefault(sig, []).append((sign, term))
        for sig, items in by_sig.items():
            if len(items) < MIN_GROUP or sig in interner.special:
                self._cost_singles.extend(items)
                continue
            exprs = [t for _s, t in items]
            grp = _try_group(exprs, list(range(len(exprs))), pos)
            if grp is None:
                self._cost_singles.extend(items)
            else:
                signs = np.array([s for s, _t in items])
                self._cost_groups.append((signs, grp))

        # -- constraints ---------------------------------------------------
        self._eq = self._plan_blocks(self.eq_entries, pos, interner, sig_memo)
        self._ineq = self._plan_blocks(self.ineq_entries, pos, interner, sig_memo)

    # -- planning ----------------------------------------------------------

    def _plan_blocks(self, entries, pos, interner, sig_memo):
        """Returns (parts, perm, total_rows): parts are ('fn', block) /
        ('single', expr) / ('group', _Group); perm reorders the
        concatenated part outputs back to declaration order."""
        rows_of = []
        offset = 0
        offsets = []
        for entry in entries:
            r = entry.size if isinstance(entry, Expr) else entry.rows
            offsets.append(offset)
            rows_of.append(r)
            offset += r
        total = offset

        by_sig: dict = {}
        for i, entry in enumerate(entries):
            if isinstance(entry, Expr):
                sig = _signature(entry, sig_memo, interner)
                if sig in interner.special:
                    sig = ("special", i)
            else:
                sig = ("fn", i)
            by_sig.setdefault(sig, []).append(i)

        parts = []
        order = []  # original row indices in part-output order
        for idxs in by_sig.values():
            grouped = None
            if len(idxs) >= MIN_GROUP and isinstance(entries[idxs[0]], Expr):
                grouped = _try_group(
                    [entries[i] for i in idxs], list(range(len(idxs))), pos
                )
                if grouped is not None:
                    grouped.indices = idxs
            if grouped is not None:
                parts.append(("group", grouped))
                for i in idxs:
                    order.extend(range(offsets[i], offsets[i] + rows_of[i]))
            else:
                for i in idxs:
                    entry = entries[i]
                    parts.append(("single" if isinstance(entry, Expr) else "fn", entry))
                    order.extend(range(offsets[i], offsets[i] + rows_of[i]))

        # perm[j] = position in part-output order of original row j
        order = np.asarray(order, dtype=np.int64)
        perm = np.zeros(total, dtype=np.int64)
        perm[order] = np.arange(total)
        return parts, perm, total

    # -- evaluation --------------------------------------------------------

    def prepare(self, device: torch.device, dtype: torch.dtype = torch.float64) -> None:
        """Move every constant and index vector to `device`, the constants
        in `dtype`; call outside `torch.func` transforms (see
        `CompiledEval.prepare`)."""
        self.compiled.prepare(device, dtype)
        groups = [g for _s, g in self._cost_groups]
        for plan in (self._eq, self._ineq):
            groups += [g for kind, g in plan[0] if kind == "group"]
            self.compiled.cache_on(id(plan[1]), plan[1], device)
        for grp in groups:
            for slot, arr in {**grp.var_idx, **grp.const_vals}.items():
                self.compiled.cache_on((id(grp), slot), arr, device, dtype)
        for signs, _g in self._cost_groups:
            self.compiled.cache_on(id(signs), signs, device, dtype)

    def num_params(self) -> int:
        return self.compiled.num_params()

    def gather_params(self) -> np.ndarray:
        return self.compiled.gather_params()

    def f(self, x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        combined = self.compiled.combine(x, params)
        total = torch.zeros((), dtype=combined.dtype, device=combined.device)
        cache: dict = {}
        for sign, term in self._cost_singles:
            v = self.compiled.eval_expr(term, combined, cache)
            total = total + sign * v.reshape(())
        for signs, grp in self._cost_groups:
            stacked = grp.evaluate(self.compiled, combined)
            sg = self.compiled.on_device(id(signs), signs, combined)
            total = total + torch.sum(sg * stacked.reshape(len(signs)))
        # A float64 value a problem function makes must not promote a
        # float32 evaluation (a no-op in float64).
        return total.to(combined.dtype)

    def _constraints(self, plan, x: torch.Tensor, params: torch.Tensor):
        parts, perm, total = plan
        if total == 0:
            return x.new_zeros((0,))
        combined = self.compiled.combine(x, params)
        outs = []
        cache: dict = {}
        for kind, payload in parts:
            if kind == "fn":
                outs.append(payload.fn(x).reshape(-1))
            elif kind == "single":
                outs.append(self.compiled.eval_expr(payload, combined, cache).reshape(-1))
            else:
                outs.append(payload.evaluate(self.compiled, combined).reshape(-1))
        flat = torch.cat(outs).to(combined.dtype)
        return flat[self.compiled.on_device(id(perm), perm, combined)]

    def c_e(self, x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        return self._constraints(self._eq, x, params)

    def c_i(self, x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        return self._constraints(self._ineq, x, params)
