"""Block-tridiagonal (banded) KKT backend for direct-transcription OCPs.

Port of `sleipnir_tpu/optimization/solver/kkt_banded.py` without the
device mesh and the TPU-only factorization variants.

Variables are ordered by stage zₖ = (xₖ, uₖ); equality rows are assigned
to the stage they are anchored at, padded to a uniform count per stage
(padded rows carry a fixed −1 pivot so the expected inertia stays exact).
The reduced KKT matrix is then block tridiagonal with (w × w) blocks,
w = m + p, and factors in O(N·w³) with the Hopper kernels of
`ops/cuda_banded.py` (their plain twin on CPU tensors).

Derivatives are never materialized densely. Banded blocks are extracted
with *colored* probes, all vmapped with `torch.func.vmap` on every device:
  - Aₑ: 2·m JVPs of cₑ (adjacent stages alias-free under mod-2 coloring),
  - Lagrangian Hessian: 3·m HVPs (mod-3 coloring separates k−1/k/k+1),
  - Aᵢ: m JVPs (each inequality row touches a single stage).

Border (arrowhead) variables, such as the shared timestep of a
minimum-time OCP, couple to every stage. They take one exact probe each,
batched with the colored probes, and enter the factorization through a
Schur complement on the border: the banded factor solves T⁻¹·col for
all border columns of all ladder candidates in one K2 launch, so the
system still factors in O(N·w³).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.ops.block_tridiag import (
    BlockTridiagFactor,
    block_tridiag_inertia,
)
from sleipnir_tpu_torch.ops.ldlt import ldlt_unblocked
from sleipnir_tpu_torch.optimization.solver.kkt_backend import (
    RegLoopResult,
    regularization_loop,
)
from sleipnir_tpu_torch.optimization.solver.util.host_sync import HostSyncs

_F64 = torch.float64
_EPS = float(torch.finfo(_F64).eps)

#: Pivot zero-threshold for inertia on the EQUILIBRATED system, whose
#: legitimate pivots are O(1): anything below eps^0.75 (~1e-12) counts as
#: zero and drives the δ/γ escalation (JAX package kkt_banded.py:739-743).
EPS_INERTIA = _EPS**0.75

#: The reference's small-pivot gate (sparse_regularized_ldlt.hpp:82-83):
#: an unregularized factorization with |pivot| below it counts as failed.
SMALL_PIVOT = 1e-4


def _equilibrate(D: torch.Tensor, E: torch.Tensor, rounds: int = 2):
    """Symmetric Ruiz equilibration of a batch of block-tridiagonal
    matrices, D (B, K, w, w) and E (B, K-1, w, w).

    Returns (D', E', s) with M' = S M S, S = blockdiag(diag(s_k)), s
    (B, K, w). The scaling is a congruence, so the inertia is exactly
    preserved (Sylvester), while row and column magnitudes are compressed
    to O(1): mid-solve KKT systems mix Hessian rows of ~1e9 with Schur
    pivots of ~1e-7, and unscaled the small pivots' signs would be noise
    to the inertia count and the small-pivot gate.
    """
    s = torch.ones(D.shape[:-1], dtype=D.dtype, device=D.device)
    coupled = E.shape[1] > 0
    for _ in range(rounds):
        rn = torch.amax(torch.abs(D), dim=-1)  # (B, K, w)
        if coupled:
            # block row k+1 contains E_k; block row k contains E_kᵀ
            rn[:, 1:] = torch.maximum(rn[:, 1:], torch.amax(torch.abs(E), dim=-1))
            rn[:, :-1] = torch.maximum(rn[:, :-1], torch.amax(torch.abs(E), dim=-2))
        f = torch.where(rn > 0.0, 1.0 / torch.sqrt(rn), 1.0)
        D = D * f[..., :, None] * f[..., None, :]
        if coupled:
            E = E * f[:, 1:, :, None] * f[:, :-1, None, :]
        s = s * f
    return D, E, s


_EMPTY_BORDER = np.zeros(0, dtype=np.int64)


class StageStructure(NamedTuple):
    """Static stage metadata (host-side numpy)."""

    num_stages: int  # K
    stage_width: int  # m variables per stage
    var_perm: np.ndarray  # (K·m,) staged order -> flat index
    ce_stage: np.ndarray  # (me,) stage of each equality row
    ce_slot: np.ndarray  # (me,) slot within the stage's padded block
    eq_pad: int  # p: max equality rows per stage
    ci_stage: np.ndarray  # (mi,)
    ci_slot: np.ndarray  # (mi,)
    ineq_pad: int  # q: max inequality rows per stage
    #: Flat indices of BORDER decision variables: columns that couple to
    #: every stage (the shared dt of a TimestepMethod.VARIABLE_SINGLE
    #: minimum-time OCP, reference ocp.hpp:129-134). Inequality rows that
    #: touch only border variables sit in any stage's slot with an
    #: all-zero staged row; their entries live in the border columns.
    border: np.ndarray = _EMPTY_BORDER


class BandedDerivs(NamedTuple):
    """Per-stage scaled derivative blocks and the dense border columns."""

    Hd: torch.Tensor  # (K, m, m) stage-diagonal Lagrangian Hessian
    Hc: torch.Tensor  # (K-1, m, m) coupling H[k+1, k]
    Aloc: torch.Tensor  # (K, p, m) eq rows of stage k wrt z_k
    Anext: torch.Tensor  # (K, p, m) eq rows of stage k wrt z_{k+1} (last 0)
    Ailoc: torch.Tensor  # (K, q, m) ineq rows of stage k wrt z_k
    Hb: torch.Tensor  # (nb, K, m) Hessian border columns against staged vars
    Hbb: torch.Tensor  # (nb, nb) border-border Hessian block
    Aeb: torch.Tensor  # (me, nb) eq-row border entries
    Aib: torch.Tensor  # (mi, nb) ineq-row border entries


class BandedFactor(NamedTuple):
    fac: BlockTridiagFactor  # factor of S M S, batch axis of size 1
    #: Ruiz scale (K, w): solves are x = S · solve(fac, S · b).
    s: torch.Tensor
    #: The border: assembled border columns in staged layout (nb, K, w),
    #: T⁻¹·col (nb, K, w), the δ-free border block e₀ (nb, nb) and the
    #: LDLᵀ (L, d) of the border Schur complement e₀ + δI − colᵀT⁻¹col.
    col: torch.Tensor
    Xcols: torch.Tensor
    e0: torch.Tensor
    Sb_L: torch.Tensor
    Sb_d: torch.Tensor
    delta: torch.Tensor
    gamma: torch.Tensor
    ok: bool


class BandedBackend:
    """KKT backend exploiting OCP stage structure."""

    def __init__(
        self,
        structure: StageStructure,
        f_raw: Callable,  # f(x, params) -> scalar (unscaled)
        ce_raw: Callable,  # c_e(x, params) -> (me,)
        ci_raw: Callable,  # c_i(x, params) -> (mi,)
        n: int,
        me: int,
        mi: int,
        device: torch.device,
        syncs: HostSyncs,
    ) -> None:
        st = structure
        self.structure = st
        self.n, self.me, self.mi = n, me, mi
        self.device = device
        self.syncs = syncs
        self.f_raw, self.ce_raw, self.ci_raw = f_raw, ce_raw, ci_raw

        K, m, p, q = st.num_stages, st.stage_width, st.eq_pad, st.ineq_pad
        border = np.asarray(st.border, dtype=np.int64).reshape(-1)
        nb = border.shape[0]
        if n != K * m + nb:
            raise ValueError(f"n = {n} is not K·m + nb = {K}·{m} + {nb}")
        self.K, self.m, self.p, self.q, self.nb = K, m, p, q, nb
        self.w = m + p

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        # Colored probe matrices (static), each batch followed by one
        # exact probe per border variable: the probes of a kind run as one
        # vmapped call.
        staged = st.var_perm.reshape(K, m)
        probes_b = np.zeros((nb, n))
        probes_b[np.arange(nb), border] = 1.0
        probes_e = np.zeros((2 * m, n))
        for c in range(2):
            for j in range(m):
                probes_e[c * m + j, staged[np.arange(K) % 2 == c, j]] = 1.0
        probes_h = np.zeros((3 * m, n))
        for c in range(3):
            for j in range(m):
                probes_h[c * m + j, staged[np.arange(K) % 3 == c, j]] = 1.0
        probes_i = np.zeros((m, n))
        for j in range(m):
            probes_i[j, staged[:, j]] = 1.0
        self._probes_e = dev(np.concatenate([probes_e, probes_b]), _F64)
        self._probes_h = dev(np.concatenate([probes_h, probes_b]), _F64)
        self._probes_i = dev(np.concatenate([probes_i, probes_b]), _F64)

        # Gather/scatter indices
        self._border_pos = dev(border)
        self._nb_idx = dev(np.arange(nb))
        self._var_perm = dev(st.var_perm)
        self._kmod3 = dev(np.arange(K) % 3)
        self._k_idx = dev(np.arange(K))
        self._ce_stage = dev(st.ce_stage)
        self._ce_slot = dev(st.ce_slot)
        self._ci_stage = dev(st.ci_stage)
        self._ci_slot = dev(st.ci_slot)
        j_idx = np.arange(m)[None, :]
        ce_stage = np.asarray(st.ce_stage)
        self._ce_loc_probe = dev((ce_stage % 2)[:, None] * m + j_idx)
        self._ce_next_probe = dev(((ce_stage + 1) % 2)[:, None] * m + j_idx)
        self._ce_row = dev(np.arange(me)[:, None])
        # Real (non-pad) equality slots per stage
        eq_count = np.bincount(ce_stage, minlength=K) if me else np.zeros(K, np.int64)
        self._eq_slot_real = dev(np.arange(p)[None, :] < eq_count[:, None], torch.bool)
        self._eye_m = torch.eye(m, dtype=_F64, device=device)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=_F64, device=self.device)

    # -- helpers -----------------------------------------------------------

    def _stage_vec(self, v: torch.Tensor) -> torch.Tensor:
        """Flat (n,) -> staged (K, m)."""
        return v[self._var_perm].reshape(self.K, self.m)

    def _unstage_vec(self, staged: torch.Tensor) -> torch.Tensor:
        """Staged (K, m) -> flat (n,)."""
        return self._zeros(self.n).index_put((self._var_perm,), staged.reshape(-1))

    def _stage_eq(self, v: torch.Tensor) -> torch.Tensor:
        """(me,) -> (K, p) padded per-stage layout."""
        return self._zeros(self.K, self.p).index_put((self._ce_stage, self._ce_slot), v)

    def _stage_ineq(self, v: torch.Tensor) -> torch.Tensor:
        return self._zeros(self.K, self.q).index_put((self._ci_stage, self._ci_slot), v)

    def _eq_rows(self, Ue: torch.Tensor):
        """Colored equality JVPs (2m, me) -> row entries wrt the anchor
        stage and the next stage, each (me, m)."""
        return Ue[self._ce_loc_probe, self._ce_row], Ue[self._ce_next_probe, self._ce_row]

    # -- derivative evaluation --------------------------------------------

    def eval_derivs(self, F, x, y, z) -> BandedDerivs:
        params, sc = F.params, F.scaling
        K, m, p, q = self.K, self.m, self.p, self.q

        # Scaled Lagrangian (constraint rows row-scaled like the reference's
        # callbacks, problem.hpp:618-660)
        def lag(xv):
            out = sc.f * self.f_raw(xv, params)
            if self.me > 0:
                out = out - (sc.c_e * y) @ self.ce_raw(xv, params)
            if self.mi > 0:
                out = out - (sc.c_i * z) @ self.ci_raw(xv, params)
            return out

        grad_lag = grad(lag)
        nb = self.nb
        Hv_all = vmap(lambda v: jvp(grad_lag, (x,), (v,))[1])(self._probes_h)
        Hv, Hvb = Hv_all[: 3 * m], Hv_all[3 * m :]  # (3m, n), (nb, n)
        HvS = Hv[:, self._var_perm].reshape(3, m, K, m)
        # Hd[k][i, j] = HvS[k%3, j, k, i]
        Hd = HvS[self._kmod3, :, self._k_idx, :].transpose(1, 2)
        # Hc[k][i, j] = H[(k+1, i), (k, j)] = HvS[k%3, j, k+1, i]
        if K > 1:
            Hc = HvS[self._kmod3[:-1], :, self._k_idx[:-1] + 1, :].transpose(1, 2)
        else:
            Hc = self._zeros(0, m, m)
        Hb = Hvb[:, self._var_perm].reshape(nb, K, m)
        Hbb = Hvb[:, self._border_pos]

        if self.me > 0:
            Ue_all = vmap(
                lambda v: jvp(lambda xv: sc.c_e * self.ce_raw(xv, params), (x,), (v,))[1]
            )(self._probes_e)
            rows_loc, rows_next = self._eq_rows(Ue_all[: 2 * m])
            idx = (self._ce_stage, self._ce_slot)
            Aloc = self._zeros(K, p, m).index_put(idx, rows_loc)
            Anext = self._zeros(K, p, m).index_put(idx, rows_next)
            Aeb = Ue_all[2 * m :].T
        else:
            Aloc = self._zeros(K, p, m)
            Anext = self._zeros(K, p, m)
            Aeb = self._zeros(0, nb)

        if self.mi > 0:
            Ui_all = vmap(
                lambda v: jvp(lambda xv: sc.c_i * self.ci_raw(xv, params), (x,), (v,))[1]
            )(self._probes_i)
            Ailoc = self._zeros(K, q, m).index_put(
                (self._ci_stage, self._ci_slot), Ui_all[:m].T
            )
            Aib = Ui_all[m:].T
        else:
            Ailoc = self._zeros(K, q, m)
            Aib = self._zeros(0, nb)

        return BandedDerivs(
            Hd=Hd, Hc=Hc, Aloc=Aloc, Anext=Anext, Ailoc=Ailoc,
            Hb=Hb, Hbb=Hbb, Aeb=Aeb, Aib=Aib,
        )

    def setup_rows(self, x0: np.ndarray, params: np.ndarray):
        """Per-row Jacobian data at x0 for setup (scaling and bound
        detection), via the colored JVP probes: O(N·w) memory, never a
        dense (m, n) matrix (reference problem_scaling.hpp:58-110).

        Runs on the solve device. Returns numpy arrays (unscaled):
          ce_rows_loc (me, m + nb), ce_rows_next (me, m): equality row
            entries wrt the anchor stage's variables (then the border's)
            and the next stage's;
          ci_rows (mi, m + nb): inequality row entries wrt the row's stage
            and the border;
          ci_cols (mi, m + nb): global column index of each ci_rows entry.
        """
        x = torch.as_tensor(x0, dtype=_F64, device=self.device)
        prm = torch.as_tensor(params, dtype=_F64, device=self.device)
        m, nb = self.m, self.nb
        if self.me > 0:
            Ue = vmap(lambda v: jvp(lambda xv: self.ce_raw(xv, prm), (x,), (v,))[1])(
                self._probes_e
            )
            ce_rows_loc, ce_rows_next = (a.cpu().numpy() for a in self._eq_rows(Ue[: 2 * m]))
            # The border entries join the row so that its ∞-norm (scaling)
            # sees the whole row.
            ce_rows_loc = np.concatenate([ce_rows_loc, Ue[2 * m :].T.cpu().numpy()], axis=1)
        else:
            ce_rows_loc = np.zeros((0, m))
            ce_rows_next = np.zeros((0, m))
        if self.mi > 0:
            Ui = vmap(lambda v: jvp(lambda xv: self.ci_raw(xv, prm), (x,), (v,))[1])(
                self._probes_i
            )
            ci_rows = Ui.T.cpu().numpy()
            staged_cols = np.asarray(self.structure.var_perm).reshape(self.K, m)
            ci_cols = np.concatenate([
                staged_cols[np.asarray(self.structure.ci_stage)],
                np.broadcast_to(np.asarray(self.structure.border, np.int64), (self.mi, nb)),
            ], axis=1)
        else:
            ci_rows = np.zeros((0, m))
            ci_cols = np.zeros((0, m), dtype=np.int64)
        return ce_rows_loc, ce_rows_next, ci_rows, ci_cols

    def all_finite(self, d: BandedDerivs) -> torch.Tensor:
        return torch.stack([torch.isfinite(a).all() for a in d]).all()

    # -- matvecs -----------------------------------------------------------

    def AeT(self, d: BandedDerivs, v: torch.Tensor) -> torch.Tensor:
        if self.me == 0:
            return self._zeros(self.n)
        vs = self._stage_eq(v)  # (K, p)
        out = torch.einsum("kpm,kp->km", d.Aloc, vs)
        out[1:] += torch.einsum("kpm,kp->km", d.Anext, vs)[:-1]
        res = self._unstage_vec(out)
        if self.nb > 0:
            res = res.index_add(0, self._border_pos, d.Aeb.T @ v)
        return res

    def Ae(self, d: BandedDerivs, u: torch.Tensor) -> torch.Tensor:
        us = self._stage_vec(u)  # (K, m)
        u_next = torch.cat([us[1:], self._zeros(1, self.m)], dim=0)
        r = torch.einsum("kpm,km->kp", d.Aloc, us) + torch.einsum(
            "kpm,km->kp", d.Anext, u_next
        )
        out = r[self._ce_stage, self._ce_slot]
        if self.nb > 0:
            out = out + d.Aeb @ u[self._border_pos]
        return out

    def AiT(self, d: BandedDerivs, v: torch.Tensor) -> torch.Tensor:
        if self.mi == 0:
            return self._zeros(self.n)
        vs = self._stage_ineq(v)
        res = self._unstage_vec(torch.einsum("kqm,kq->km", d.Ailoc, vs))
        if self.nb > 0:
            res = res.index_add(0, self._border_pos, d.Aib.T @ v)
        return res

    def Ai(self, d: BandedDerivs, u: torch.Tensor) -> torch.Tensor:
        us = self._stage_vec(u)
        r = torch.einsum("kqm,km->kq", d.Ailoc, us)
        out = r[self._ci_stage, self._ci_slot]
        if self.nb > 0:
            out = out + d.Aib @ u[self._border_pos]
        return out

    # -- factorization -----------------------------------------------------

    def assemble_staged(self, d: BandedDerivs, sigma, deltas, gammas):
        """Assemble the staged KKT blocks for a batch of regularizations
        (deltas, gammas, each (B,)): D (B, K, w, w) and E (K-1, w, w), the
        matrices the factorization works on. Built from whole blocks, with
        no writes into a fresh tensor, so it also runs under `vmap` over
        lanes of derivatives."""
        K, m, p = self.K, self.m, self.p
        B = deltas.shape[0]
        if self.mi > 0:
            sig_st = self._stage_ineq(sigma)
            top_left = d.Hd + torch.einsum("kqm,kq,kqn->kmn", d.Ailoc, sig_st, d.Ailoc)
        else:
            top_left = d.Hd
        top = torch.cat([
            top_left + deltas[:, None, None, None] * self._eye_m,
            d.Aloc.transpose(1, 2).expand(B, K, m, p),
        ], dim=-1)
        # Real equality slots get −γ; padded slots a fixed −1 pivot
        pad = torch.diag_embed(torch.where(self._eq_slot_real, -gammas[:, None, None], -1.0))
        D = torch.cat([top, torch.cat([d.Aloc.expand(B, K, p, m), pad], dim=-1)], dim=-2)
        if K > 1:
            E = torch.cat([
                torch.cat([d.Hc, d.Anext[:-1].transpose(1, 2)], dim=-1),
                self._zeros(K - 1, p, self.w),
            ], dim=-2)
        else:
            E = self._zeros(0, self.w, self.w)
        return D, E

    def factor(self, d: BandedDerivs, sigma, prev_delta, gamma_min) -> BandedFactor:
        col0, e0 = self._assemble_border(d, sigma)

        def factor_with(deltas, gammas):
            D, E = self.assemble_staged(d, sigma, deltas, gammas)
            return self.factor_candidates(
                D, E.expand(deltas.shape[0], *E.shape), deltas, gammas,
                lambda fac, s_eq: self._border_schur(d, sigma, fac, s_eq, col0, e0, deltas, gammas),
            )

        out: RegLoopResult = regularization_loop(
            factor_with, self.n, self.K * self.p, prev_delta, gamma_min, self.syncs
        )
        fac, s_eq, X, Lb, db = out.fac
        return BandedFactor(
            fac=fac, s=s_eq[0], col=col0, Xcols=X[0], e0=e0, Sb_L=Lb[0], Sb_d=db[0],
            delta=out.delta, gamma=out.gamma, ok=out.ok,
        )

    def factor_candidates(self, D, E, deltas, gammas, border_schur):
        """Equilibrate and factor B assembled candidates, D (B, K, w, w)
        and E (B, K-1, w, w), in one K1 launch, and count each one's
        inertia. `border_schur(fac, s_eq)` gives the border's (X, L, d)
        when the problem has one. Returns ((fac, s_eq, X, Lb, db), pos,
        neg, zero, failed), each with the leading axis B."""
        nb = self.nb
        B = deltas.shape[0]
        Ds, Es, s_eq = _equilibrate(D, E)
        fac = cuda_banded.banded_factor(Ds.contiguous(), Es.contiguous())
        pos, neg, zero = block_tridiag_inertia(fac, EPS_INERTIA)
        piv = fac.d.flatten(1)
        if nb > 0:
            # The border Schur complement's pivots count toward the
            # inertia and the gates like the band's, on the device.
            X, Lb, db = border_schur(fac, s_eq)
            pos = pos + (db > EPS_INERTIA).sum(dim=1)
            neg = neg + (db < -EPS_INERTIA).sum(dim=1)
            zero = zero + nb - (db > EPS_INERTIA).sum(dim=1) - (db < -EPS_INERTIA).sum(dim=1)
            piv = torch.cat([piv, db], dim=1)
        else:
            X = self._zeros(B, 0, self.K, self.w)
            Lb, db = self._zeros(B, 0, 0), self._zeros(B, 0)
        small_any = (torch.abs(piv) < SMALL_PIVOT).any(dim=1)
        finite = torch.isfinite(piv).all(dim=1)
        small = (deltas == 0.0) & (gammas == 0.0) & small_any
        return (fac, s_eq, X, Lb, db), pos, neg, zero, ~finite | small

    def _border_schur(self, d, sigma, fac, s_eq, col0, e0, deltas, gammas):
        """T⁻¹·col for every border column of every ladder candidate, with
        one refinement pass, and the LDLᵀ of the border Schur complement
        S_b = e₀ + δI − colᵀT⁻¹col: X (B, nb, K, w), L (B, nb, nb), d
        (B, nb). Each solve is one K2 launch over all B candidates with
        the nb columns as its right-hand sides."""

        def tsolve(rhs):  # (B, nb, K, w) -> T⁻¹ rhs, per candidate
            b = (s_eq[:, None] * rhs).permute(0, 2, 3, 1).contiguous()
            return s_eq[:, None] * cuda_banded.banded_solve(fac, b).permute(0, 3, 1, 2)

        cols = col0.expand(deltas.shape[0], *col0.shape)
        X = tsolve(cols)
        X = X + tsolve(cols - self._kkt_matvec_staged(d, sigma, deltas[:, None], gammas[:, None], X))
        eye = torch.eye(self.nb, dtype=_F64, device=self.device)
        Sb = e0 + deltas[:, None, None] * eye - torch.einsum("akw,Bbkw->Bab", col0, X)
        Lb, db = ldlt_unblocked(Sb)
        return X, Lb, db

    def _assemble_border(self, d: BandedDerivs, sigma):
        """The border columns in staged layout (nb, K, w) and the δ-free
        border block e₀ = H_bb + Σᵣ σᵣ a_b a_bᵀ (nb, nb); `vmap`-safe."""
        K, w, nb = self.K, self.w, self.nb
        if nb == 0:
            return self._zeros(nb, K, w), self._zeros(0, 0)
        colm = d.Hb  # (nb, K, m)
        e0 = d.Hbb
        if self.mi > 0:
            sig_st = self._stage_ineq(sigma)  # (K, q)
            Aib_st = self._zeros(K, self.q, nb).index_put((self._ci_stage, self._ci_slot), d.Aib)
            colm = colm + torch.einsum("kq,kqm,kqb->bkm", sig_st, d.Ailoc, Aib_st)
            e0 = e0 + torch.einsum("r,ra,rb->ab", sigma, d.Aib, d.Aib)
        cole = self._zeros(nb, K, self.p)
        if self.me > 0:
            cole = cole.index_put(
                (self._nb_idx[:, None], self._ce_stage[None, :], self._ce_slot[None, :]), d.Aeb.T
            )
        return torch.cat([colm, cole], dim=-1), e0

    def _scaled_solve(self, fac: BandedFactor, b: torch.Tensor) -> torch.Tensor:
        """Solve the regularized staged system for b (K, w)."""
        return fac.s * cuda_banded.banded_solve(fac.fac, (fac.s * b)[None])[0]

    def _border_block_solve(self, fac: BandedFactor, r: torch.Tensor) -> torch.Tensor:
        """Solve S_b v = r with the border Schur LDLᵀ ((nb,) rhs)."""
        L = fac.Sb_L
        y = torch.linalg.solve_triangular(L, r[:, None], upper=False)[:, 0]
        y = y / torch.where(fac.Sb_d == 0.0, 1.0, fac.Sb_d)
        return torch.linalg.solve_triangular(L.T, y[:, None], upper=True)[:, 0]

    def _bordered_solve(self, fac: BandedFactor, b: torch.Tensor, b_b: torch.Tensor):
        """Solve the whole arrowhead system given the factor: (staged
        solution (K, w), border solution (nb,))."""
        u0 = self._scaled_solve(fac, b)
        if self.nb == 0:
            return u0, b_b
        v = self._border_block_solve(fac, b_b - torch.einsum("bkw,kw->b", fac.col, u0))
        return u0 - torch.einsum("bkw,b->kw", fac.Xcols, v), v

    def _staged_rhs(self, rhs_top, rhs_bottom):
        """Flat rhs -> staged (K, w) and border (nb,) parts; `vmap`-safe."""
        b = torch.cat([self._stage_vec(rhs_top), self._stage_eq(rhs_bottom)], dim=-1)
        return b, rhs_top[self._border_pos]

    def _unpack_solution(self, sol, v_b):
        p_x = self._unstage_vec(sol[:, : self.m])
        if self.nb > 0:
            p_x = p_x.index_put((self._border_pos,), v_b)
        p_y = (
            -sol[self._ce_stage, self.m + self._ce_slot]
            if self.me > 0
            else self._zeros(0)
        )
        return p_x, p_y

    def solve(self, fac: BandedFactor, rhs_top, rhs_bottom):
        return self._unpack_solution(*self._bordered_solve(fac, *self._staged_rhs(rhs_top, rhs_bottom)))

    def _kkt_matvec_staged(self, d: BandedDerivs, sigma, delta, gamma, sol):
        """Apply the regularized staged KKT matrix (without the border) to
        sol (..., K, w): per-stage diagonal [Hd + AᵢᵀΣAᵢ + δI, Alocᵀ;
        Aloc, diag(−γ | −1 pad)] with sub-diagonal coupling [Hc, Anextᵀ;
        0, 0]. δ and γ are scalars or broadcast over sol's leading axes."""
        m = self.m
        if torch.is_tensor(delta) and delta.dim():
            delta, gamma = delta[..., None, None], gamma[..., None, None]
        u = sol[..., :m]  # (..., K, m)
        v = sol[..., m:]  # (..., K, p)
        top = torch.einsum("kij,...kj->...ki", d.Hd, u) + delta * u
        if self.K > 1:
            top[..., 1:, :] += torch.einsum("kij,...kj->...ki", d.Hc, u[..., :-1, :])
            top[..., :-1, :] += torch.einsum("kji,...kj->...ki", d.Hc, u[..., 1:, :])
        if self.mi > 0:
            t = torch.einsum("kqm,...km->...kq", d.Ailoc, u) * self._stage_ineq(sigma)
            top = top + torch.einsum("kqm,...kq->...km", d.Ailoc, t)
        # Aₑᵀ v (staged): stage-local rows plus next-stage coupling
        top = top + torch.einsum("kpm,...kp->...km", d.Aloc, v)
        if self.K > 1:
            top[..., 1:, :] += torch.einsum("kpm,...kp->...km", d.Anext, v)[..., :-1, :]
        # Aₑ u rows + regularization diagonal
        u_next = torch.cat([u[..., 1:, :], torch.zeros_like(u[..., :1, :])], dim=-2)
        bot = torch.einsum("kpm,...km->...kp", d.Aloc, u) + torch.einsum(
            "kpm,...km->...kp", d.Anext, u_next
        )
        bot = bot + torch.where(self._eq_slot_real, -gamma, -1.0) * v
        return torch.cat([top, bot], dim=-1)

    def solve_refined(self, d: BandedDerivs, sigma, fac: BandedFactor, rhs_top,
                      rhs_bottom, iterations: int = 2):
        """Solve plus a fixed count of iterative-refinement passes against
        the exact KKT matvec, border included: the stage-ordered
        elimination needs it for backward stability. Three solves per
        call in all."""
        b, b_b = self._staged_rhs(rhs_top, rhs_bottom)
        sol, v_b = self._bordered_solve(fac, b, b_b)
        for _ in range(iterations):
            r = b - self._kkt_matvec_staged(d, sigma, fac.delta, fac.gamma, sol)
            r_b = b_b
            if self.nb > 0:
                r = r - torch.einsum("bkw,b->kw", fac.col, v_b)
                r_b = (b_b - torch.einsum("bkw,kw->b", fac.col, sol) - fac.e0 @ v_b
                       - fac.delta * v_b)
            du, dv = self._bordered_solve(fac, r, r_b)
            sol, v_b = sol + du, v_b + dv
        return self._unpack_solution(sol, v_b)

    # -- observability -----------------------------------------------------

    def dense(self, d: BandedDerivs):
        """Reconstruct dense H/A_e/A_i as numpy (callback path only)."""
        K, m, n, me, mi = self.K, self.m, self.n, self.me, self.mi
        Hd, Hc = d.Hd.cpu().numpy(), d.Hc.cpu().numpy()
        perm = np.asarray(self.structure.var_perm)
        stages = perm.reshape(K, m)
        bp = np.asarray(self.structure.border, dtype=np.int64)
        H = np.zeros((n, n))
        for k in range(K):
            vk = stages[k]
            H[np.ix_(vk, vk)] = Hd[k]
            if k + 1 < K:
                vk1 = stages[k + 1]
                H[np.ix_(vk1, vk)] = Hc[k]
                H[np.ix_(vk, vk1)] = Hc[k].T
        if self.nb > 0:
            Hb = d.Hb.cpu().numpy()  # (nb, K, m)
            for bi in range(self.nb):
                H[bp[bi], perm] = Hb[bi].reshape(-1)
                H[perm, bp[bi]] = Hb[bi].reshape(-1)
            H[np.ix_(bp, bp)] = d.Hbb.cpu().numpy()
        A_e = np.zeros((me, n))
        Aloc, Anext = d.Aloc.cpu().numpy(), d.Anext.cpu().numpy()
        for r in range(me):
            s_, sl = self.structure.ce_stage[r], self.structure.ce_slot[r]
            A_e[r, stages[s_]] = Aloc[s_, sl]
            if s_ + 1 < K:
                A_e[r, stages[s_ + 1]] = Anext[s_, sl]
        if self.nb > 0 and me > 0:
            A_e[:, bp] = d.Aeb.cpu().numpy()
        A_i = np.zeros((mi, n))
        Ailoc = d.Ailoc.cpu().numpy()
        for r in range(mi):
            s_, sl = self.structure.ci_stage[r], self.structure.ci_slot[r]
            A_i[r, stages[s_]] = Ailoc[s_, sl]
        if self.nb > 0 and mi > 0:
            A_i[:, bp] = d.Aib.cpu().numpy()
        return H, A_e, A_i
