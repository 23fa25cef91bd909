"""Time-axis (horizon) split of the block-tridiagonal KKT system over
several devices.

Port of `sleipnir_tpu/parallel/time_axis.py`, a factor/solve split that
the interior-point method's δ/γ inertia correction drives:

  - `sharded_factor`: each device owns a contiguous chunk of L stages.
    It factors its chunk's L-1 interior stages with the partitioned
    factor of `ops/cuda_banded.py` (`banded_factor_part`: K1 and K2 on
    the card), condenses them onto its last (interface) stage with two
    block columns in one solve, and the n-block interface system (n =
    the mesh's size) is gathered to every device and factored there,
    the same on each. Interior and interface pivots give the inertia.
  - `sharded_solve`: one local solve per device, the interface
    right-hand sides gathered to every device, the small reduced solve on
    each, and a batched product back to the interior stages.

The JAX package's mesh is single-controller: one program drives all its
devices. So is this one: `Mesh` is a tuple of `torch.device`s and an axis
name, one process and one host thread drive every device, each shard's
tensors live on its device, and the JAX package's collectives become
copies: its `ppermute` of the left neighbour's coupling block and its
`all_gather`s of the interface blocks and vectors are `.to(device)`. Each
step queues its work on every device before the next step starts, and
nothing reads a device value on the host, so the devices run side by
side. A mesh may name one device more than once: shards that share a
device run one after another there, which is how the CPU tests run 2,
4 and 8 shards on one CPU (the counterpart of the 8 host devices the
JAX package's tests force).

Every tensor of a `ShardedFactor` keeps the batch axis B first, so the
regularization ladder's `take` and the lanes' `merge` slice it as they
slice the other factors. The JAX package's per-device interior is its
explicit-inverse factor; this one is the pivoted factor it stands for,
since the explicit inverse is unusable on real KKT chains
(`sleipnir_tpu/optimization/solver/kkt_banded.py:188-199`). A chunk
needs at least two stages here; the JAX package's also takes chunks of
one.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.ops.block_tridiag import part_pivots


class Mesh(NamedTuple):
    """A one-axis device mesh: the devices in shard order, and the axis
    name. A device may appear more than once."""

    devices: tuple
    axis: str = "t"

    @classmethod
    def of(cls, devices: Sequence, axis: str = "t") -> "Mesh":
        return cls(tuple(torch.device(d) for d in devices), axis)

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(mesh: Mesh, axis: str) -> tuple:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    return mesh.devices


def pad_to_devices(D, E, b, n_dev: int):
    """Pad a batch of systems, D (B, K, w, w), E (B, K-1, w, w) and b
    (B, K, w[, r]) or None, with identity blocks so that K is a multiple
    of n_dev. Returns (D, E_full, b, K): E_full (B, Kp, w, w) holds
    E_full[:, k] = A(k+1, k) with a zero last block, K is the unpadded
    block count."""
    B, K, w, _ = D.shape
    pad = -(-K // n_dev) * n_dev - K
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    D = torch.cat([D, eye.expand(B, pad, w, w)], dim=1)
    E_full = torch.cat([E, E.new_zeros(B, pad + 1, w, w)], dim=1)
    if b is not None:
        b = torch.cat([b, b.new_zeros(B, pad, *b.shape[2:])], dim=1)
    return D, E_full, b, K


class ShardedFactor(NamedTuple):
    """Factor of a time-axis split system: one entry per shard in each
    tuple, on the shard's device, each with the batch axis B first."""

    loc: tuple  # the chunk interiors' factors (partitioned or K1's)
    cols: tuple  # (B, L-1, w, 2w): [Xl | Xr], T⁻¹ [U₀; 0…] | T⁻¹ […0; E_lastᵀ]
    U0: tuple  # (B, w, w): coupling of the chunk's first stage to its left interface
    E_last: tuple  # (B, w, w): coupling of the interface to the last interior stage
    red: tuple  # the interface system's factor, the same on every shard


def sharded_factor(mesh: Mesh, axis: str, D, E_full) -> ShardedFactor:
    """Factor a batch of systems, D (B, K, w, w) and E_full (B, K, w, w)
    as `pad_to_devices` gives them, with the stage axis split over
    `mesh`; K must be a multiple of the mesh's size. The unpadded count,
    the JAX package's `k_orig`, is `sharded_inertia`'s argument here."""
    devs = _devices(mesh, axis)
    n = len(devs)
    B, K, w, _ = D.shape
    if K % n:
        raise ValueError(f"K = {K} is not a multiple of the mesh's {n} devices")
    L = K // n
    Lint = L - 1
    if Lint < 1:
        raise ValueError(f"{K} stages over {n} devices leave no interior stage")
    D_loc = [D[:, i * L:(i + 1) * L].to(d) for i, d in enumerate(devs)]
    E_loc = [E_full[:, i * L:(i + 1) * L].to(d) for i, d in enumerate(devs)]
    # The left neighbour's last coupling, E_full[:, iL - 1] = A(our first
    # stage, its interface): the JAX package's ppermute.
    U0 = [E_loc[0].new_zeros(B, w, w)] + [
        E_loc[i - 1][:, L - 1].to(devs[i]) for i in range(1, n)
    ]
    loc = [cuda_banded.banded_factor_part(Dl[:, :Lint].contiguous(), El[:, :Lint - 1].contiguous())
           for Dl, El in zip(D_loc, E_loc)]
    E_last = [El[:, Lint - 1].contiguous() for El in E_loc]
    cols = []
    for f, U, El in zip(loc, U0, E_last):
        rhs = U.new_zeros(B, Lint, w, 2 * w)
        rhs[:, 0, :, :w] = U
        rhs[:, Lint - 1, :, w:] = El.transpose(-1, -2)
        cols.append(cuda_banded.banded_solve_part(f, rhs))
    S_own = [Dl[:, Lint] - El @ X[:, Lint - 1, :, w:] for Dl, El, X in zip(D_loc, E_last, cols)]
    U_own = [-(El @ X[:, Lint - 1, :, :w]) for El, X in zip(E_last, cols)]
    dDl = [-(U.transpose(-1, -2) @ X[:, 0, :, :w]) for U, X in zip(U0, cols)]
    # The interface system, gathered to and factored on every device.
    red = []
    for d in devs:
        S_g, U_g, dDl_g = (torch.stack([t.to(d) for t in ts], dim=1) for ts in (S_own, U_own, dDl))
        D_red = S_g + torch.cat([dDl_g[:, 1:], dDl_g.new_zeros(B, 1, w, w)], dim=1)
        red.append(cuda_banded.banded_factor_part(D_red, U_g[:, 1:].contiguous()))
    return ShardedFactor(loc=tuple(loc), cols=tuple(cols), U0=tuple(U0), E_last=tuple(E_last),
                         red=tuple(red))


def sharded_pivots(fac: ShardedFactor) -> list:
    """Every pivot tensor, (B, ·) each on its shard's device: the chunk
    interiors' and one copy of the interface system's."""
    return [p for f in fac.loc for p in part_pivots(f)] + part_pivots(fac.red[0])


def sharded_inertia(fac: ShardedFactor, eps: float, nblocks: int):
    """Inertia per system, each (B,) on the first shard's device, of
    systems of `nblocks` unpadded blocks (Sylvester): every pivot counts,
    less the padding's, each exactly +1, wherever padding entered (at the
    device split, inside a partitioned interior or the interface
    system)."""
    pivots = sharded_pivots(fac)
    dev = fac.E_last[0].device
    w = fac.E_last[0].shape[-1]
    pos = sum((p > eps).sum(dim=1).to(dev) for p in pivots)
    neg = sum((p < -eps).sum(dim=1).to(dev) for p in pivots)
    pad = sum(p.shape[1] for p in pivots) - nblocks * w
    pos = pos - pad
    return pos, neg, nblocks * w - pos - neg


def sharded_solve(mesh: Mesh, axis: str, fac: ShardedFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve with a `sharded_factor` result for b (B, K, w) or
    (B, K, w, r), padded or not; the solution comes back on b's device
    with b's K."""
    devs = _devices(mesh, axis)
    n = len(devs)
    vector = b.dim() == 3
    if vector:
        b = b[..., None]
    B, K, w, r = b.shape
    Lint = fac.cols[0].shape[1]
    L = Lint + 1
    b = torch.cat([b, b.new_zeros(B, n * L - K, w, r)], dim=1)
    b_loc = [b[:, i * L:(i + 1) * L].to(d) for i, d in enumerate(devs)]
    z = [cuda_banded.banded_solve_part(f, bl[:, :Lint].contiguous())
         for f, bl in zip(fac.loc, b_loc)]
    r_own = [bl[:, Lint] - El @ zl[:, Lint - 1] for bl, El, zl in zip(b_loc, fac.E_last, z)]
    dbl = [-(U.transpose(-1, -2) @ zl[:, 0]) for U, zl in zip(fac.U0, z)]
    out = []
    for i, d in enumerate(devs):
        r_g, dbl_g = (torch.stack([t.to(d) for t in ts], dim=1) for ts in (r_own, dbl))
        b_red = r_g + torch.cat([dbl_g[:, 1:], dbl_g.new_zeros(B, 1, w, r)], dim=1)
        x_ifc = cuda_banded.banded_solve_part(fac.red[i], b_red)  # (B, n, w, r)
        x_own = x_ifc[:, i]
        x_left = x_ifc[:, i - 1] if i > 0 else torch.zeros_like(x_own)
        x_int = z[i] - fac.cols[i] @ torch.cat([x_left, x_own], dim=-2)[:, None]
        out.append(torch.cat([x_int, x_own[:, None]], dim=1))
    x = torch.cat([o.to(b.device) for o in out], dim=1)[:, :K]
    return x[..., 0] if vector else x


def sharded_block_tridiag_solve(mesh: Mesh, axis: str, D, E_full, b):
    """Factor and solve in one call (the dry run's entry point)."""
    return sharded_solve(mesh, axis, sharded_factor(mesh, axis, D, E_full), b)
