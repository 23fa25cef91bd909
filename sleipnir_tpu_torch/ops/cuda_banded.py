"""Hopper kernels for the block-tridiagonal factor (K1) and solve (K2).

Replaces the TPU kernels `sleipnir_tpu/ops/pallas_banded.py`:
`pallas_banded_factor` (body `_factor_kernel`) and `pallas_banded_solve`
(body `_solve_kernel`). The CUDA C++ source is `csrc/banded.cu`. What
bounds the kernels on the card is per-stage latency: each system is one
chain of K dependent stages, far from the f64 rate or the memory
bandwidth. So one warp runs each chain with warp-level steps only
(shuffles and `__syncwarp`, no block-wide barrier), the next stages'
blocks are copied into shared memory ahead of their use, and what does
not feed the chain runs beside it in parallel: the inertia pivots of
every S_k in a second launch of the factor, and the block solves
S_k⁻¹y_k of every stage between the solve's two sweeps.

The kernels are built with `nvcc` for `sm_90a` at first use by
`ops/cuda_build.py` and bound through `ctypes`. They are instantiated for
float64 and float32: every tensor of one launch has one of the two dtypes,
and the wrappers raise for any other dtype or a mix.

A wrapper given CUDA tensors launches its kernels or raises; given CPU
tensors it runs the plain twin in `ops/block_tridiag.py`. The launch
counters `FACTOR_LAUNCHES` and `SOLVE_LAUNCHES` count wrapper calls that
launched in float64 (the factor is two kernel launches, the solve three),
`FACTOR_LAUNCHES_F32` and `SOLVE_LAUNCHES_F32` those in float32, and
`LAUNCHES_BY_SHAPE` counts them by (kind, B, K, w), with "factor_f32" and
"solve_f32" as the float32 kinds, so a run can show which shapes reached
the kernels; `PLAIN_BY_SHAPE` counts, by the same key, the calls that ran
the plain twin, so a run on the CPU shows the shapes a run on the card
would launch. The TPU's chunked kernels
(`_pallas_factor_chunked`, `_pallas_solve_chunked`), which long horizons
take there, have no separate counterpart: these kernels stream every
stage's blocks from device memory whatever K is.

`banded_factor_part` and `banded_solve_part` are the partitioned
(SPIKE/Schur) form of the same factor and solve (`ops/block_tridiag.py`,
`block_tridiag_factor_part`), built from these two kernels: K1 over the
interiors of all parts as one batch, K2 for the condensation columns,
batched torch products for the interface blocks, and the reduced system
again. `PARTITIONED_BY_SHAPE` counts their calls by the outer system's
("factor" | "solve" [+ "_f32"], B, K, w), and `PARTITIONED_LAUNCHES` the
kernel launches (or plain-twin calls, on the CPU) they made, by the same
key.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sleipnir_tpu_torch.ops import block_tridiag, cuda_build
from sleipnir_tpu_torch.ops.block_tridiag import BlockTridiagFactor

#: Kernel launches since the counters were last reset, float64 and float32.
FACTOR_LAUNCHES = 0
SOLVE_LAUNCHES = 0
FACTOR_LAUNCHES_F32 = 0
SOLVE_LAUNCHES_F32 = 0
#: The same launches by ("factor" | "solve" | "factor_f32" | "solve_f32",
#: B, K, w).
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()
#: Wrapper calls given CPU tensors (the plain twin ran), by the same key.
PLAIN_BY_SHAPE: collections.Counter = collections.Counter()
#: Calls of the partitioned factor and solve by the outer system's shape,
#: and the K1/K2 calls each key made (launches, or plain-twin calls on
#: the CPU).
PARTITIONED_BY_SHAPE: collections.Counter = collections.Counter()
PARTITIONED_LAUNCHES: collections.Counter = collections.Counter()

#: Widest stage block the kernels take (the feasibility-restoration
#: system of cart-pole is 37 wide); their shared memory is sized for it.
MAX_WIDTH = 37

SOURCE = cuda_build.Source(cuda_build.CSRC / "banded.cu")

_lib = None


#: The kernels' scalar types: the suffix of their entry points and of
#: their counters' kinds.
_SUFFIX = {torch.float64: "", torch.float32: "_f32"}


def reset_counters() -> None:
    global FACTOR_LAUNCHES, SOLVE_LAUNCHES, FACTOR_LAUNCHES_F32, SOLVE_LAUNCHES_F32
    FACTOR_LAUNCHES = 0
    SOLVE_LAUNCHES = 0
    FACTOR_LAUNCHES_F32 = 0
    SOLVE_LAUNCHES_F32 = 0
    LAUNCHES_BY_SHAPE.clear()
    PLAIN_BY_SHAPE.clear()
    PARTITIONED_BY_SHAPE.clear()
    PARTITIONED_LAUNCHES.clear()


def _kind(kind: str, dtype: torch.dtype) -> str:
    """The counters' key of a call: "factor", "factor_f32", ..."""
    return kind + _SUFFIX.get(dtype, "")


def _library():
    global _lib
    if _lib is None:
        [(path, _log)] = cuda_build.build([SOURCE])
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix in _SUFFIX.values():
            factor = getattr(lib, "sleipnir_banded_factor" + suffix)
            factor.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
            factor.restype = i32
            solve = getattr(lib, "sleipnir_banded_solve" + suffix)
            solve.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
            solve.restype = i32
        lib.sleipnir_cuda_error_string.argtypes = [i32]
        lib.sleipnir_cuda_error_string.restype = ctypes.c_char_p
        lib.sleipnir_banded_max_width.argtypes = []
        lib.sleipnir_banded_max_width.restype = i32
        if lib.sleipnir_banded_max_width() != MAX_WIDTH:
            raise RuntimeError("csrc/banded.cu disagrees on the maximum width")
        _lib = lib
    return _lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sleipnir_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, shape: tuple, dtype, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _scalar_type(t: torch.Tensor, name: str) -> torch.dtype:
    """The kernels' scalar type for a launch whose tensors follow `t`."""
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{name} must be torch.float64 or torch.float32, got {t.dtype}")
    return t.dtype


def banded_factor(D: torch.Tensor, E: torch.Tensor) -> BlockTridiagFactor:
    """Factor a batch of block-tridiagonal systems: D (B, K, w, w)
    diagonal blocks, E (B, K-1, w, w) blocks below them, both float64 or
    both float32."""
    if D.device.type == "cpu" and E.device.type == "cpu":
        PLAIN_BY_SHAPE[_kind("factor", D.dtype), *D.shape[:3]] += 1
        return block_tridiag.block_tridiag_factor(D, E)
    if D.dim() != 4:
        raise ValueError(f"D must be (B, K, w, w), got {tuple(D.shape)}")
    B, K, w, _ = D.shape
    if not (B >= 1 and K >= 1 and 1 <= w <= MAX_WIDTH):
        raise ValueError(f"unsupported shape (B, K, w) = {(B, K, w)}")
    dtype = _scalar_type(D, "D")
    _require(D, "D", (B, K, w, w), dtype, D.device)
    _require(E, "E", (B, K - 1, w, w), dtype, D.device)
    lib = _library()
    LU = torch.empty_like(D)
    perm = torch.empty((B, K, w), dtype=torch.int32, device=D.device)
    d = torch.empty((B, K, w), dtype=dtype, device=D.device)
    X = torch.empty_like(E)
    S = torch.empty_like(D)  # the chain's S_k, read by the inertia pass
    with torch.cuda.device(D.device):
        err = getattr(lib, "sleipnir_banded_factor" + _SUFFIX[dtype])(
            _ptr(D), _ptr(E), _ptr(LU), _ptr(perm), _ptr(d), _ptr(X), _ptr(S),
            B, K, w, _stream(),
        )
    _check(lib, err, "banded_factor")
    global FACTOR_LAUNCHES, FACTOR_LAUNCHES_F32
    if dtype == torch.float32:
        FACTOR_LAUNCHES_F32 += 1
    else:
        FACTOR_LAUNCHES += 1
    LAUNCHES_BY_SHAPE[_kind("factor", dtype), B, K, w] += 1
    return BlockTridiagFactor(LU=LU, perm=perm, d=d, X=X)


def banded_solve(fac: BlockTridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve factored systems for b (B, K, w) or (B, K, w, r), in the
    factor's dtype (float64 or float32)."""
    if b.device.type == "cpu":
        PLAIN_BY_SHAPE[_kind("solve", b.dtype), *b.shape[:3]] += 1
        return block_tridiag.block_tridiag_solve(fac, b)
    if b.dim() not in (3, 4):
        raise ValueError(f"b must be (B, K, w[, r]), got {tuple(b.shape)}")
    B, K, w = b.shape[:3]
    r = b.shape[3] if b.dim() == 4 else 1
    if not (B >= 1 and K >= 1 and 1 <= w <= MAX_WIDTH and r >= 1):
        raise ValueError(f"unsupported shape (B, K, w, r) = {(B, K, w, r)}")
    dtype = _scalar_type(b, "b")
    _require(b, "b", tuple(b.shape), dtype, b.device)
    _require(fac.LU, "LU", (B, K, w, w), dtype, b.device)
    _require(fac.perm, "perm", (B, K, w), torch.int32, b.device)
    _require(fac.X, "X", (B, K - 1, w, w), dtype, b.device)
    lib = _library()
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        err = getattr(lib, "sleipnir_banded_solve" + _SUFFIX[dtype])(
            _ptr(fac.LU), _ptr(fac.perm), _ptr(fac.X), _ptr(b), _ptr(x),
            B, K, w, r, _stream(),
        )
    _check(lib, err, "banded_solve")
    global SOLVE_LAUNCHES, SOLVE_LAUNCHES_F32
    if dtype == torch.float32:
        SOLVE_LAUNCHES_F32 += 1
    else:
        SOLVE_LAUNCHES += 1
    LAUNCHES_BY_SHAPE[_kind("solve", dtype), B, K, w] += 1
    return x


def _calls() -> int:
    """K1/K2 calls so far: kernel launches and plain-twin calls."""
    return (FACTOR_LAUNCHES + SOLVE_LAUNCHES + FACTOR_LAUNCHES_F32 + SOLVE_LAUNCHES_F32
            + sum(PLAIN_BY_SHAPE.values()))


def _partitioned(kind: str, t: torch.Tensor, run):
    key = (_kind(kind, t.dtype), *t.shape[:3])
    before = _calls()
    out = run()
    PARTITIONED_BY_SHAPE[key] += 1
    PARTITIONED_LAUNCHES[key] += _calls() - before
    return out


def banded_factor_part(D: torch.Tensor, E: torch.Tensor):
    """The partitioned factor of D (B, K, w, w) and E (B, K-1, w, w) on
    K1 and K2 (their plain twin on CPU tensors): a `PartitionedFactor`,
    or K1's factor when K < `block_tridiag.PART_MIN_BLOCKS`."""
    if D.shape[1] < block_tridiag.PART_MIN_BLOCKS:
        return banded_factor(D, E)
    return _partitioned("factor", D, lambda: block_tridiag.block_tridiag_factor_part(
        D, E, banded_factor, banded_solve))


def banded_solve_part(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve with a `banded_factor_part` result for b (B, K, w) or
    (B, K, w, r) on K2 (its plain twin on CPU tensors)."""
    if not isinstance(fac, block_tridiag.PartitionedFactor):
        return banded_solve(fac, b)
    return _partitioned("solve", b, lambda: block_tridiag.block_tridiag_solve_part(
        fac, b, banded_solve))
