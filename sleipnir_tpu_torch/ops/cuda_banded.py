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
`ops/cuda_build.py` and bound through `ctypes`.

A wrapper given CUDA tensors launches its kernels or raises; given CPU
tensors it runs the plain twin in `ops/block_tridiag.py`. The launch
counters `FACTOR_LAUNCHES` and `SOLVE_LAUNCHES` count wrapper calls that
launched (the factor is two kernel launches, the solve three), and
`LAUNCHES_BY_SHAPE` counts them by (kind, B, K, w), so a run can show
which shapes reached the kernels; `PLAIN_BY_SHAPE` counts, by the same
key, the calls that ran the plain twin, so a run on the CPU shows the
shapes a run on the card would launch. The TPU's chunked kernels
(`_pallas_factor_chunked`, `_pallas_solve_chunked`), which long horizons
take there, have no separate counterpart: these kernels stream every
stage's blocks from device memory whatever K is.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from sleipnir_tpu_torch.ops import block_tridiag, cuda_build
from sleipnir_tpu_torch.ops.block_tridiag import BlockTridiagFactor

#: Kernel launches since the counters were last reset.
FACTOR_LAUNCHES = 0
SOLVE_LAUNCHES = 0
#: The same launches by ("factor" | "solve", B, K, w).
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()
#: Wrapper calls given CPU tensors (the plain twin ran), by the same key.
PLAIN_BY_SHAPE: collections.Counter = collections.Counter()

#: Widest stage block the kernels take (the feasibility-restoration
#: system of cart-pole is 37 wide); their shared memory is sized for it.
MAX_WIDTH = 37

SOURCE = cuda_build.Source(cuda_build.CSRC / "banded.cu")

_lib = None


def reset_counters() -> None:
    global FACTOR_LAUNCHES, SOLVE_LAUNCHES
    FACTOR_LAUNCHES = 0
    SOLVE_LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()
    PLAIN_BY_SHAPE.clear()


def _library():
    global _lib
    if _lib is None:
        [(path, _log)] = cuda_build.build([SOURCE])
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sleipnir_banded_factor.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        lib.sleipnir_banded_factor.restype = i32
        lib.sleipnir_banded_solve.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.sleipnir_banded_solve.restype = i32
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


def banded_factor(D: torch.Tensor, E: torch.Tensor) -> BlockTridiagFactor:
    """Factor a batch of block-tridiagonal systems: D (B, K, w, w) f64
    diagonal blocks, E (B, K-1, w, w) f64 blocks below them."""
    if D.device.type == "cpu" and E.device.type == "cpu":
        PLAIN_BY_SHAPE["factor", *D.shape[:3]] += 1
        return block_tridiag.block_tridiag_factor(D, E)
    if D.dim() != 4:
        raise ValueError(f"D must be (B, K, w, w), got {tuple(D.shape)}")
    B, K, w, _ = D.shape
    if not (B >= 1 and K >= 1 and 1 <= w <= MAX_WIDTH):
        raise ValueError(f"unsupported shape (B, K, w) = {(B, K, w)}")
    _require(D, "D", (B, K, w, w), torch.float64, D.device)
    _require(E, "E", (B, K - 1, w, w), torch.float64, D.device)
    lib = _library()
    LU = torch.empty_like(D)
    perm = torch.empty((B, K, w), dtype=torch.int32, device=D.device)
    d = torch.empty((B, K, w), dtype=torch.float64, device=D.device)
    X = torch.empty_like(E)
    S = torch.empty_like(D)  # the chain's S_k, read by the inertia pass
    with torch.cuda.device(D.device):
        err = lib.sleipnir_banded_factor(
            _ptr(D), _ptr(E), _ptr(LU), _ptr(perm), _ptr(d), _ptr(X), _ptr(S),
            B, K, w, _stream(),
        )
    _check(lib, err, "banded_factor")
    global FACTOR_LAUNCHES
    FACTOR_LAUNCHES += 1
    LAUNCHES_BY_SHAPE["factor", B, K, w] += 1
    return BlockTridiagFactor(LU=LU, perm=perm, d=d, X=X)


def banded_solve(fac: BlockTridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve factored systems for b (B, K, w) or (B, K, w, r) f64."""
    if b.device.type == "cpu":
        PLAIN_BY_SHAPE["solve", *b.shape[:3]] += 1
        return block_tridiag.block_tridiag_solve(fac, b)
    if b.dim() not in (3, 4):
        raise ValueError(f"b must be (B, K, w[, r]), got {tuple(b.shape)}")
    B, K, w = b.shape[:3]
    r = b.shape[3] if b.dim() == 4 else 1
    if not (B >= 1 and K >= 1 and 1 <= w <= MAX_WIDTH and r >= 1):
        raise ValueError(f"unsupported shape (B, K, w, r) = {(B, K, w, r)}")
    _require(b, "b", tuple(b.shape), torch.float64, b.device)
    _require(fac.LU, "LU", (B, K, w, w), torch.float64, b.device)
    _require(fac.perm, "perm", (B, K, w), torch.int32, b.device)
    _require(fac.X, "X", (B, K - 1, w, w), torch.float64, b.device)
    lib = _library()
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        err = lib.sleipnir_banded_solve(
            _ptr(fac.LU), _ptr(fac.perm), _ptr(fac.X), _ptr(b), _ptr(x),
            B, K, w, r, _stream(),
        )
    _check(lib, err, "banded_solve")
    global SOLVE_LAUNCHES
    SOLVE_LAUNCHES += 1
    LAUNCHES_BY_SHAPE["solve", B, K, w] += 1
    return x
