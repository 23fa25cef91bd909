"""Hopper kernels of the double-float precision probe.

Replaces the TPU probe `tools/pallas_dd_probe.py` (`run_kernel`): each
primitive of `ops/dd.py` (two_sum, two_prod, add2, mul2, div2) runs in an
elementwise kernel of `csrc/dd_probe.cu`, and a one-hot float32 matrix
product runs in a kernel of its own. The source is built with
`-fmad=false`, so each kernel does the same IEEE float32 operations in
the same order as its plain version in `ops/dd.py` and agrees with it bit
for bit.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. `LAUNCHES` counts kernel launches
only.
"""

from __future__ import annotations

import ctypes

import torch

from sleipnir_tpu_torch.ops import cuda_build, dd

#: Kernel launches since the counter was last reset.
LAUNCHES = 0

SOURCE = cuda_build.Source(
    cuda_build.CSRC / "dd_probe.cu", cuda_build.BASE_FLAGS + ("-fmad=false",)
)

#: Primitive name -> (kernel op code, number of float32 inputs).
PRIMITIVES = {"two_sum": (0, 2), "two_prod": (1, 2), "add2": (2, 4), "mul2": (3, 4), "div2": (4, 4)}

_lib = None


def reset_counters() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _library():
    global _lib
    if _lib is None:
        [(path, _log)] = cuda_build.build([SOURCE])
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sleipnir_dd_elementwise.argtypes = [i32] + [ptr] * 6 + [i32, ptr]
        lib.sleipnir_dd_elementwise.restype = i32
        lib.sleipnir_dd_onehot.argtypes = [ptr] * 3 + [i32, ptr]
        lib.sleipnir_dd_onehot.restype = i32
        lib.sleipnir_dd_error_string.argtypes = [i32]
        lib.sleipnir_dd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(tensors, name: str) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: every input must be on {device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be float32, got {t.dtype}")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: inputs must share one shape")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return device


def _launched(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sleipnir_dd_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
    global LAUNCHES
    LAUNCHES += 1


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def primitive(name: str, *inputs: torch.Tensor):
    """Run the dd primitive `name` elementwise on float32 tensors of one
    shape: two_sum/two_prod take (a, b), add2/mul2/div2 take
    (xh, xl, yh, yl). Returns the (hi, lo) pair."""
    op, arity = PRIMITIVES[name]
    if len(inputs) != arity:
        raise ValueError(f"{name} takes {arity} tensors, got {len(inputs)}")
    device = _check_inputs(inputs, name)
    if device.type == "cpu":
        return getattr(dd, name)(*inputs)
    if device.type != "cuda":
        raise ValueError(f"{name}: inputs must be CPU or CUDA tensors, got {device}")
    lib = _library()
    hi = torch.empty_like(inputs[0])
    lo = torch.empty_like(inputs[0])
    args = list(inputs) + [None] * (4 - arity)
    with torch.cuda.device(device):
        err = lib.sleipnir_dd_elementwise(
            op, *(_ptr(t) for t in args), _ptr(hi), _ptr(lo), inputs[0].numel(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _launched(lib, err, name)
    return hi, lo


def onehot_product(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """P @ X for square float32 matrices of one width w (w·w ≤ 1024),
    summed in the inner index's order."""
    device = _check_inputs((P, X), "onehot_product")
    w = P.shape[0]
    if P.dim() != 2 or P.shape[1] != w or w * w > 1024:
        raise ValueError(f"onehot_product takes (w, w) matrices with w*w <= 1024, got {tuple(P.shape)}")
    if device.type == "cpu":
        return dd.onehot_product(P, X)
    if device.type != "cuda":
        raise ValueError(f"onehot_product: inputs must be CPU or CUDA tensors, got {device}")
    lib = _library()
    out = torch.empty_like(P)
    with torch.cuda.device(device):
        err = lib.sleipnir_dd_onehot(
            _ptr(P), _ptr(X), _ptr(out), w,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _launched(lib, err, "onehot_product")
    return out
