"""Hopper kernel of the double-float precision probe.

Replaces the TPU probe `tools/pallas_dd_probe.py` (`run_kernel`). One
kernel of `csrc/dd_probe.cu` computes a whole probe run in one launch
(`probe`): each primitive of `ops/dd.py` (two_sum, two_prod, add2, mul2,
div2) elementwise, and a one-hot float32 matrix product on the tensor
cores, exact through a three-way TF32 split and once more in a single
TF32 pass. `primitive` and `onehot_product` are thin calls that launch
the same kernel for one part. The source is built with `-fmad=false`, so
each primitive does the same IEEE float32 operations in the same order as
its plain version in `ops/dd.py` and agrees with it bit for bit.

A wrapper given CUDA tensors launches the kernel or raises; given CPU
tensors it runs the plain version. `LAUNCHES` counts kernel launches
only. The host path is kept to what a launch needs: the ctypes function
is resolved once, each call makes one allocation, and the device
context is entered only when the tensors are not on the current card.
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

#: Primitive name -> (kernel op, number of float32 inputs), in the
#: kernel's op order; op 5 is the one-hot product.
PRIMITIVES = {"two_sum": (0, 2), "two_prod": (1, 2), "add2": (2, 4), "mul2": (3, 4), "div2": (4, 4)}
ONEHOT = 5
#: The product's matrices are padded to the tensor-core tile's 16.
MAX_WIDTH = 16

_kernel = None
_onehot = None
_error_string = None
_raw_stream = None


def reset_counters() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _bind():
    """The C entry points (whole probe, one-hot product alone), built and
    resolved at the first call."""
    global _kernel, _onehot, _error_string, _raw_stream
    if _kernel is None:
        [(path, _log)] = cuda_build.build([SOURCE])
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.sleipnir_dd_probe
        fn.argtypes = [ptr] * 4 + [i32] + [ptr] * 2 + [i32] * 4 + [ptr] * 2
        fn.restype = i32
        lib.sleipnir_dd_onehot.argtypes = [ptr] * 3 + [i32, ptr]
        lib.sleipnir_dd_onehot.restype = i32
        _onehot = lib.sleipnir_dd_onehot
        lib.sleipnir_dd_error_string.argtypes = [i32]
        lib.sleipnir_dd_error_string.restype = ctypes.c_char_p
        _error_string = lib.sleipnir_dd_error_string
        # The current stream of a device index as an integer, without the
        # Stream object `torch.cuda.current_stream` builds (the call
        # PyTorch's own generated kernels make before each launch).
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _kernel = fn
    return _kernel, _onehot


def _check(tensors, name: str, shape) -> int:
    """The device index every tensor lies on (-1 for the CPU); raises on
    what the kernel cannot take."""
    device = tensors[0].device
    for t in tensors:
        if t.dtype is not torch.float32:
            raise ValueError(f"{name}: inputs must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: inputs must share one shape")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != device:
            raise ValueError(f"{name}: every input must be on {device}, got {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs must be CPU or CUDA tensors, got {device}")
    return device.index if device.type == "cuda" else -1


def _check_onehot(P: torch.Tensor, X: torch.Tensor) -> int:
    w = P.shape[0] if P.dim() == 2 else -1
    if P.dim() != 2 or P.shape[1] != w or w > MAX_WIDTH:
        raise ValueError(
            f"onehot_product takes (w, w) matrices with w <= {MAX_WIDTH}, got {tuple(P.shape)}"
        )
    return w


def _launch(fn, index: int, *args) -> None:
    """One launch through the C entry point `fn` on card `index` with
    `args` and the card's current stream."""
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(
            f"dd probe launch failed: CUDA error {err} ({_error_string(err).decode()})"
        )
    global LAUNCHES
    LAUNCHES += 1


def primitive(name: str, *inputs: torch.Tensor):
    """Run the dd primitive `name` elementwise on float32 tensors of one
    shape: two_sum/two_prod take (a, b), add2/mul2/div2 take
    (xh, xl, yh, yl). Returns the (hi, lo) pair."""
    op, arity = PRIMITIVES[name]
    if len(inputs) != arity:
        raise ValueError(f"{name} takes {arity} tensors, got {len(inputs)}")
    a = inputs[0]
    index = _check(inputs, name, a.shape)
    if index < 0:
        return getattr(dd, name)(*inputs)
    fn, _ = _bind()
    out = a.new_empty((2, *a.shape))
    ptrs = [t.data_ptr() for t in inputs]
    xs = (ptrs[0], None, ptrs[1], None) if arity == 2 else ptrs
    _launch(fn, index, *xs, a.numel(), None, None, 0, op, 1, 0, out.data_ptr())
    return out.unbind(0)


def onehot_product(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """P @ X for a one-hot P and X, (w, w) float32 with w ≤ 16, exact: on
    the card the tensor cores' three-pass TF32 product."""
    w = _check_onehot(P, X)
    index = _check((P, X), "onehot_product", P.shape)
    if index < 0:
        return dd.onehot_product(P, X)
    _, fn = _bind()
    out = torch.empty_like(P)
    _launch(fn, index, P.data_ptr(), X.data_ptr(), out.data_ptr(), w)
    return out


def probe(ah, al, bh, bl, P, X):
    """A whole probe run in one launch: two_sum and two_prod of (ah, bh),
    add2, mul2 and div2 of (ah, al, bh, bl), and the one-hot product P X.

    Returns (pairs, products), views of one output tensor: pairs
    (5, 2, *shape) holds each primitive's (hi, lo) in `PRIMITIVES`'
    order; products (2, w, w) holds P X and P X in one TF32 pass (X
    truncated to 11 bits), the precision of the card's matrix unit on a
    plain float32 product. On CPU tensors both come from the plain
    versions."""
    w = _check_onehot(P, X)
    shape = ah.shape
    index = _check((ah, al, bh, bl), "probe", shape)
    if _check((P, X), "probe", P.shape) != index:
        raise ValueError(f"probe: every input must be on {ah.device}")
    if index < 0:
        pairs = torch.stack([
            torch.stack(dd.two_sum(ah, bh)), torch.stack(dd.two_prod(ah, bh)),
            *(torch.stack(getattr(dd, name)(ah, al, bh, bl)) for name in ("add2", "mul2", "div2")),
        ])
        products = torch.stack([dd.onehot_product(P, X), dd.onehot_product(P, dd.tf32_truncate(X))])
        return pairs, products
    fn, _ = _bind()
    n = ah.numel()
    out = ah.new_empty(10 * n + 2 * w * w)
    _launch(fn, index, ah.data_ptr(), al.data_ptr(), bh.data_ptr(), bl.data_ptr(), n,
            P.data_ptr(), X.data_ptr(), w, 0, ONEHOT + 1, 1, out.data_ptr())
    pairs = out.as_strided((5, 2, *shape), (2 * n, n, *ah.stride()))
    products = out.as_strided((2, w, w), (w * w, w, 1), 10 * n)
    return pairs, products
