"""The least work of the KKT factor and solve, and the card's peaks.

A staged system is block tridiagonal: B systems of K diagonal blocks and
K−1 sub-diagonal blocks, each w × w. The counts below are the
mathematics of a block LU of that system, whatever form the program
factors it in (K1/K2's chain, the partitioned form, block cyclic
reduction, the explicit inverse): they take only (B, K, w[, r]) and the
dtype, so a form that does more work, or a fused kernel, is read against
the same least time and a share never passes 100% because the count
followed the implementation.

  factor  reads the D and E blocks once and writes one factor of the
          matrix's own size once; per stage an LU of the Schur block
          (2/3·w³), w right-hand sides through it (2·w³) and the Schur
          update (2·w³);
  solve   reads that factor and the r right-hand sides once and writes
          the r solutions once; per stage and right-hand side a forward
          and a backward substitution (2·w² each) and the coupling
          products (2·w² each way).

The least time is the larger of bytes over the memory bandwidth and
operations over the arithmetic peak.
"""

from __future__ import annotations

#: One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
#: rates): HBM3 bandwidth, and the float64 and float32 peaks outside the
#: 8-bit and 16-bit tensor-core modes.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}
WORD_BYTES = {"float64": 8, "float32": 4}


def _matrix_words(B: int, K: int, w: int) -> int:
    return B * (2 * K - 1) * w * w


def factor_work(B: int, K: int, w: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of factoring B staged systems (K, w)."""
    nbytes = 2 * _matrix_words(B, K, w) * WORD_BYTES[dtype]
    ops = B * (K * (2.0 / 3.0) * w**3 + (K - 1) * 4.0 * w**3)
    return float(nbytes), float(ops)


def solve_work(B: int, K: int, w: int, r: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of solving B factored staged systems (K, w)
    for r right-hand sides each."""
    nbytes = (_matrix_words(B, K, w) + 2 * B * K * w * r) * WORD_BYTES[dtype]
    ops = B * r * (4.0 * K * w**2 + 4.0 * (K - 1) * w**2)
    return float(nbytes), float(ops)


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    """The larger of bytes over bandwidth and operations over peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])
