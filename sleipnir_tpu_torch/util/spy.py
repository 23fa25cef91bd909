"""Sparsity-pattern-over-time recorder (reference util/spy.hpp:47-120).

Port of `sleipnir_tpu/util/spy.py`. Writes the same binary .spy format
as the reference (format documented at reference util/spy.hpp:20-44),
viewable with the reference's tools/spy.py
animation viewer or this module's matplotlib one-shot `spy()` helper
(reference python/src/sleipnir/autodiff/__init__.py:6).
"""

from __future__ import annotations

import struct

import numpy as np


class Spy:
    """Records dense-matrix sparsity patterns over time to a .spy file."""

    def __init__(
        self,
        filename: str,
        title: str,
        row_label: str,
        col_label: str,
        rows: int,
        cols: int,
    ) -> None:
        self._file = open(filename, "wb")  # noqa: SIM115
        for text in (title, row_label, col_label):
            data = text.encode("utf-8")
            self._file.write(struct.pack("<i", len(data)))
            self._file.write(data)
        self._file.write(struct.pack("<i", rows))
        self._file.write(struct.pack("<i", cols))

    def add(self, matrix) -> None:
        """Append the sparsity pattern of a matrix."""
        m = np.asarray(matrix)
        rows, cols = np.nonzero(m)
        self._file.write(struct.pack("<i", len(rows)))
        for r, c in zip(rows, cols):
            v = m[r, c]
            sign = b"+" if v > 0 else (b"-" if v < 0 else b"0")
            self._file.write(struct.pack("<ii", int(r), int(c)))
            self._file.write(sign)
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "Spy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spy(matrix, title: str = "Sparsity pattern"):
    """One-shot matplotlib sparsity plot (reference
    python/src/sleipnir/autodiff/__init__.py:6)."""
    import matplotlib.pyplot as plt  # noqa: PLC0415

    fig, ax = plt.subplots()
    ax.spy(np.asarray(matrix), markersize=1)
    ax.set_title(title)
    return fig
