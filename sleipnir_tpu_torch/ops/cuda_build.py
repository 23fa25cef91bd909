"""Build the port's CUDA sources with `nvcc` into shared libraries.

Each source under `csrc/` is compiled for `sm_90a` into
`build/sleipnir_tpu_torch/` (git ignores `build/`) at first use, keyed by
a hash of the source and its flags, and bound by its wrapper module
through `ctypes`. `build` starts one `nvcc` per missing library, all at
once, and waits for them together.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sleipnir_tpu_torch"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class Source(NamedTuple):
    """A CUDA source and the flags it is built with."""

    path: Path
    flags: tuple[str, ...] = BASE_FLAGS

    def library(self) -> Path:
        digest = hashlib.sha256(
            self.path.read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()
        return BUILD_DIR / f"lib{self.path.stem}_{digest[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _compile(src: Source, verbose: bool) -> tuple[Path, str, str | None]:
    """(library, compiler output, error or None) for one source."""
    lib = src.library()
    if lib.exists():
        return lib, "", None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *src.flags, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, str(src.path)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            return lib, proc.stdout, f"nvcc failed on {src.path.name} ({proc.returncode}):\n{proc.stdout}"
        os.replace(tmp, lib)
        return lib, proc.stdout, None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(sources: list[Source], verbose: bool = False) -> list[tuple[Path, str]]:
    """Compile every source whose library is missing, one `nvcc` per
    source, all started together.

    Returns (library path, compiler output) per source, in order; the
    output is empty for a library that was already built. With `verbose`,
    ptxas reports each kernel's registers, shared memory and spills.
    Raises RuntimeError naming each source that failed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        done = list(pool.map(lambda src: _compile(src, verbose), sources))
    errors = [err for _lib, _log, err in done if err is not None]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [(lib, log) for lib, log, _err in done]
