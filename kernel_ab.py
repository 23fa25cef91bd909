"""Time two builds of a kernel source against each other on one CUDA
card: the block-tridiagonal kernels (K1 factor, K2 solve) or the
double-float probe (P).

Run from the repository root:

    python3 kernel_ab.py --baseline PATH/TO/banded.cu [--out FILE]
    python3 kernel_ab.py --dd-baseline DIR [--out FILE]

`--baseline` builds `sleipnir_tpu_torch/csrc/banded.cu` (the current
design) and the baseline source, whose float64 factor has six pointers
(the interface before the inertia pass took a scratch) or seven (with
the scratch `S`, as since then; read off the baseline source), each with
one `nvcc` for sm_90a, printing what ptxas reports. At each of the
paths' kernel shapes it then:

  - holds both builds against each other and against the plain torch
    version: pivots equal, inertia equal, unrefined solutions within 1e-10
    relative, and whether the two factors and solutions agree bit for bit;
  - times both with CUDA events in turns, baseline, current, current,
    baseline, and reports each build's mean over its two turns.

`--dd-baseline` takes a directory holding an earlier `dd_probe.cu` and
the `ops/cuda_dd_probe.py` that drove it (e.g. both from `git show` of
the parent commit), and compares a whole probe run and the one-hot
product through each wrapper in the same turns: host-paced (50
back-to-back calls) and on the device (one call after a sleep kernel),
with `torch.matmul` beside them, after checking that both builds equal
the plain version bit for bit.

Prints the card's name and power limit first, one line per shape, and a
JSON object as the last line (also written to --out, by default
`build/kernel_ab.json`). Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import conditioned_system, cuda_ms, device_ms, random_system, rel_diff

#: (kind, B, K, w, system, reps per turn): K1 at the ladder's B=4 and, at
#: the flywheel's horizon, also B=1; K2 at B=1, as the paths call them.
SHAPES = [
    ("factor", 4, 101, 13, "random", 50),
    ("factor", 1, 5001, 4, "random", 5),
    ("factor", 4, 5001, 4, "random", 5),
    ("factor", 4, 2001, 37, "conditioned", 3),
    ("solve", 1, 101, 13, "random", 50),
    ("solve", 1, 5001, 4, "random", 5),
    ("solve", 1, 2001, 37, "conditioned", 5),
]
REL_TOL = 1e-10


def _bind_baseline(path: Path):
    from sleipnir_tpu_torch.ops import cuda_build

    [(lib_path, log)] = cuda_build.build([cuda_build.Source(path)], verbose=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    #: Whether the factor takes the inertia pass's scratch S (7 pointers).
    lib.scratch = "double* X, double* S" in path.read_text()
    lib.sleipnir_banded_factor.argtypes = [ptr] * (7 if lib.scratch else 6) + [i32] * 3 + [ptr]
    lib.sleipnir_banded_factor.restype = i32
    lib.sleipnir_banded_solve.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.sleipnir_banded_solve.restype = i32
    return lib, log


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def baseline_factor(lib, D, E):
    from sleipnir_tpu_torch.ops.block_tridiag import BlockTridiagFactor

    B, K, w, _ = D.shape
    LU = torch.empty_like(D)
    perm = torch.empty((B, K, w), dtype=torch.int32, device=D.device)
    d = torch.empty((B, K, w), dtype=torch.float64, device=D.device)
    X = torch.empty_like(E)
    scratch = (_p(torch.empty_like(D)),) if lib.scratch else ()
    err = lib.sleipnir_banded_factor(_p(D), _p(E), _p(LU), _p(perm), _p(d), _p(X), *scratch,
                                     B, K, w, _stream())
    if err:
        raise RuntimeError(f"baseline factor: CUDA error {err}")
    return BlockTridiagFactor(LU=LU, perm=perm, d=d, X=X)


def baseline_solve(lib, fac, b):
    B, K, w = b.shape[:3]
    x = torch.empty_like(b)
    err = lib.sleipnir_banded_solve(_p(fac.LU), _p(fac.perm), _p(fac.X), _p(b), _p(x), B, K, w, 1,
                                    _stream())
    if err:
        raise RuntimeError(f"baseline solve: CUDA error {err}")
    return x


def dd_ab(baseline_dir: Path) -> tuple[list, bool]:
    """The probe and its one-hot product through the baseline wrapper and
    build, and the current ones, in turns. Returns (rows, ok)."""
    from sleipnir_tpu_torch.ops import cuda_build, cuda_dd_probe
    from sleipnir_tpu_torch.ops import dd as plain_dd
    from sleipnir_tpu_torch.tools import dd_probe

    spec = importlib.util.spec_from_file_location(
        "baseline_cuda_dd_probe", baseline_dir / "cuda_dd_probe.py"
    )
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    old.SOURCE = cuda_build.Source(baseline_dir / "dd_probe.cu", cuda_dd_probe.SOURCE.flags)
    logs = cuda_build.build([cuda_dd_probe.SOURCE, old.SOURCE], verbose=True)
    for name, (_lib, log) in zip(("current", "baseline"), logs):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    x = dd_probe.probe_inputs(torch.device("cuda"))
    plain = dd_probe.run_probe(x, dd_probe.plain_primitive, plain_dd.onehot_product)
    old_out = dd_probe.run_probe(x, old.primitive, old.onehot_product)
    new_out, _single = dd_probe.run_fused(x)
    torch.cuda.synchronize()
    ok = dd_probe.bitwise_equal(old_out, plain) and dd_probe.bitwise_equal(new_out, plain)
    cases = {
        "probe": {"baseline": lambda: dd_probe.run_probe(x, old.primitive, old.onehot_product),
                  "current": lambda: cuda_dd_probe.probe(x["ah"], x["al"], x["bh"], x["bl"],
                                                         x["P"], x["Mh"])},
        "onehot_product": {"baseline": lambda: old.onehot_product(x["P"], x["Mh"]),
                           "current": lambda: cuda_dd_probe.onehot_product(x["P"], x["Mh"])},
    }
    rows = []
    for name, runs in cases.items():
        turns = {"baseline": [], "current": []}
        device = {"baseline": [], "current": []}
        for who in ("baseline", "current", "current", "baseline"):
            turns[who].append(cuda_ms(runs[who]))
            device[who].append(device_ms(runs[who]))
        row = {
            "kind": name, "turns_ms": turns, "device_turns_ms": device,
            "baseline_ms": sum(turns["baseline"]) / 2, "ms": sum(turns["current"]) / 2,
            "baseline_device_ms": sum(device["baseline"]) / 2,
            "device_ms": sum(device["current"]) / 2,
            "matmul_ms": cuda_ms(lambda: torch.matmul(x["P"], x["Mh"])),
            "matmul_device_ms": device_ms(lambda: torch.matmul(x["P"], x["Mh"])),
            "bitwise_equal_to_plain": ok,
        }
        row["speedup"] = row["baseline_ms"] / row["ms"]
        rows.append(row)
        print(f"{name}: baseline {row['baseline_ms']:.4f} ms {turns['baseline']} (device "
              f"{row['baseline_device_ms']:.4f}), current {row['ms']:.4f} ms {turns['current']} "
              f"(device {row['device_ms']:.4f}), x{row['speedup']:.2f}; torch.matmul "
              f"{row['matmul_ms']:.4f} ms (device {row['matmul_device_ms']:.4f}); both builds "
              f"bitwise equal to the plain version: {ok}", flush=True)
    if not ok:
        print("FAIL: a probe build differs from the plain version", file=sys.stderr)
    return rows, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="baseline banded.cu")
    ap.add_argument("--dd-baseline", type=Path,
                    help="directory with a baseline dd_probe.cu and cuda_dd_probe.py")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_ab.json"))
    args = ap.parse_args(argv)
    if (args.baseline is None) == (args.dd_baseline is None):
        ap.error("give exactly one of --baseline and --dd-baseline")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    if args.dd_baseline is not None:
        rows, ok = dd_ab(args.dd_baseline)
        result = {"card": card, "dd_probe": rows, "ok": ok}
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
        print(json.dumps(result), flush=True)
        return 0 if ok else 1

    from sleipnir_tpu_torch.ops import block_tridiag as plain
    from sleipnir_tpu_torch.ops import cuda_banded, cuda_build
    from sleipnir_tpu_torch.optimization.solver.kkt_banded import EPS_INERTIA

    [(_lib, log)] = cuda_build.build([cuda_banded.SOURCE], verbose=True)
    old, old_log = _bind_baseline(args.baseline)
    for name, text in (("current", log), ("baseline", old_log)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    systems = {"random": lambda rng, B, K, w: random_system(rng, B, K, w, 0),
               "conditioned": conditioned_system}
    rows, ok = [], True
    for kind, B, K, w, system, reps in SHAPES:
        D, E, b = systems[system](np.random.default_rng(B * K + w), B, K, w)
        Dg, Eg, bg = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (D, E, b))
        fn = cuda_banded.banded_factor(Dg, Eg)
        fo = baseline_factor(old, Dg, Eg)
        fp = plain.block_tridiag_factor(Dg, Eg)
        xp = plain.block_tridiag_solve(fp, bg)
        if kind == "factor":
            xn, xo = plain.block_tridiag_solve(fn, bg), plain.block_tridiag_solve(fo, bg)
            runs = {"baseline": lambda: baseline_factor(old, Dg, Eg),
                    "current": lambda: cuda_banded.banded_factor(Dg, Eg)}
        else:
            xn, xo = cuda_banded.banded_solve(fp, bg), baseline_solve(old, fp, bg)
            runs = {"baseline": lambda: baseline_solve(old, fp, bg),
                    "current": lambda: cuda_banded.banded_solve(fp, bg)}
        torch.cuda.synchronize()
        inertia = [[t.tolist() for t in plain.block_tridiag_inertia(f, EPS_INERTIA)]
                   for f in (fn, fo, fp)]
        row = {
            "kind": kind, "B": B, "K": K, "w": w, "system": system,
            "perm_equal": torch.equal(fn.perm, fp.perm) and torch.equal(fo.perm, fp.perm),
            "inertia_equal": inertia[0] == inertia[2] == inertia[1],
            "rel_err": rel_diff(xn, xp), "baseline_rel_err": rel_diff(xo, xp),
            "factor_bitwise_equal": all(torch.equal(a, c) for a, c in zip(fn, fo)),
            "solution_bitwise_equal": torch.equal(xn, xo),
        }
        turns = {"baseline": [], "current": []}
        for who in ("baseline", "current", "current", "baseline"):
            turns[who].append(cuda_ms(runs[who], reps))
        row["turns_ms"] = turns
        row["baseline_ms"] = sum(turns["baseline"]) / 2
        row["ms"] = sum(turns["current"]) / 2
        row["speedup"] = row["baseline_ms"] / row["ms"]
        row["baseline_us_per_stage"] = 1e3 * row["baseline_ms"] / K
        row["us_per_stage"] = 1e3 * row["ms"] / K
        rows.append(row)
        print(f"{kind} (B={B}, K={K}, w={w}, {system}): baseline {row['baseline_ms']:.4f} ms "
              f"{turns['baseline']}, current {row['ms']:.4f} ms {turns['current']}, "
              f"x{row['speedup']:.2f}; {row['us_per_stage']:.3f} us/stage; pivots equal "
              f"{row['perm_equal']}, inertia equal {row['inertia_equal']}, rel diff "
              f"{row['rel_err']:.3e} (baseline {row['baseline_rel_err']:.3e}), bitwise equal: "
              f"factor {row['factor_bitwise_equal']}, solution {row['solution_bitwise_equal']}",
              flush=True)
        if not (row["perm_equal"] and row["inertia_equal"] and row["rel_err"] <= REL_TOL):
            print(f"FAIL: {kind} {(B, K, w)} disagrees with the plain version", file=sys.stderr)
            ok = False
        del Dg, Eg, bg, fn, fo, fp, xp, xn, xo, runs
        torch.cuda.empty_cache()
    result = {"card": card, "shapes": rows, "ok": ok}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
