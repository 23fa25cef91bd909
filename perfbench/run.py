"""The benchmark of sleipnir_tpu_torch: one run of one cell on one H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with a CUDA card. The run
builds the port's CUDA library (or takes it from `build/` in the
checkout), builds the cell's problem and warms up its shapes, serves the
cell's traffic back to back for `--seconds` (ending on a request's
boundary), and judges every answer against the plain reference. Its last
line on standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones, read from the window's counters and from a profiled
stretch at its end),
`device`, with a trace `breakdown`, and last `checks`, each number
compared beside its limit. Without a card it exits with code 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache a run fills lives at a fixed path inside the checkout, so
    # that only a checkout's first run builds.
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    # One host thread for torch's and NumPy's CPU work: the port's host
    # control is one thread, and idle pool threads spinning beside it slow
    # it and spread its times.
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; there are {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch  # noqa: PLC0415

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import sleipnir_tpu_torch  # noqa: PLC0415

    if not Path(sleipnir_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"sleipnir_tpu_torch comes from {sleipnir_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)

    from perfbench import harness  # noqa: PLC0415

    code, result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                                    "cuda", T_START)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
