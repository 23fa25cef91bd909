"""The readings that the limits of `reference/<config>.py` are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 10 --control-seconds 40 [--out PATH]

In one process, on the card and at the cell's own size: set-up as a run
makes it, then for each seed of `--seeds` a short window of the cell's
traffic through the program as the configuration states it (float64), and
for each of `--control-seeds` one through the program's float32 path
(`Options.dtype = "float32"`), the control, at the tolerance float32 can
reach (CONTROL_TOLERANCE) and capped at CONTROL_ITERATIONS, and one
through the program in float64 at LOOSE_FACTOR times the configuration's
tolerance ("loose"), a solve stopped early. Each window is judged as a
run judges it; the largest of each number over the window's solves is one
reading. Beside each float64 window it judges the same answers rounded to
float32 ("rounded"), the best a float32 program could return. A limit
lies above every float64 reading and below the smallest of the others
that reads three times that or more. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: The float32 control's tolerance (the JAX package's float32 tests solve
#: to 1e-2; 1e-4 is as far as float32 gets on these problems) and its
#: iteration cap: an answer it returns at the cap is still judged.
CONTROL_TOLERANCE = 1e-4
CONTROL_ITERATIONS = 300
#: The "loose" witness solves to this many times the stated tolerance.
LOOSE_FACTOR = 100.0


def readings(harness, reference, cfg, program, records, seed, elapsed) -> dict:
    attempted, failed, checks = harness.judge(reference, cfg, program, records)
    return {"seed": seed, "requests": len(records), "attempted": attempted, "failed": failed,
            "seconds": elapsed, **{k: c["value"] for k, c in checks.items()}}


def rounded(records: list) -> list:
    """The same answers rounded to float32: the best a float32 program
    could return, a second witness beside the control."""
    return [(req, dataclasses.replace(served, xs=[np.float32(x).astype(np.float64)
                                                  for x in served.xs]), t)
            for req, served, t in records]


def main(argv=None, device: str = "cuda", cfg_override: dict | None = None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--control-seconds", type=float, default=40.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch  # noqa: PLC0415

    torch.set_num_threads(1)

    from perfbench import generator, harness  # noqa: PLC0415

    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(2)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    sizes, build_path, reference_path = harness.config_files(cell["config"])
    cfg = {**json.loads(sizes.read_text()), **(cfg_override or {})}
    mix = json.loads(harness.traffic_file(cell["traffic"]).read_text())
    reference = harness.load_module(reference_path)
    build_module = harness.load_module(build_path)
    if device.startswith("cuda"):
        from sleipnir_tpu_torch.ops import cuda_banded, cuda_build  # noqa: PLC0415

        cuda_build.build([cuda_banded.SOURCE])
    out = []
    for label, seeds, seconds, kwargs in (
        ("program", args.seeds, args.seconds, {}),
        ("control", args.control_seeds, args.control_seconds,
         {"dtype": "float32", "tolerance": CONTROL_TOLERANCE, "max_iterations": CONTROL_ITERATIONS}),
        ("loose", args.control_seeds, args.seconds, {"tolerance": LOOSE_FACTOR * cfg["tolerance"]}),
    ):
        program = harness.Program(build_module, cfg, mix["entry"], device, **kwargs)
        program.serve(generator.Traffic(mix, program.start, 0, generator.WARM_UP).next())
        for seed in (int(s) for s in seeds.split(",")):
            records: list = []
            traffic = generator.Traffic(mix, program.start, seed)
            elapsed = harness.drive(program, traffic, seconds, device, records)
            sides = [(label, records)] + ([("rounded", rounded(records))] if label == "program" else [])
            for side, recs in sides:
                r = {"side": side, **readings(harness, reference, cfg, program, recs, seed, elapsed)}
                print(json.dumps(r), flush=True)
                out.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
