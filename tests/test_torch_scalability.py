"""The port's scalability sweep (`sleipnir_tpu_torch.tools.scalability`)
at small horizons on the CPU: it writes the reference schema of
benchmarks/scalability.py, the file reads back, and a size that does not
reach SUCCESS is reported but left out of the file."""

import math

import pytest
import torch

from sleipnir_tpu_torch.optimization.solver.exit_status import ExitStatus
from sleipnir_tpu_torch.tools import scalability

torch.set_num_threads(1)


def test_flywheel_sweep_writes_the_reference_schema(tmp_path, capsys):
    out = tmp_path / "flywheel-scalability-results-cpu.csv"
    samples = scalability.main(["flywheel", "--samples", "10", "20", "--device", "cpu",
                                "--out", str(out)])
    assert [s.status for s in samples] == [ExitStatus.SUCCESS] * 2
    # The JAX package's flywheel takes 10 and 12 iterations at these sizes.
    assert [s.iterations for s in samples] == [10, 12]
    assert out.read_text().splitlines()[0] == "Samples,Setup time (ms),Solve time (ms)"
    rows = scalability.read_csv(out)
    assert [n for n, _, _ in rows] == [10, 20]
    assert all(setup > 0 and solve > 0 for _, setup, solve in rows)
    printed = capsys.readouterr().out
    assert "flywheel N=10 on cpu: success, 10 iterations, host syncs/iteration" in printed
    assert "peak device memory not measured (CPU)" in printed


def test_failed_sizes_stay_out_of_the_file(tmp_path):
    out = tmp_path / "sweep.csv"
    ok = scalability.Sample(100, ExitStatus.SUCCESS, 20, 7.0, 1000.0, 50.0, None)
    failed = scalability.Sample(200, ExitStatus.LOCALLY_INFEASIBLE, 118, 8.0, 2000.0, math.nan,
                                None)
    scalability.write_csv(out, [ok, failed])
    assert scalability.read_csv(out) == [(100, 1000.0, 50.0)]
    assert "locally infeasible, 118 iterations" in scalability.describe("cart_pole", failed, "cpu")
    (tmp_path / "other.csv").write_text("N,ms\n1,2\n")
    with pytest.raises(ValueError, match="header"):
        scalability.read_csv(tmp_path / "other.csv")
