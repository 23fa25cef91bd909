"""The benchmark's files: every name in BENCHMARK.json finds its file, a
new cell is added by files alone, and no module of the benchmark imports
JAX or the JAX package (the reference nothing of the port either).

Run: python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from perfbench import generator, harness

PERFBENCH = Path(harness.__file__).resolve().parent
BENCH = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imported_top_levels(path: Path) -> set[str]:
    """The top-level names (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    for path in harness.config_files(entry["config"]):
        assert path.is_file(), path
    mix = json.loads(harness.traffic_file(entry["traffic"]).read_text())
    assert generator.Traffic(mix, np.zeros(5), 1).next() is not None
    for traced in (False, True):
        metrics = harness.cell_metrics(BENCH, cell, traced)
        assert metrics, (cell, traced)
        for m in metrics:
            assert hasattr(harness.load_module(harness.metric_file(m["name"])), "read")
    reference = harness.load_module(harness.config_files(entry["config"])[2])
    assert callable(reference.judge) and reference.LIMITS


def test_a_new_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    copy = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "traffic" / "burst4.json").write_text(json.dumps({
        "entry": "multistart", "lanes": 4, "guess": {"from": "seed", "scale": 0.02, "levels": 4},
    }))
    (copy / "metrics" / "lanes_per_call.py").write_text(
        "def read(run):\n    return run.solves / run.requests\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cartpole-n100-burst4", "config": "cartpole-n100",
                               "traffic": "burst4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "lanes_per_call.burst", "unit": "lanes", "better": "higher",
                               "source": "program_counter", "layer": "solver step",
                               "moves": "lane_solves_per_s",
                               "workloads": ["cartpole-n100-burst4"]})
    monkeypatch.setattr(harness, "PERFBENCH", copy)
    mix = json.loads(harness.traffic_file("burst4").read_text())
    req = generator.Traffic(mix, np.zeros(7), 3).next()
    assert len(req.guesses) == 4 and req.guesses[0].tolist() == [0.0] * 7
    metrics = harness.cell_metrics(bench, "cartpole-n100-burst4", traced=True)
    assert [m["name"] for m in metrics] == ["lanes_per_call.burst"]
    reader = harness.load_module(harness.metric_file("lanes_per_call.burst"))
    run = harness.Run(requests=2, solves=8, steps=90, syncs=600, elapsed_s=3.0, setup_s=20.0)
    assert reader.read(run) == 4.0


def test_the_same_seed_draws_the_same_requests():
    start = np.linspace(0.0, 1.0, 11)
    for mix_name in ("resolve", "multistart8"):
        mix = json.loads(harness.traffic_file(mix_name).read_text())
        a, b = generator.Traffic(mix, start, 2**33 + 5), generator.Traffic(mix, start, 2**33 + 5)
        for _ in range(3):
            ra, rb = a.next(), b.next()
            assert len(ra.guesses) == len(rb.guesses)
            for ga, gb in zip(ra.guesses, rb.guesses):
                assert ga.tolist() == gb.tolist()


def test_a_built_guess_is_the_configuration_s_own():
    mix = json.loads(harness.traffic_file("resolve").read_text())
    start = np.linspace(0.0, 1.0, 11)
    traffic = generator.Traffic(mix, start, 7)
    for _ in range(2):
        assert [g.tolist() for g in traffic.next().guesses] == [start.tolist()]


def test_no_module_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "sleipnir_tpu"}
    for path in PERFBENCH.rglob("*.py"):
        assert not imported_top_levels(path) & banned, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PERFBENCH / "reference").glob("*.py"):
        assert imported_top_levels(path) <= {"__future__", "math", "numpy"}, path


def test_the_benchmark_file_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[group]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in e2e.values())
    for cell in BENCH["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        reported = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        for m in harness.cell_metrics(BENCH, cell["name"], True):
            assert m["moves"] in reported, (cell["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
