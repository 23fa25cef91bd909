"""Diagnostics, the profilers and spy in the port against the JAX package.

The JAX package's tests/optimization/test_problem_spy.py runs against the
port with its imports swapped (as tests/test_torch_reference_dsl.py runs
the others). The tables `solve(diagnostics=True)` prints are held against
the JAX package's for one Newton, one SQP and one interior-point problem:
the same lines, the same iteration rows with every column but the
duration equal to 1e-6 relative, and time traces with the same phases
and run counts."""

import re

import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp
from tests.test_torch_reference_autodiff import load_swapped, use_cpu

torch.set_num_threads(1)

for _name, _fn in vars(load_swapped("optimization/test_problem_spy.py")).items():
    if _name.startswith("test_") and callable(_fn):
        globals()[f"test_reference_{_name[len('test_'):]}"] = _fn


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    use_cpu(monkeypatch)


def _newton(slp):
    p = slp.Problem()
    x, y = p.decision_variable(), p.decision_variable()
    x.set_value(1.0)
    y.set_value(2.0)
    p.minimize(x**4 + (y - 1.0) ** 2 + x)
    return p


def _sqp(slp):
    p = slp.Problem()
    x, y = p.decision_variable(), p.decision_variable()
    x.set_value(1.0)
    y.set_value(2.0)
    p.maximize(x * y)
    p.subject_to(x + 3 * y == 36)
    return p


def _ipm(slp):
    p = slp.Problem()
    x, y = p.decision_variable(), p.decision_variable()
    x.set_value(2.0)
    y.set_value(3.0)
    p.minimize((x - 1.0) ** 2 + (y - 2.0) ** 2)
    p.subject_to(x + y == 4.0)
    p.subject_to(x >= 0.5)
    return p


#: Row tokens after splitting on whitespace (the iteration type is blank
#: for a normal iteration): iter, duration, error, cost, infeasibility,
#: complementarity, μ, δ, γ, |p_pr|, |p_du|, α_pr, α_du, backtracks.
_NUMERIC = {2, 3, 4, 5, 6, 9, 10, 11, 12}
_DURATION = 1
#: Time-trace rows: the phase name, its share and bar, then the setup
#: phase's duration, or the solve phase's total, average and run count.
_TRACE = re.compile(r"^│(.{21}) +[\d.]+%▕.*▏ +[\d.]+(?: +[\d.]+ +(\d+))?│$")


def _close(a: float, b: float) -> bool:
    # 1e-6 relative; a constraint satisfied to rounding prints its
    # cancellation noise (e.g. 5.9990e-10 against 5.9991e-10), so values
    # within 1e-12 of each other also agree.
    return abs(a - b) <= 1e-6 * max(abs(a), abs(b)) or abs(a - b) <= 1e-12


def _diagnostics(slp, build, capsys, **kwargs):
    status = build(slp).solve(diagnostics=True, **kwargs)
    return status, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("build", [_newton, _sqp, _ipm], ids=["newton", "sqp", "ipm"])
def test_tables_match_the_jax_package(build, capsys):
    j_status, j_lines = _diagnostics(jslp, build, capsys)
    t_status, t_lines = _diagnostics(tslp, build, capsys, device="cpu")
    assert int(t_status) == int(j_status) == int(tslp.ExitStatus.SUCCESS)
    assert len(t_lines) == len(j_lines)
    rows = traces = 0
    for j_line, t_line in zip(j_lines, t_lines):
        if j_line.startswith("│") and j_line[1:5].strip().isdigit():
            j_tok, t_tok = j_line.strip("│").split(), t_line.strip("│").split()
            assert len(t_tok) == len(j_tok) == 14, t_line
            for i, (a, b) in enumerate(zip(j_tok, t_tok)):
                if i in _NUMERIC:
                    assert _close(float(a), float(b)), (i, j_line, t_line)
                elif i != _DURATION:
                    assert a == b, (i, j_line, t_line)
            rows += 1
        elif _TRACE.match(j_line):
            # A time trace: the phase and its run count, not its times.
            (j_name, j_runs), (t_name, t_runs) = (
                _TRACE.match(j_line).groups(), _TRACE.match(t_line).groups()
            )
            assert (t_name, t_runs) == (j_name, j_runs)
            traces += 1
        else:
            assert t_line == j_line
    assert rows >= 3 and traces >= 3
