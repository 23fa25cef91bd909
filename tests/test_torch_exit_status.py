"""Exit statuses of the port's solvers against the JAX package's, on the
problems of the JAX package's tests/solver/test_exit_status.py: each
problem solved through both packages must end with the same ExitStatus.
The locally infeasible cases run feasibility restoration on the dense
backend (SQP and the interior-point method)."""

import numpy as np
import pytest
import torch

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as tslp

torch.set_num_threads(1)


def _build(slp, case):
    p = slp.Problem()
    if case == "too_few_dofs":  # test_exit_status.py:40
        x, y, z = p.decision_variable(), p.decision_variable(), p.decision_variable()
        p.subject_to(x == 1)
        p.subject_to(x == 2)
        p.subject_to(y == 1)
        p.subject_to(z == 1)
    elif case in ("locally_infeasible_equality", "locally_infeasible_inequality"):  # :57, :72
        x, y, z = p.decision_variable(), p.decision_variable(), p.decision_variable()
        rows = [(x, y), (y, z), (z, x)]
        for a, b in rows:
            p.subject_to(a == b + 1.0 if case.endswith("equality") else a >= b + 1.0)
    elif case.startswith("nonfinite_"):  # :87
        x = p.decision_variable()
        what = case[len("nonfinite_"):]
        if what == "cost":
            p.minimize(1.0 / x)
        elif what == "gradient":
            p.minimize(slp.sqrt(x))
        elif what == "equality":
            p.subject_to(1.0 / x == 1.0)
        elif what == "equality_jacobian":
            p.subject_to(slp.sqrt(x) == 1.0)
        elif what == "inequality":
            p.subject_to(1.0 / x > 1.0)
        else:
            p.subject_to(slp.sqrt(x) > 1.0)
    elif case == "diverging_iterates":  # :132
        x = p.decision_variable()
        p.minimize(x)
    elif case in ("max_iterations_exceeded", "timeout"):  # :142, :155
        x = p.decision_variable()
        x.set_value(1.0)
        p.minimize(x * x)
    elif case == "globally_infeasible_bounds":  # :164
        x = p.decision_variable()
        p.minimize(x * x)
        p.subject_to(x >= 2.0)
        p.subject_to(x <= 1.0)
    else:
        raise ValueError(case)
    return p


#: case -> (solve options, the status the JAX package's test asserts)
CASES = {
    "too_few_dofs": ({}, "TOO_FEW_DOFS"),
    "locally_infeasible_equality": ({}, "LOCALLY_INFEASIBLE"),
    "locally_infeasible_inequality": ({}, "LOCALLY_INFEASIBLE"),
    "nonfinite_cost": ({}, "NONFINITE_INITIAL_GUESS"),
    "nonfinite_gradient": ({}, "NONFINITE_INITIAL_GUESS"),
    "nonfinite_equality": ({}, "NONFINITE_INITIAL_GUESS"),
    "nonfinite_equality_jacobian": ({}, "NONFINITE_INITIAL_GUESS"),
    "nonfinite_inequality": ({}, "NONFINITE_INITIAL_GUESS"),
    "nonfinite_inequality_jacobian": ({}, "NONFINITE_INITIAL_GUESS"),
    "diverging_iterates": ({}, "DIVERGING_ITERATES"),
    "max_iterations_exceeded": ({"max_iterations": 0}, "MAX_ITERATIONS_EXCEEDED"),
    "timeout": ({"timeout": 0.0}, "TIMEOUT"),
    "globally_infeasible_bounds": ({}, "GLOBALLY_INFEASIBLE"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exit_status_matches_jax(case):
    kwargs, expected = CASES[case]
    jstatus = _build(jslp, case).solve(**kwargs)
    tstatus = _build(tslp, case).solve(device="cpu", **kwargs)
    assert int(tstatus) == int(jstatus)
    assert tstatus == tslp.ExitStatus[expected]


@pytest.mark.parametrize("case", ["locally_infeasible_equality", "locally_infeasible_inequality"])
def test_locally_infeasible_cases_restore_where_jax_does(case, monkeypatch):
    """Both packages enter feasibility restoration on these problems, as
    often, and it runs on the dense backend: SQP and the interior-point
    method hand the infeasible linear system to `restore` with no banded
    parent."""
    import sleipnir_tpu.optimization.problem as jproblem
    import sleipnir_tpu_torch.optimization.problem as tproblem

    entries = {"jax": [], "port": []}
    for who, module in (("jax", jproblem), ("port", tproblem)):
        inner = module.restore

        def counted(*args, _inner=inner, _who=who, **kwargs):
            entries[_who].append(kwargs.get("parent_backend"))
            return _inner(*args, **kwargs)

        monkeypatch.setattr(module, "restore", counted)
    jstatus = _build(jslp, case).solve()
    tp = _build(tslp, case)
    assert tp.solve(device="cpu") == tslp.ExitStatus.LOCALLY_INFEASIBLE
    assert int(jstatus) == int(tslp.ExitStatus.LOCALLY_INFEASIBLE)
    assert len(entries["port"]) == len(entries["jax"]) >= 1
    assert not any(
        type(b).__name__ == "BandedBackend" for b in entries["port"]
    )
    assert np.isfinite(tp._last_state.x.numpy()).all()
