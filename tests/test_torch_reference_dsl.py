"""The JAX package's own DSL and small-problem tests run against the port:
tests/autodiff/test_{expression,expression_type,slice,variable,
variable_matrix}.py and tests/optimization/test_{constraints,
decision_variable,trivial_problem,linear_problem,quadratic_problem,
nonlinear_problem,arm_on_elevator}.py. Each file's source is loaded with
its imports swapped to `sleipnir_tpu_torch` (the files are not copied or
edited) and its test functions are collected here under the file's
name, with their own parametrization. Solves run on the CPU."""

import pathlib

import pytest
import torch

from tests.test_torch_reference_autodiff import load_swapped, use_cpu

torch.set_num_threads(1)

FILES = [
    "autodiff/test_expression.py",
    "autodiff/test_expression_type.py",
    "autodiff/test_slice.py",
    "autodiff/test_variable.py",
    "autodiff/test_variable_matrix.py",
    "optimization/test_constraints.py",
    "optimization/test_decision_variable.py",
    "optimization/test_trivial_problem.py",
    "optimization/test_linear_problem.py",
    "optimization/test_quadratic_problem.py",
    "optimization/test_nonlinear_problem.py",
    "optimization/test_arm_on_elevator.py",
]

for _rel in FILES:
    _stem = pathlib.Path(_rel).stem[len("test_"):]
    for _name, _fn in vars(load_swapped(_rel)).items():
        if _name.startswith("test_") and callable(_fn):
            globals()[f"test_{_stem}__{_name[len('test_'):]}"] = _fn


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    use_cpu(monkeypatch)
