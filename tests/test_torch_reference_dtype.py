"""The JAX package's dtype axis, tests/optimization/test_dtype_axis.py,
run against the port: Newton, SQP, the dense interior-point method and
the flywheel OCP on the banded backend, each in float64 and float32
(`Options.dtype`). The file's source is loaded with its imports swapped
to `sleipnir_tpu_torch` (it is not copied or edited), and its test
functions are collected here with their own parametrization. Solves run
on the CPU."""

import pytest
import torch

from tests.test_torch_reference_autodiff import load_swapped, use_cpu

torch.set_num_threads(1)

for _name, _fn in vars(load_swapped("optimization/test_dtype_axis.py")).items():
    if _name.startswith("test_") and callable(_fn):
        globals()[f"test_dtype_axis__{_name[len('test_'):]}"] = _fn


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    use_cpu(monkeypatch)
