"""The JAX package's own driver tests run against the port:
tests/autodiff/test_{gradient,hessian,jacobian}.py and
tests/solver/test_bounds.py. Each file's source is loaded with
`sleipnir_tpu` swapped for `sleipnir_tpu_torch` in its import lines (the
files themselves are not copied or edited), and each of its test
functions is one case here. The port's default device is the card; the
cases set it to the CPU for this test process only."""

import dataclasses
import pathlib
import re
import types

import pytest
import torch

from sleipnir_tpu_torch.autodiff import drivers
from sleipnir_tpu_torch.optimization.solver.options import Options

torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).parent
FILES = [
    "autodiff/test_gradient.py",
    "autodiff/test_hessian.py",
    "autodiff/test_jacobian.py",
    "solver/test_bounds.py",
]
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)sleipnir_tpu\b", re.MULTILINE)


def load_swapped(rel: str) -> types.ModuleType:
    """A test file of the JAX package, imports swapped to the port."""
    path = TESTS / rel
    module = types.ModuleType("ported_" + rel.replace("/", "_")[:-3])
    module.__file__ = str(path)
    source = _IMPORT.sub(r"\1sleipnir_tpu_torch", path.read_text())
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


MODULES = {rel: load_swapped(rel) for rel in FILES}
CASES = [
    (rel, name)
    for rel, module in MODULES.items()
    for name in sorted(vars(module))
    if name.startswith("test_") and callable(getattr(module, name))
]


def use_cpu(monkeypatch) -> None:
    """Make the CPU the default device of the drivers and of `Options`
    until the test ends."""
    for cls in (drivers.Gradient, drivers.Jacobian, drivers.Hessian):
        monkeypatch.setitem(cls.__init__.__kwdefaults__, "device", "cpu")
    defaults = tuple(
        "cpu" if f.name == "device" else f.default
        for f in dataclasses.fields(Options)
        if f.default is not dataclasses.MISSING
    )
    monkeypatch.setattr(Options.__init__, "__defaults__", defaults)
    monkeypatch.setattr(Options, "device", "cpu")


@pytest.fixture
def on_cpu(monkeypatch):
    use_cpu(monkeypatch)


@pytest.mark.parametrize("rel,name", CASES, ids=[f"{rel}::{name}" for rel, name in CASES])
def test_reference_case(on_cpu, rel, name):
    getattr(MODULES[rel], name)()
