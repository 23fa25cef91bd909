"""Cart-pole at N=20 under SLEIPNIR_TPU_BCR in both packages (JAX:
SUCCESS, 22 iterations), held as tests/test_torch_factor_variants.py
holds the flywheel: the JAX package's status, iterations within ±2, the
solution within 1e-6, host syncs per iteration equal to the default
path's, and K1/K2 (their twin here) only on the coarsest two blocks."""

import torch

from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem
from tests.test_torch_factor_variants import (
    VARIABLES,
    check_default,
    check_variant,
    jax_solve,
    port_solve,
)

torch.set_num_threads(1)

N = 20


def test_cart_pole_bcr_matches_jax(monkeypatch):
    for name in VARIABLES.values():
        monkeypatch.delenv(name, raising=False)
    default = port_solve(*cart_pole_problem(N=N))
    check_default(default, 22)
    monkeypatch.setenv("SLEIPNIR_TPU_BCR", "1")
    jax = jax_solve(*jax_cart_pole(N=N))
    port = port_solve(*cart_pole_problem(N=N))
    check_variant("bcr", port, jax, default)
