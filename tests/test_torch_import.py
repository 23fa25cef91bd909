"""The port imports no JAX."""

import subprocess
import sys


def test_port_imports_without_jax():
    code = (
        "import sys, sleipnir_tpu_torch, sleipnir_tpu_torch.interop, "
        "sleipnir_tpu_torch.models.cart_pole, sleipnir_tpu_torch.ops.cuda_banded; "
        "assert 'jax' not in sys.modules, 'jax was imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
