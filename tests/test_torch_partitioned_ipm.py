"""The interior-point method on the banded backend with the partitioned
factor forced on the CPU (the card takes it from K = 256 stages): the
flywheel OCP of tests/solver/test_partitioned.py:67-110 at N=80 (K=81
stages, above PART_MIN_BLOCKS), against the port's sequential-chain solve
and the JAX package's partitioned solve."""

import numpy as np
import torch

import jax.numpy as jnp

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as slp
from sleipnir_tpu.optimization.solver import kkt_banded as jkb
from sleipnir_tpu_torch.ops import block_tridiag as tbt
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.optimization.solver import kkt_banded

torch.set_num_threads(1)

N = 80


def _build(pkg):
    def flywheel(x, u):
        return (-x[0, 0] / 5.0 + 2.0 * u[0, 0]).reshape(1, 1)

    ocp = pkg.OCP(1, 1, 0.05, N, flywheel, pkg.DynamicsType.EXPLICIT_ODE,
                  pkg.TimestepMethod.FIXED, pkg.TranscriptionMethod.DIRECT_TRANSCRIPTION)
    ocp.constrain_initial_state(np.array([[0.0]]))
    ocp.subject_to(ocp.U() >= -12.0)
    ocp.subject_to(ocp.U() <= 12.0)
    ocp.minimize(((ocp.X() - 10.0) ** 2).sum())
    return ocp


def _forced(module, monkeypatch):
    orig = module.BandedBackend.__init__

    def patched(self, *a, **kw):
        orig(self, *a, **kw)
        self.use_partitioned = True

    monkeypatch.setattr(module.BandedBackend, "__init__", patched)


def test_ipm_with_partitioned_factor_matches_scan_and_jax(monkeypatch):
    scan = _build(slp)
    assert scan.solve(device="cpu") == slp.ExitStatus.SUCCESS
    scan_iterations = scan.last_solve_stats.iterations

    _forced(kkt_banded, monkeypatch)
    part = _build(slp)
    cuda_banded.reset_counters()
    assert part.solve(device="cpu") == slp.ExitStatus.SUCCESS
    [cached] = [v for k, v in part._solver_cache.items() if k[0] == "ipm"]
    backend = cached[-1]
    assert backend.use_partitioned and backend.mesh is None
    # Every ladder and every solve went through the partitioned form.
    K, w = N + 1, backend.w
    assert cuda_banded.PARTITIONED_BY_SHAPE[("factor", 4, K, w)] > 0
    assert cuda_banded.PARTITIONED_BY_SHAPE[("solve", 1, K, w)] > 0
    P, L = tbt.choose_partitions(K)
    assert not any(k[2] == K for k in cuda_banded.PLAIN_BY_SHAPE)
    assert cuda_banded.PLAIN_BY_SHAPE[("factor", 4 * P, L - 1, w)] > 0
    assert abs(part.last_solve_stats.iterations - scan_iterations) <= 2
    np.testing.assert_allclose(part.X().value(), scan.X().value(), atol=1e-6)

    _forced(jkb, monkeypatch)
    ref = _build(jslp)
    assert ref._make_kkt_backend(ref._compile(), jslp.Options(), jnp.float64).use_partitioned
    assert ref.solve() == jslp.ExitStatus.SUCCESS
    np.testing.assert_allclose(part.X().value(), ref.X().value(), atol=1e-6)
    np.testing.assert_allclose(part.U().value(), ref.U().value(), atol=1e-5)
