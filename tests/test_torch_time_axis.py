"""The port's time-axis split (`sleipnir_tpu_torch/parallel/time_axis.py`)
against the JAX package's (`sleipnir_tpu/parallel/time_axis.py`): the
port's meshes repeat the CPU 2, 4 and 8 times, the JAX package's run on
the 8 host devices tests/conftest.py forces. Systems and the flywheel OCP
are those of tests/parallel/test_time_axis.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import sleipnir_tpu as jslp
import sleipnir_tpu_torch as slp
from sleipnir_tpu.parallel import time_axis as jta
from sleipnir_tpu_torch.ops import cuda_banded
from sleipnir_tpu_torch.parallel import time_axis as ta

torch.set_num_threads(1)

K, W = 101, 9


def _system(K, w, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((K, w, w))
    D = D + np.swapaxes(D, 1, 2) + 10 * np.eye(w)
    D[::3] -= 18 * np.eye(w)
    E = rng.standard_normal((K - 1, w, w))
    return D, E, rng.standard_normal((K, w))


def _dense(D, E):
    K, w, _ = D.shape
    M = np.zeros((K * w, K * w))
    for k in range(K):
        M[k * w:(k + 1) * w, k * w:(k + 1) * w] = D[k]
        if k + 1 < K:
            M[(k + 1) * w:(k + 2) * w, k * w:(k + 1) * w] = E[k]
            M[k * w:(k + 1) * w, (k + 1) * w:(k + 2) * w] = E[k].T
    return M


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def system():
    D, E, b = _system(K, W)
    M = _dense(D, E)
    ev = np.linalg.eigvalsh(M)
    return D, E, b, np.linalg.solve(M, b.reshape(-1)), (int((ev > 0).sum()), int((ev < 0).sum()))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_solve_matches_jax_and_dense(system, n_dev):
    D, E, b, xd, (n_pos, n_neg) = system
    mesh = ta.Mesh.of(["cpu"] * n_dev)
    Dp, Ep, bp, K0 = ta.pad_to_devices(*(torch.tensor(a)[None] for a in (D, E, b)), n_dev)
    assert K0 == K and Dp.shape[1] % n_dev == 0
    x = ta.sharded_block_tridiag_solve(mesh, "t", Dp, Ep, bp)[0, :K].numpy()

    jmesh = JaxMesh(np.array(jax.devices()[:n_dev]), ("t",))
    jD, jE, jb, _ = jta.pad_to_devices(jnp.asarray(D), jnp.asarray(E), jnp.asarray(b), n_dev)

    @jax.jit
    def jax_split(D_, E_, b_):
        jfac = jta.sharded_factor(jmesh, "t", D_, E_, k_orig=K)
        return jta.sharded_solve(jmesh, "t", jfac, b_), jta.sharded_inertia(jfac, 1e-12)

    xj, jinertia = jax_split(jD, jE, jb)
    xj = np.asarray(xj)[:K]
    assert _rel(x, xj) < 1e-10
    assert _rel(x.reshape(-1), xd) < 1e-10

    # The factor/solve split with its inertia, against eigvalsh and the
    # JAX package's sharded_inertia.
    fac = ta.sharded_factor(mesh, "t", Dp, Ep)
    assert _rel(ta.sharded_solve(mesh, "t", fac, torch.tensor(b)[None])[0].numpy(), xj) < 1e-10
    pos, neg, zero = (t.item() for t in ta.sharded_inertia(fac, 1e-12, K))
    assert (pos, neg, zero) == tuple(int(t) for t in jinertia) == (n_pos, n_neg, 0)


def test_shards_hold_their_chunks_and_batch():
    """A batch of two systems over four shards: every tuple of the factor
    has one entry per shard, each with the batch axis first, and each
    system's solution is its own."""
    B, Kb, w, n = 2, 64, 5, 4
    systems = [_system(Kb, w, seed=s) for s in (1, 2)]
    D, E, b = (torch.tensor(np.stack(a)) for a in zip(*systems))
    mesh = ta.Mesh.of(["cpu"] * n)
    Dp, Ep, _b, _K = ta.pad_to_devices(D, E, None, n)
    fac = ta.sharded_factor(mesh, "t", Dp, Ep)
    assert all(len(t) == n for t in fac)
    assert fac.cols[0].shape == (B, Kb // n - 1, w, 2 * w)
    x = ta.sharded_solve(mesh, "t", fac, b).numpy()
    for i, (Di, Ei, bi) in enumerate(systems):
        assert _rel(x[i].reshape(-1), np.linalg.solve(_dense(Di, Ei), bi.reshape(-1))) < 1e-10
    with pytest.raises(ValueError):
        ta.sharded_factor(mesh, "batch", Dp, Ep)


def _flywheel(pkg, N=40):
    def flywheel(x, u):
        return (-x[0, 0] / 5.0 + 2.0 * u[0, 0]).reshape(1, 1)

    ocp = pkg.OCP(1, 1, 0.05, N, flywheel, pkg.DynamicsType.EXPLICIT_ODE,
                  pkg.TimestepMethod.FIXED, pkg.TranscriptionMethod.DIRECT_TRANSCRIPTION)
    ocp.constrain_initial_state(np.array([[0.0]]))
    ocp.subject_to(ocp.U() >= -12.0)
    ocp.subject_to(ocp.U() <= 12.0)
    ocp.minimize(((ocp.X() - 10.0) ** 2).sum())
    return ocp


def test_ipm_through_time_axis_mesh():
    """`set_time_axis_mesh` on the flywheel at N=40 over 4 shards: SUCCESS,
    every factor and solve through the split, and X as the unsharded
    port's and the JAX package's sharded solve give it."""
    ref = _flywheel(slp)
    assert ref.solve(device="cpu") == slp.ExitStatus.SUCCESS

    sharded = _flywheel(slp)
    mesh = ta.Mesh.of(["cpu"] * 4)
    sharded.set_time_axis_mesh(mesh, "t")
    cuda_banded.reset_counters()
    assert sharded.solve(device="cpu") == slp.ExitStatus.SUCCESS
    [cached] = [v for k, v in sharded._solver_cache.items() if k[0] == "ipm"]
    assert cached[-1].mesh is mesh and not cached[-1].use_partitioned
    # K=41 pads to 44: four chunks of 11 stages, interiors of 10.
    shapes = {k[:3] for k in cuda_banded.PLAIN_BY_SHAPE}
    assert ("factor", 4, 10) in shapes and ("factor", 4, 4) in shapes
    assert not any(k[2] == 41 for k in cuda_banded.PLAIN_BY_SHAPE)
    np.testing.assert_allclose(sharded.X().value(), ref.X().value(), atol=1e-6)

    jsharded = _flywheel(jslp)
    jsharded.set_time_axis_mesh(JaxMesh(np.array(jax.devices()[:4]), ("t",)), "t")
    assert jsharded.solve() == jslp.ExitStatus.SUCCESS
    np.testing.assert_allclose(sharded.X().value(), jsharded.X().value(), atol=1e-6)

    sharded.set_time_axis_mesh(None)
    assert not sharded._solver_cache and sharded._time_mesh is None
