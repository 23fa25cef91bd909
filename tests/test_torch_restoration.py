"""The port's banded feasibility restoration against the JAX package's.

From the strongly infeasible cart-pole state of
tests/solver/test_banded_restoration.py (N=8, T=1 s, seed 7, scale 0.5):
the restoration subproblem's starting state and its first steps field by
field, and `restore` as a whole. Then the problem-level handler: a
cart-pole solve that enters restoration in the JAX package enters it in
the port too and ends with the same exit status."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sleipnir_tpu.optimization.problem as jax_problem_module
import sleipnir_tpu.optimization.solver.util.feasibility_restoration as jfr
import sleipnir_tpu_torch as tslp
import sleipnir_tpu_torch.optimization.problem as torch_problem_module
import sleipnir_tpu_torch.optimization.solver.util.feasibility_restoration as tfr
from sleipnir_tpu.models.cart_pole import cart_pole_problem as jax_cart_pole
from sleipnir_tpu.optimization.solver.exit_status import ExitStatus as JaxExitStatus
from sleipnir_tpu.optimization.solver.funcs import ScalingArrays as JaxScaling
from sleipnir_tpu.optimization.solver.options import Options as JaxOptions
from sleipnir_tpu_torch.interop import ipm_state_from_numpy
from sleipnir_tpu_torch.models.cart_pole import cart_pole_problem as torch_cart_pole
from sleipnir_tpu_torch.optimization.solver.funcs import ScalingArrays

torch.set_num_threads(1)

N, TOTAL_TIME, SEED, SCALE = 8, 1.0, 7, 0.5


def _x0(n):
    return SCALE * np.random.default_rng(SEED).standard_normal(n)


def _jax_violated():
    problem, _, _ = jax_cart_pole(N=N, total_time=TOTAL_TIME)
    options = JaxOptions()
    comp, bundle = problem.prepare_ipm(options)
    init, funcs, backend = bundle[0], bundle[3], bundle[-1]
    params = comp["compiled"].gather_params()
    x0 = _x0(comp["n"])
    scaling, _ = problem.compute_ipm_scaling(comp, bundle, x0, params)
    sc = JaxScaling(*(jnp.asarray(a) for a in (scaling.f, scaling.c_e, scaling.c_i)))
    state = init(x0, np.ones(comp["mi"]), np.zeros(comp["me"]), np.ones(comp["mi"]),
                 0.1 * scaling.f, 0, params, sc)
    return {"problem": problem, "funcs": funcs, "backend": backend, "state": state,
            "options": options}


def _torch_violated():
    problem, _, _ = torch_cart_pole(N=N, total_time=TOTAL_TIME)
    options = tslp.Options(device="cpu")
    comp = problem._compile()
    init, _step, _resume, funcs, g_fn, backend = problem._prepare_ipm(
        comp, options, torch.device("cpu")
    )
    params = comp["compiled"].gather_params()
    x0 = _x0(comp["n"])
    scaling, _, _ = problem._ipm_scaling(g_fn, backend, x0, params)
    sc = ScalingArrays(f=scaling.f, c_e=scaling.c_e, c_i=scaling.c_i)
    state = init(x0, np.ones(comp["mi"]), np.zeros(comp["me"]), np.ones(comp["mi"]),
                 0.1 * scaling.f, 0, params, sc)
    return {"funcs": funcs, "backend": backend, "state": state, "options": options}


@pytest.fixture(scope="module")
def violated():
    """Both packages at the same violated cart-pole iterate. The JAX
    problem is built once for the whole file: its compiled solver, and the
    restoration solver cached on its backend, serve every test."""
    return _jax_violated(), _torch_violated()


def _to_numpy(value):
    """A copy of a state (or array) in numpy, field by field."""
    if hasattr(value, "_asdict"):
        return {k: _to_numpy(v) for k, v in value._asdict().items()}
    if isinstance(value, torch.Tensor):
        return np.array(value.detach().cpu().numpy())
    return np.array(value)


def _recording(module, seen):
    """A restoration module's run_solver that records the restoration
    solver's starting state, step and (JAX) compiled runner, then runs."""
    inner = module.run_solver

    def record(state, step, options, **kwargs):
        seen.update(state=state, start=_to_numpy(state), step=step, runner=kwargs.get("runner"))
        return inner(state, step, options, **kwargs)

    return record


@pytest.fixture(scope="module")
def restored(violated):
    """`restore` run once in each package from the violated iterate, with
    the restoration solver's start recorded: (seen, outcome) per package."""
    j, t = violated
    jseen, tseen = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfr, "run_solver", _recording(jfr, jseen))
        mp.setattr(tfr, "run_solver", _recording(tfr, tseen))
        jout = jfr.restore(j["funcs"], j["state"], j["options"], parent_backend=j["backend"])
        tout = tfr.restore(t["funcs"], t["state"], t["options"], parent_backend=t["backend"])
    return (jseen, jout), (tseen, tout)


#: Magnitude below which fields compare absolutely: the subproblem's
#: starting equality residual cₑ(x) − pₑ + nₑ cancels to rounding noise.
FLOOR = 1e-3


def _assert_states_close(port, ref, rtol, path="state"):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in port and k != "params":
                _assert_states_close(port[k], v, rtol, f"{path}.{k}")
        return
    a, b = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.size:
        err = np.abs(a - b).max() / max(np.abs(b).max(), FLOOR)
        assert err <= rtol, (path, err)


def _viol(c_e, c_i):
    return np.sum(np.abs(c_e)) + np.sum(np.abs(np.minimum(c_i, 0.0)))


def _jax_viol(j, x):
    st = j["state"]
    xj = jnp.asarray(x)
    return _viol(np.asarray(j["funcs"].c_e(xj, st.params, st.scaling)),
                 np.asarray(j["funcs"].c_i(xj, st.params, st.scaling)))


def _torch_viol(t, x):
    st = t["state"]
    xt = torch.as_tensor(x)
    return _viol(t["funcs"].c_e(xt, st.params, st.scaling).numpy(),
                 t["funcs"].c_i(xt, st.params, st.scaling).numpy())


def test_restoration_step_matches_jax(violated, restored):
    _, t = violated
    (jseen, _), (tseen, _) = restored

    # The restoration subproblem starts from the same state (stage width
    # 37 = 13 parent slots + 24 relaxation slots).
    assert t["backend"].w == 13
    assert tseen["state"].derivs.Hd.shape[-1] + tseen["state"].derivs.Aloc.shape[1] == 37
    _assert_states_close(tseen["start"], jseen["start"], 1e-12)

    # In restoration mode the port's step agrees with the JAX fr_step to
    # 1e-9 per field from the same state (γ_min = 0, the early-stop check).
    # The JAX step runs through its compiled runner, capped at one
    # iteration, so it compiles nothing of its own.
    jstate = jseen["state"]
    port_params = tseen["start"]["params"]
    for _ in range(2):
        start = _to_numpy(jstate)
        start["params"] = port_params
        jstate = jseen["runner"](jstate, np.int32(int(jstate.iterations) + 1))
        port = tseen["step"](ipm_state_from_numpy(start, "cpu"))
        assert port.status == int(jstate.status)
        assert port.iterations == int(jstate.iterations)
        _assert_states_close(_to_numpy(port), _to_numpy(jstate), 1e-9)
        assert float(port.gamma) == float(jstate.gamma) == 0.0


def test_restore_matches_jax(violated, restored):
    j, t = violated
    (_, jout), (_, tout) = restored
    v0 = _jax_viol(j, np.asarray(j["state"].x))
    assert v0 > 1e-2
    assert _torch_viol(t, t["state"].x.numpy()) == pytest.approx(v0, rel=1e-12)
    assert tout[0] == jout[0] == "resume"
    assert _jax_viol(j, jout[1]) < 0.95 * v0
    assert _torch_viol(t, tout[1]) < 0.95 * v0
    assert abs(tout[-1] - jout[-1]) <= 2
    assert tout[3].shape == (t["state"].c_e.shape[0],)
    assert np.all(tout[2] > 0.0)


def test_dense_restoration_raises(violated, restored):
    """Without a banded parent, restoration no longer raises: it runs on
    the dense backend over [x; pₑ; nₑ; pᵢ; nᵢ] and hands back the iterate
    as the banded restoration of the same iterate does ("resume", below
    0.95 of the start's violation). The banded subproblem adds padded
    slots, so the two solves differ and their iterations are held within
    a few."""
    _, t = violated
    (_, _), (_, tout) = restored
    dense = tfr.restore(t["funcs"], t["state"], t["options"])
    v0 = _torch_viol(t, t["state"].x.numpy())
    assert dense[0] == tout[0] == "resume"
    assert _torch_viol(t, dense[1]) < 0.95 * v0
    assert abs(dense[-1] - tout[-1]) <= 3
    assert dense[3].shape == (t["state"].c_e.shape[0],)
    assert np.all(dense[2] > 0.0)


def test_solve_enters_restoration_where_jax_does(violated, monkeypatch):
    """Cart-pole over a 1 s horizon at N=8 asks for restoration in both
    packages, and both end with the same status. The JAX solve is the
    file's problem, so it reuses the solvers compiled for it."""
    entries = {"jax": 0, "port": 0}

    def counting(name, inner):
        def restore(*args, **kwargs):
            entries[name] += 1
            return inner(*args, **kwargs)

        return restore

    monkeypatch.setattr(jax_problem_module, "restore", counting("jax", jax_problem_module.restore))
    monkeypatch.setattr(torch_problem_module, "restore", counting("port", torch_problem_module.restore))
    jp = violated[0]["problem"]
    tp, _, _ = torch_cart_pole(N=N, total_time=TOTAL_TIME)
    jstatus = jp.solve()
    tstatus = tp.solve(device="cpu")
    print(f"JAX {jstatus} after {int(jp._last_state.iterations)} iterations, "
          f"{entries['jax']} restorations; port {tstatus} after "
          f"{tp.last_solve_stats.iterations}, {entries['port']}")
    assert entries["jax"] >= 1
    assert entries["port"] >= 1
    assert int(tstatus) == int(jstatus)
