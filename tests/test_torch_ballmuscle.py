"""The port's engine on ballmuscle against the JAX package, float64 on the
CPU: ball joints and their limits, a fixed tendon, muscles and a
filterexact actuator, under (i) the model's own CG options (50 iterations,
25 line-search iterations, tolerance 1e-12; the XLA-CG path with the
``spd_inverse2`` kernel's plain version) and (ii) the same with Newton (the
``spd_solve`` kernel's plain version).

States are the posed recipe of tests/test_physics_ball_muscle.py (shoulder
near its ball limit), seeds 0..7, through ``jax.vmap`` of the JAX step and
the port's batched step, with parameters carried across by
``model_from_numpy``.

Tolerances, relative to the field's largest entry over the batch:
- 1e-12 on kinematics, the tendon and the constraint geometry (same
  formulas, rounding only);
- 1e-10 on forces, qM, its inverses (a sweep here, a Cholesky solve in the
  JAX package's CPU path), the constraint rows, qacc_smooth and the Newton
  solve;
- 1e-8 on the CG solve. CG stops when one iteration improves the cost by
  less than tolerance * meaninertia * nv = 4.8e-13; with this model's small
  inertias that can leave qacc ~1e-9 of its scale from the optimum, and
  where exactly depends on rounding: on these states the JAX package's own
  vmapped CG stops 2.0e-6 (of ~1750) from its unbatched CG on one env,
  while the port agrees with Newton to 3e-12.
Each of 30 substeps started from the JAX package's state (so one-step
differences do not compound): Newton at 1e-10; CG per env against the
nearer of the JAX package's vmapped and unbatched step (its two evaluation
orders), qpos and act at 1e-8, qvel and qacc at 1e-12 on at least 28
substeps (where both stop at the same iteration) and on every substep no
further than the JAX package's two evaluations are from each other. That
spread is above 1e-8 on these states (1.4e-7 in qvel), so 1e-8 on every
substep cannot hold for CG, in either package (ROADMAP §C).
The free-running 30-substep trajectories carry that through: Newton at
1e-10, CG at qvel 1e-5 and qpos 1e-7 absolute (qvel ~19, qpos ~1.5; the
JAX package's vmapped and unbatched CG steps differ by up to 2.6e-6 in
qvel on these states, the port and the vmapped JAX step by 9.5e-7), act
at 1e-12 (the activation does not depend on the solve).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.solver as jS
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from test_physics_ball_muscle import posed

B = 8
SOLVERS = ("cg", "newton")

GEOMETRY = (
    "xpos", "xquat", "xipos", "xanchor", "xaxis", "subtree_com", "cinert_s",
    "cinert_h", "cdof", "ten_length", "ten_J", "cvel", "cdof_dot", "efc_jsign",
    "efc_pos", "efc_margin", "efc_Jc",
)
FORCES = (
    "crb_f", "qM", "qfrc_bias", "qfrc_passive", "qfrc_actuator",
    "actuator_force", "act_dot", "qfrc_smooth", "efc_D", "efc_aref",
    "qacc_smooth",
)
SOLVE = ("qacc", "efc_force", "qfrc_constraint")
SOLVE_RTOL = {"cg": 1e-8, "newton": 1e-10}


def _close(port, ref, rtol, name):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max() if ref.size else 0.0
    assert err <= rtol * max(np.abs(ref).max() if ref.size else 0.0, 1e-300), (name, err)


@pytest.fixture(scope="module")
def models():
    out = {}
    for solver in SOLVERS:
        jm, mj = jspec.build_model(
            "builtin:ballmuscle.xml", solver=solver, dtype=jnp.float64,
            return_mj=True, **tspec.BALLMUSCLE_OPTIONS,
        )
        out[solver] = (jm, mj, tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu"))
    return out


@pytest.fixture(scope="module")
def states(models):
    _, mj, _ = models["cg"]
    poses = [posed(mj, s) for s in range(B)]
    return {k: np.stack([getattr(p, k) for p in poses]) for k in ("qpos", "qvel", "ctrl", "act")}


def _jax_data(jm, st):
    d0 = jstep.make_data(jm)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    return dB.replace(**{k: jnp.asarray(v) for k, v in st.items()})


def _port_data(tm, st):
    d = tstep.make_data(tm, B, device="cpu")
    return d.replace(**{k: torch.as_tensor(v) for k, v in st.items()})


@pytest.fixture(scope="module")
def runs(models, states):
    """Per solver: the JAX step (compiled once; its output holds forward's
    fields at the start state), the JAX first step and the port's forward."""
    out = {}
    for solver, (jm, _, tm) in models.items():
        jax_step = jax.jit(jax.vmap(lambda dd, jm=jm: jstep.step(jm, dd)))
        out[solver] = (jax_step, jax_step(_jax_data(jm, states)), tstep.forward(tm, _port_data(tm, states)))
    return out


@pytest.mark.parametrize("solver", SOLVERS)
def test_committed_npz_matches_fresh_freeze(solver, tmp_path):
    try:
        importlib.import_module("mujoco")
    except ImportError:
        pytest.skip("the mujoco bindings are needed to freeze an MJCF")
    fresh = tspec.freeze_mjcf(
        tspec.BALLMUSCLE_XML, str(tmp_path / "bm.npz"), solver=solver, **tspec.BALLMUSCLE_OPTIONS
    )
    with np.load(tspec.BALLMUSCLE_NPZ[solver]) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


@pytest.mark.parametrize("solver", SOLVERS)
def test_model_from_jax_equals_loaded(models, solver):
    jm, _, carried = models[solver]
    loaded = tspec.load_model(tspec.BALLMUSCLE_NPZ[solver], device="cpu", solver=solver)
    a, b = tspec.model_to_numpy(carried), tspec.model_to_numpy(loaded)
    for k in TM.field_keys():
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (loaded.nq, loaded.nv, loaded.nu, loaded.na, loaded.ntendon) == (9, 7, 4, 3, 1)
    assert loaded.has_damping and loaded.ncon == 0
    # off the kernel layout (ball limits), under both solvers, in both packages
    assert not tS.quad_kernel_eligible(loaded) and not jS.quad_kernel_eligible(jm)


def test_xml_copy_matches_jax_asset():
    import os

    jax_xml = os.path.join(os.path.dirname(os.path.dirname(jspec.__file__)), "assets", "ballmuscle.xml")
    with open(jax_xml) as a, open(tspec.BALLMUSCLE_XML) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("solver", SOLVERS)
def test_forward_stages(runs, solver):
    _, jf, tf = runs[solver]
    assert bool(np.asarray(jf.efc_pos < jf.efc_margin).any())  # a ball limit is active
    for names, rtol in ((GEOMETRY, 1e-12), (FORCES, 1e-10), (SOLVE, SOLVE_RTOL[solver])):
        for name in names:
            _close(getattr(tf, name).numpy(), getattr(jf, name), rtol, name)
    if solver == "cg":
        # the XLA-CG path's inverses, from one spd_inverse2 call
        for name in ("qMinv", "qMhinv"):
            _close(getattr(tf, name).numpy(), getattr(jf, name), 1e-10, name)
        assert tf.solver_niter is None
    else:
        assert tf.qMinv is None and tf.solver_niter is not None
    assert tf.qvel_next is None  # the kernel path's Euler update is not used


def test_newton_iteration_counts(models, runs):
    """The port's per-env Newton iteration counts (the batch loop runs the
    largest, and each runs one spd_solve launch) against the JAX package's
    own count on the same solve: within one per env. Newton lands on the
    optimum in 1-2 steps here, and the gradient test (|grad| < 4.8e-13)
    then sits at rounding level, so one confirming iteration comes and
    goes with the summation order."""
    jm, _, _ = models["newton"]
    _, jf, tf = runs["newton"]
    layout = jCn.efc_layout(jm)
    meta = jS._cone_meta(jm, layout)
    count = jax.jit(jax.vmap(
        lambda dd: jS._solve_newton(jm, dd.replace(qacc_warmstart=None), layout, meta, count_only=True)
    ))(jf)
    assert np.abs(tf.solver_niter.numpy() - np.asarray(count)).max() <= 1
    assert int(tf.solver_niter.max()) >= 1


def test_cg_and_newton_agree(runs):
    """(i) and (ii) solve the same strictly convex problem to a 1e-12
    tolerance: the same qacc to 1e-6 of its scale."""
    qa, qb = runs["cg"][2].qacc.numpy(), runs["newton"][2].qacc.numpy()
    assert np.abs(qa - qb).max() <= 1e-6 * np.abs(qb).max()


def _rel_gap(port, ref):
    """Per env: max |port - ref| over the field's entries, relative to the
    field's largest entry over the batch."""
    ref = np.asarray(ref)
    return np.abs(np.asarray(port) - ref).reshape(B, -1).max(-1) / np.abs(ref).max()


@pytest.mark.parametrize("solver", SOLVERS)
def test_substeps_from_jax_state(models, states, runs, solver):
    """30 substeps, each of the port started from the JAX package's state
    (qpos, qvel, act, ctrl and its warmstart qacc), against the JAX step
    from that state: Newton vmapped at 1e-10; CG against the nearer of the
    vmapped and the unbatched JAX step, per env (module docstring)."""
    jm, _, tm = models[solver]
    jax_step = runs[solver][0]
    one_step = jax.jit(lambda dd: jstep.step(jm, dd))
    fields = ("qpos", "qvel", "act", "qacc")
    jd = _jax_data(jm, states)
    gaps, spread = [], dict.fromkeys(fields, 0.0)
    for k in range(30):
        td = _port_data(tm, {f: np.array(getattr(jd, f)) for f in ("qpos", "qvel", "act", "ctrl")})
        if k:
            td = td.replace(qacc_warmstart=torch.as_tensor(np.array(jd.qacc_warmstart)))
        jn = jax_step(jd)
        tn = tstep.step(tm, td, device="cpu")
        gap = {f: _rel_gap(getattr(tn, f).numpy(), getattr(jn, f)) for f in fields}
        if solver == "cg":
            un = [one_step(jax.tree.map(lambda x, i=i: x[i], jd)) for i in range(B)]
            for f in fields:
                u = np.stack([np.asarray(getattr(x, f)) for x in un])
                scale = np.abs(np.asarray(getattr(jn, f))).max()
                spread[f] = max(spread[f], float(np.abs(u - np.asarray(getattr(jn, f))).max() / scale))
                gap[f] = np.minimum(gap[f], np.abs(getattr(tn, f).numpy() - u).reshape(B, -1).max(-1) / scale)
        gaps.append({f: float(g.max()) for f, g in gap.items()})
        jd = jn
    worst = {f: max(g[f] for g in gaps) for f in fields}
    if solver == "newton":
        assert all(worst[f] <= 1e-10 for f in fields), worst
        return
    assert worst["qpos"] <= 1e-8 and worst["act"] <= 1e-8, worst
    for f in ("qvel", "qacc"):
        exact = sum(g[f] <= 1e-12 for g in gaps)
        assert exact >= 28, (f, [g[f] for g in gaps])
        assert worst[f] <= spread[f], (f, worst[f], spread[f])


@pytest.mark.parametrize("solver", SOLVERS)
def test_trajectory_30_substeps(models, states, runs, solver):
    jm, _, tm = models[solver]
    jax_step = runs[solver][0]
    atol = dict(
        cg=dict(qpos=1e-7, qvel=1e-5, act=1e-12),
        newton=dict(qpos=1e-10, qvel=1e-10, act=1e-12),
    )[solver]
    jd, td = _jax_data(jm, states), _port_data(tm, states)
    gaps = dict.fromkeys(atol, 0.0)
    for _ in range(30):
        jd = jax_step(jd)
        td = tstep.step(tm, td, device="cpu")
        for k in gaps:
            gaps[k] = max(gaps[k], float(np.abs(getattr(td, k).numpy() - np.asarray(getattr(jd, k))).max()))
    for k, tol in atol.items():
        assert gaps[k] <= tol, (k, gaps[k])
    assert np.abs(td.qpos.numpy() - states["qpos"]).max() > 1e-2  # the state really moved
    assert np.abs(td.act.numpy() - states["act"]).max() > 1e-2
