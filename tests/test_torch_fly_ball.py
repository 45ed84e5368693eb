"""The ball-coxa fly stand-in (assets/fly_standin_ball.xml: limited ball
joints beside elliptic claw contacts, the shape of the fly's ``_ball``
variant), the port's array solve paths against the JAX package, float64
on the CPU.

- The generator's XML and a fresh freeze of both files (CG 4/4 as
  fly_freejnt.yaml loads it, and the Newton copy) against the committed
  ones; the sizes (nq 49, nv 42, njnt 25).
- The rows: the dense jacobian ``constraint.dense_J`` ([scalar limits;
  ball limits; contacts]) and efc_D / aref / pos / margin against the JAX
  ``make_constraint`` and ``dense_J`` at seeded states, at 1e-12.
- ``_solve_xla`` (CG, with ``spd_inverse`` as its M^-1) and
  ``_solve_newton`` (exact Hessian with the cones' 3 x 3 blocks) at seeded
  contact states against the JAX package's, qacc and efc_force at rtol
  1e-10 of their scale; the solution leaves active contacts in every zone
  of the cone (bottom, middle, top) and active ball limits. Both solve with
  LS_ITERS line-search steps (the files frozen so into a temporary
  directory): at the configs' 4, the line search's absolute freeze
  tolerance lies below phi''s float64 noise at the fly's scale and the two
  packages land apart on some states, as on the fly stand-in (ROADMAP C).
- One ``FlyFreeJoint`` control step (fly_freejnt.yaml's env args on the
  ball stand-in, its stac export's clip) against the JAX env at the fly
  env tests' tolerance, with their 50 line-search steps (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.solver as jS
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.assets import make_fly_standin
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

N = 12
ROWS_ATOL = 1e-12
SOLVE_REL = 1e-10
LS_ITERS = 50
FILES = {"cg": (tspec.FLY_STANDIN_BALL_NPZ, dict(solver="cg", iterations=4, ls_iterations=4)),
         "newton": (tspec.FLY_STANDIN_BALL_NEWTON_NPZ, tspec.FLY_BALL_NEWTON_OPTIONS)}
SOLVERS = pytest.mark.parametrize("solver", ["cg", "newton"])


def _states(jm, seed=0, n=N):
    """Seeded states: the root lowered 0.01 cm into the floor, the leg
    joints perturbed (the ball joints past their limit in some envs) and
    fast joints (contacts in every cone zone)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float64)[None], (n, 1))
    qpos[:, 2] -= 0.01
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, jm.nq - 7))
    return qpos, rng.uniform(-3.0, 3.0, (n, jm.nv)), rng.uniform(-0.3, 0.3, (n, jm.nu))


def _jax_data(jm, qpos, qvel, ctrl):
    n = qpos.shape[0]
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), jstep.make_data(jm))
    return jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def _jax_to_constraint(jm, d):
    """The JAX package's ``forward`` up to the solve (its stages, in its
    order, for a model off the kernel layout)."""
    from brax_tracking_tpu.ops import cholesky as jchol
    from brax_tracking_tpu.physics import actuation as jA
    from brax_tracking_tpu.physics import collision as jC
    from brax_tracking_tpu.physics import dynamics as jD
    from brax_tracking_tpu.physics import passive as jP

    d = jC.collision(jm, jstep.fwd_position_smooth(jm, d))
    d = jD.crb(jm, d)
    newton = jm.opt.solver == TM.SOLVER_NEWTON
    if not newton:
        d = jD.invert_m(jm, d)
    d = jA.fwd_actuation(jm, jD.rne(jm, jP.passive(jm, jstep.fwd_velocity_smooth(jm, d))))
    qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
    a0 = jchol.spd_solve(d.qM, qfrc_smooth) if newton else jD.solve_m(jm, d, qfrc_smooth)
    return jCn.make_constraint(jm, d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=a0))


def _port_data(tm, qpos, qvel, ctrl):
    return tstep.make_data(tm, qpos.shape[0], device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))


@pytest.fixture(scope="module", params=["cg", "newton"])
def solved(request, tmp_path_factory):
    """Both packages at seeded states up to the constraint rows, and the
    solve of each (LS_ITERS line-search steps)."""
    solver = request.param
    options = dict(FILES[solver][1], ls_iterations=LS_ITERS)
    jm = jspec.build_model(tspec.FLY_STANDIN_BALL_XML, free_jnt=True, dtype=jnp.float64,
                           **options)
    npz = str(tmp_path_factory.mktemp("ball") / f"{solver}.npz")
    tspec.freeze_mjcf(tspec.FLY_STANDIN_BALL_XML, npz, free_jnt=True, **options)
    tm = tspec.load_model(npz, device="cpu")
    args = _states(jm)
    layout = jCn.efc_layout(jm)
    meta = jS._cone_meta(jm, layout)

    def jax_side(d):
        d = _jax_to_constraint(jm, d)
        solve = jS._solve_newton if solver == "newton" else jS._solve_xla
        return d, solve(jm, d, layout, meta), jCn.dense_J(jm, d)

    jd, jsol, jJ = jax.jit(jax.vmap(jax_side))(_jax_data(jm, *args))
    td = tstep.forward_to_constraint(tm, _port_data(tm, *args))
    tsol = (tS._solve_newton if solver == "newton" else tS._solve_xla)(tm, td)
    return solver, jm, tm, jd, jsol, jJ, td, tsol


def test_generator_and_fresh_freeze(tmp_path):
    with open(tspec.FLY_STANDIN_BALL_XML) as f:
        assert f.read() == make_fly_standin.fly_standin_xml(ball=True)
    for npz, options in FILES.values():
        fresh = str(tmp_path / "fresh.npz")
        tspec.freeze_mjcf(tspec.FLY_STANDIN_BALL_XML, fresh, free_jnt=True, **options)
        with np.load(npz) as a, np.load(fresh) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m = tspec.load_model(tspec.FLY_STANDIN_BALL_NPZ, device="cpu")
    assert (m.nq, m.nv, m.njnt, m.nu, m.nbody, m.ncon) == (49, 42, 25, 36, 68, 12)
    assert int(np.sum(np.asarray(m.jnt_type) == TM.JNT_BALL)) == 6
    layout = tCn.efc_layout(m)
    assert (layout.limit_jnt.size, layout.limit_ball_jnt.size, layout.nefc) == (18, 6, 60)
    assert m.opt.cone == TM.CONE_ELLIPTIC and not tS.quad_kernel_eligible(m)


@SOLVERS
def test_stac_export_fits_the_model(solver):
    from brax_tracking_tpu_torch.data import clips as tclips

    m = tspec.load_model(FILES[solver][0], device="cpu")
    q = tclips.load_stac_qpos(tspec.FLY_STANDIN_BALL_STAC, m.nq)
    assert q.shape == (250, 49) and np.isfinite(q).all()


def test_rows_match_jax(solved):
    _, jm, tm, jd, _, jJ, td, _ = solved
    np.testing.assert_allclose(tCn.dense_J(tm, td).numpy(), np.asarray(jJ), atol=ROWS_ATOL,
                               rtol=0)
    for k in ("efc_D", "efc_aref", "efc_pos", "efc_margin", "efc_jsign"):
        ref = np.asarray(getattr(jd, k))
        np.testing.assert_allclose(getattr(td, k).numpy(), ref, atol=ROWS_ATOL * max(
            1.0, np.abs(ref).max()), rtol=0, err_msg=k)
    # the dense block is [ball limits; contact rows] after the 18 scalar limits
    assert td.efc_Jc.shape == (N, 42, 42)


def test_solves_match_jax(solved):
    solver, jm, tm, _, jsol, _, td, tsol = solved
    for k in ("qacc", "efc_force", "qfrc_constraint"):
        ref = np.asarray(getattr(jsol, k))
        err = np.abs(getattr(tsol, k).numpy() - ref).max()
        assert err <= SOLVE_REL * np.abs(ref).max(), (solver, k, err)
    if solver == "cg":
        # the array CG path's M^-1 is the SPD inverse (its kernel on the card)
        assert td.qMinv is not None


def test_solution_hits_every_cone_zone_and_ball_limit(solved):
    _, _, tm, _, _, _, td, tsol = solved
    rows = tS._array_inputs(tm, td)
    jar = tCn.jac_mul(tm, td, tsol.qacc) - td.efc_aref
    _, _, _, bottom, middle = tS._cone_terms(rows, jar)
    top = rows.g & ~bottom & ~middle
    assert int(bottom.sum()) > 0 and int(middle.sum()) > 0 and int(top.sum()) > 0
    ball = tCn.efc_layout(tm).limit_ball_rows
    assert bool(((td.efc_pos < td.efc_margin)[:, ball]).any())


def _kernel_to_constraint(jm, d):
    """The JAX ``forward`` up to the rows, on the kernel layout."""
    from brax_tracking_tpu.physics import collision as jC
    from brax_tracking_tpu.physics import dynamics as jD

    d = jD.crb(jm, jC.collision(jm, jstep.fwd_position_smooth(jm, d)))
    return jCn.make_constraint(jm, jstep.fwd_velocity_smooth(jm, d))


def test_dense_J_on_the_kernel_layout_matches_jax():
    """dense_J builds the contact rows the kernel path never materializes
    (the elliptic minirat)."""
    jm = jspec.build_model(tspec.MINIRAT_ELLIPTIC_XML, solver="cg", iterations=4,
                           ls_iterations=4, dtype=jnp.float64)
    tm = tspec.load_model(tspec.MINIRAT_ELLIPTIC_NPZ, device="cpu")
    assert tS.quad_kernel_eligible(tm)
    rng = np.random.RandomState(2)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (4, 1))
    qpos[:, 2] -= 0.03
    qpos[:, 7:] += rng.uniform(-0.5, 0.5, (4, jm.nq - 7))
    args = (qpos, rng.uniform(-1, 1, (4, jm.nv)), np.zeros((4, jm.nu)))
    jJ = jax.jit(jax.vmap(lambda d: jCn.dense_J(jm, _kernel_to_constraint(jm, d))))(
        _jax_data(jm, *args))
    td = tstep.forward_to_constraint(tm, _port_data(tm, *args))
    assert td.efc_Jc is None
    J = tCn.dense_J(tm, td).numpy()
    assert np.abs(J).max() > 0
    np.testing.assert_allclose(J, np.asarray(jJ), atol=ROWS_ATOL, rtol=0)


def test_fly_freejoint_env_step_matches_jax(tmp_path):
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import fly as jfly
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.harness import config as hc

    ls = LS_ITERS
    env_args = hc.load_config(["dataset=fly_freejnt"])["dataset"]["env_args"]
    npz = str(tmp_path / "ball.npz")
    tspec.freeze_mjcf(tspec.FLY_STANDIN_BALL_XML, npz, free_jnt=True, ls_iterations=ls)
    env_args = dict(env_args, mjcf_path=npz, ls_iterations=ls)
    jm = jspec.build_model(tspec.FLY_STANDIN_BALL_XML, free_jnt=True, solver="cg", iterations=4,
                           ls_iterations=ls, dtype=jnp.float64)
    tm = tspec.load_model(npz, device="cpu", free_jnt=True)
    eager = jclips.process_clip
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclips, "process_clip",
                   lambda m, q, **k: jax.jit(lambda x: eager(m, x, **k))(q))
        jc = jclips.process_clip_to_train(tspec.FLY_STANDIN_BALL_STAC, jm, clip_length=32)
    tc = tclips.process_clip_to_train(tspec.FLY_STANDIN_BALL_STAC, tm, clip_length=32)
    jenv = jfly.FlyFreeJoint(reference_clip=jc, **dict(
        env_args, mjcf_path=tspec.FLY_STANDIN_BALL_XML, dtype=jnp.float64))
    tenv = registry.get_environment("fly_single_clip_freejnt", reference_clip=tc, device="cpu",
                                    **env_args)
    js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), 2))
    ts = tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                         torch.as_tensor(np.array(js.pipeline_state.qpos)),
                         torch.as_tensor(np.array(js.pipeline_state.qvel)))
    a = np.random.RandomState(1).uniform(-1.0, 1.0, (2, tenv.action_size))
    js = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(a))
    ts = tenv.step(ts, torch.as_tensor(a))
    for k in ("obs", "reward"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   atol=1e-10, rtol=1e-9, err_msg=k)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    assert bool(np.asarray(js.pipeline_state.efc_force).any())
