"""The fly's pieces (ROADMAP A.9) on the CPU in float64, against the JAX
package and MuJoCo C.

``assets/fly_standin.xml`` (written by ``assets/make_fly_standin.py``)
stands in for the fruit fly, whose MJCF is not in the repository. Here:

- the committed XML is what the generator writes, and the committed
  ``fly_standin.npz`` (free root) and ``fly_standin_tethered.npz`` (the free
  joint stripped) equal fresh freezes with the fly configs' options; they
  have the fly's sizes, the configs' names, 12 contact slots in one
  elliptic block, and both ``kernel_layout`` and the JAX package's
  ``quad_kernel_eligible`` send them to the solve kernel;
- both frozen files against the JAX package's ``build_model(...,
  free_jnt=...)``, and ``torque_actuators=True`` against its torque
  rewrite, every field at 1e-12;
- ``passive.fluid`` against the JAX fluid model at 1e-12 on seeded states,
  free and tethered, its gap to MuJoCo C's ``qfrc_fluid`` printed (both
  packages differ from MuJoCo there, the cause not established: ROADMAP
  C);
- a substep of each fly, the port's kernel path on the CPU (the solve
  kernel's plain version) against the JAX package's step with its Pallas
  kernel in interpret mode, each field at 1e-10 of its scale;
- the line search's finding at the configs' 4 steps (ROADMAP C), pinned.

The stac exports and the driver: tests/test_torch_fly_driver.py. The
envs' control steps against the JAX envs: tests/test_torch_fly_env.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.solver as jS
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.assets import make_fly_standin
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import collision as tC
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import kinematics as tK
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import passive as tP
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

mujoco = pytest.importorskip("mujoco")

B = 4
FLY_YAML_OPTIONS = dict(solver="cg", iterations=4, ls_iterations=4)
FILES = {True: tspec.FLY_STANDIN_NPZ, False: tspec.FLY_STANDIN_TETHERED_NPZ}
STACS = {True: tspec.FLY_STANDIN_STAC, False: tspec.FLY_STANDIN_TETHERED_STAC}
# the stand-in's sizes, free / tethered: nq, nv, nu, nbody, njnt, ngeom;
# contact slots and rows (36 limit rows, 12 elliptic contacts of 3 rows)
SIZES = {True: (43, 42, 36, 68, 37, 160), False: (36, 36, 36, 68, 36, 160)}
NCON, NEFC, NELL = 12, 72, 12
STAGE_ATOL = 1e-12
SUBSTEP_REL = 1e-10
PARAMS = pytest.mark.parametrize("free", [True, False], ids=["free", "tethered"])


def _jax_model(free, **kw):
    return jspec.build_model(tspec.FLY_STANDIN_XML, free_jnt=free, dtype=jnp.float64,
                             **{**FLY_YAML_OPTIONS, **kw})


def _states(m, free, seed=0, n=B, vel=1.0):
    """Seeded states: the hinges perturbed, fast joints (contacts in every
    cone zone), the free root's height lowered 0.01 cm (into the floor)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.qpos0, np.float64)[None], (n, 1))
    h = 7 if free else 0
    if free:
        qpos[:, 2] -= 0.01
    qpos[:, h:] += rng.uniform(-0.05, 0.05, (n, m.nq - h))
    return qpos, rng.uniform(-vel, vel, (n, m.nv)), rng.uniform(-0.3, 0.3, (n, m.nu))


def _jax_data(jm, qpos, qvel, ctrl):
    n = qpos.shape[0]
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), jstep.make_data(jm))
    return jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def _port_data(tm, qpos, qvel, ctrl):
    return tstep.make_data(tm, qpos.shape[0], device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))


def _jax_clip(stac, jm, **kw):
    """The JAX package's process_clip_to_train with its process_clip jitted
    (run eagerly, its batched kinematics take ~15 s here)."""
    from brax_tracking_tpu.data import clips as jclips

    eager = jclips.process_clip
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jclips, "process_clip",
                   lambda m, q, **k: jax.jit(lambda x: eager(m, x, **k))(q))
        return jclips.process_clip_to_train(stac, jm, **kw)


def _assert_fields_match(port, jax_):
    assert sorted(port) == sorted(jax_) == sorted(TM.field_keys())
    for k in TM.field_keys():
        if port[k].dtype.kind == "f":
            np.testing.assert_allclose(port[k], jax_[k], atol=STAGE_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)


# ---------------------------------------------------------------------------
# the fixture and its frozen files
# ---------------------------------------------------------------------------


def test_xml_is_the_generators():
    with open(tspec.FLY_STANDIN_XML) as f:
        assert f.read() == make_fly_standin.fly_standin_xml()


@PARAMS
def test_committed_npz_matches_fresh_freeze(tmp_path, free):
    fresh = tspec.freeze_mjcf(tspec.FLY_STANDIN_XML, str(tmp_path / "f.npz"), free_jnt=free,
                              **FLY_YAML_OPTIONS)
    with np.load(FILES[free]) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert bool(committed["frozen_free_jnt"]) == free
    m = tspec.load_model(FILES[free], device="cpu", free_jnt=free, **FLY_YAML_OPTIONS)
    assert (m.nq, m.nv, m.nu, m.nbody, m.njnt, m.ngeom) == SIZES[free]
    layout = tCn.efc_layout(m)
    assert (m.ncon, layout.nefc, int(tS._cone_meta(m, layout).ell_con.size)) == (NCON, NEFC, NELL)
    # frozen_path picks the file by free_jnt; the loader refuses the other
    assert tspec.frozen_path("builtin:fly_standin.xml", free) == FILES[free]
    with pytest.raises(ValueError, match="free_jnt"):
        tspec.load_model(FILES[free], device="cpu", free_jnt=not free)


def test_standin_is_a_fly():
    """The fly's sizes and kinds of features; the configs' names (the
    misspelt joint names missing); the collision filter; the pose; the
    solve kernel's one-warp layout 1 on both files, as the JAX package's
    rule sends them to its kernel."""
    from brax_tracking_tpu_torch.harness import config as hc

    args = hc.load_config(["dataset=fly"])["dataset"]["env_args"]
    mjm = mujoco.MjModel.from_xml_path(tspec.FLY_STANDIN_XML)
    assert 0.8e-3 < mjm.body_mass.sum() < 1.2e-3  # grams
    assert (mjm.opt.density, mjm.opt.viscosity, mjm.opt.noslip_iterations) == (0.00128, 0.000185,
                                                                                3)
    assert mjm.opt.cone == mujoco.mjtCone.mjCONE_ELLIPTIC and mjm.opt.gravity[2] == -981
    assert (mjm.actuator_gaintype == mujoco.mjtGain.mjGAIN_FIXED).all()
    assert (mjm.actuator_biastype == mujoco.mjtBias.mjBIAS_NONE).all()
    assert (np.asarray(mjm.geom_contype) | np.asarray(mjm.geom_conaffinity) == 0).sum() > 130
    assert mjm.nexclude == 33
    for free in (True, False):
        m = tspec.load_model(FILES[free], device="cpu")
        hinge = np.asarray(m.jnt_type) == TM.JNT_HINGE
        assert int(hinge.sum()) == 36 and np.asarray(m.jnt_limited)[hinge].all()
        assert m.has_fluid and not m.has_damping and m.nu == 36
        for kind, names in (("body", args["body_names"] + args["end_eff_names"]
                             + [args["center_of_mass"]]), ("joint", [])):
            assert [n for n in names if tspec.name2id(m, kind, n) < 0] == [], kind
        missing = [n for n in args["joint_names"] if tspec.name2id(m, "joint", n) < 0]
        assert missing == [n for n in args["joint_names"] if n.startswith(("oxa", "emur"))
                           or n in ("tarsus_T2_righ", "tarsus_T3_rig")] and len(missing) == 11
        # only the claws touch the floor: plane-capsule pairs, two slots each
        gt = np.asarray(m.geom_type)
        assert (gt[m.pairs.geom1] == TM.GEOM_PLANE).all()
        assert [m.names["geom"][g] for g in m.pairs.geom2] == [
            f"claw_{s}_{side}" for s, side in make_fly_standin.LEGS]
        layout = tCn.efc_layout(m)
        assert tS.quad_kernel_eligible(m) and jS.quad_kernel_eligible(_jax_model(free))
        nell = int(tS._cone_meta(m, layout).ell_con.size)
        roots = tS._fused_statics(m, layout)["root_bounds"]
        assert roots == ((0, m.nv),)  # one root: the free joint's, or the legs' alone
        kl, smem, warps = tcg.kernel_layout(m.nv, layout.nefc, nell, len(roots), m.ncon)
        assert (kl, warps) == (1, 1) and smem < tcg.WIDE_ABOVE_SMEM
        # at qpos0: the thorax inside healthy_z_range, every claw slot touching
        d = tC.collision(m, tK.kinematics(m, tstep.make_data(m, 1, device="cpu")))
        lo, hi = args["healthy_z_range"]
        assert lo < float(d.xpos[0, tspec.name2id(m, "body", "thorax"), 2]) < hi
        assert bool((d.contact_dist < 0).all())
    # the excludes remove real pairs: without them the tethered fly's thorax
    # (welded to the world) meets its coxae, femurs and tibiae, and the
    # coxae each other (33 pairs on top of the six claws)
    spec = mujoco.MjSpec.from_file(tspec.FLY_STANDIN_XML)
    tspec.strip_free_joint(spec)
    for ex in list(spec.excludes):
        spec.delete(ex)
    assert len(tspec._candidate_pairs(spec.compile())) == 6 + 33


# ---------------------------------------------------------------------------
# the spec transforms against the JAX package's
# ---------------------------------------------------------------------------


@PARAMS
def test_frozen_model_matches_jax(free):
    """The committed file (free root kept or stripped) against the JAX
    package's build_model of the same MJCF: every field at 1e-12."""
    port = tspec.model_to_numpy(tspec.load_model(FILES[free], device="cpu"))
    _assert_fields_match(port, tspec.model_to_numpy(_jax_model(free)))


def test_torque_actuators_match_jax(tmp_path):
    """torque_actuators=True (on no config's path) frozen and against the
    JAX package's torque rewrite: every field at 1e-12, each motor's gain
    its upper force limit, no bias."""
    fields = tspec.freeze_mjcf(tspec.FLY_STANDIN_XML, str(tmp_path / "t.npz"), free_jnt=False,
                               torque_actuators=True, **FLY_YAML_OPTIONS)
    port = tspec.model_to_numpy(tspec.model_from_numpy(fields, device="cpu"))
    _assert_fields_match(port, tspec.model_to_numpy(_jax_model(False, torque_actuators=True)))
    np.testing.assert_array_equal(port["actuator_gainprm"][:, 0], port["actuator_forcerange"][:, 1])
    assert (port["actuator_biastype"] == TM.BIAS_NONE).all()
    plain = tspec.model_to_numpy(tspec.load_model(FILES[False], device="cpu"))
    assert not np.array_equal(plain["actuator_gainprm"], port["actuator_gainprm"])


# ---------------------------------------------------------------------------
# the fluid model
# ---------------------------------------------------------------------------


@PARAMS
def test_fluid_matches_jax(free, capsys):
    """passive.fluid against the JAX fluid model on seeded states (fast
    joints, the free root tumbling) at 1e-12; the gap to MuJoCo C's
    qfrc_fluid printed (run with -s)."""
    from brax_tracking_tpu.physics import passive as jP

    jm, mjm = _jax_model(free, return_mj=True)
    tm = tspec.load_model(FILES[free], device="cpu")
    qpos, qvel, ctrl = _states(jm, free, seed=3, vel=5.0)
    jd = _jax_data(jm, qpos, qvel, ctrl)
    ref = np.asarray(jax.jit(jax.vmap(lambda d: jP.fluid(
        jm, jstep.fwd_velocity_smooth(jm, jstep.fwd_position_smooth(jm, d)))))(jd))
    d = tK.com_vel(tm, tK.com_pos(tm, tK.kinematics(tm, _port_data(tm, qpos, qvel, ctrl))))
    ours = tP.fluid(tm, d).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(ours, ref, atol=STAGE_ATOL, rtol=0)
    # passive() adds it to the springs
    np.testing.assert_allclose(tP.passive(tm, d).qfrc_passive.numpy(),
                               tP.spring_damper(tm, d).numpy() + ours, atol=STAGE_ATOL, rtol=0)
    mjd = mujoco.MjData(mjm)
    mj = []
    for b in range(B):
        mjd.qpos[:], mjd.qvel[:] = qpos[b], qvel[b]
        mujoco.mj_forward(mjm, mjd)
        mj.append(mjd.qfrc_fluid.copy())
    mj = np.stack(mj)
    with capsys.disabled():
        print(f"\nfluid ({'free' if free else 'tethered'}) against MuJoCo C's qfrc_fluid: max gap "
              f"{np.abs(ours - mj).max():.3e} of scale {np.abs(mj).max():.3e}")


# ---------------------------------------------------------------------------
# a substep on the solve kernel's path
# ---------------------------------------------------------------------------


@PARAMS
def test_substep_matches_jax_kernel(free, monkeypatch):
    """One substep of each fly: the port's kernel path on the CPU (the solve
    kernel's plain version, the elliptic block, one root) against the JAX
    package's step with its fused Pallas kernel in interpret mode (forced on
    the CPU by patching ``_use_pallas``). Each field at SUBSTEP_REL of its
    scale."""
    from brax_tracking_tpu.ops import cg as jcg
    from brax_tracking_tpu.ops import cholesky as jchol

    jm = _jax_model(free)
    tm = tspec.load_model(FILES[free], device="cpu")
    kernel = jcg.cg_solve_fused
    calls = []

    def interpreted(*a, **k):
        calls.append(k["ell0"])
        return kernel(*a, **{**k, "unroll_iters": False, "unroll_ls": False,
                             "interpret": True})

    monkeypatch.setattr(jchol, "_use_pallas", lambda x: True)
    monkeypatch.setattr(jcg, "cg_solve_fused", interpreted)
    qpos, qvel, ctrl = _states(jm, free, seed=5, n=2)
    js = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))(_jax_data(jm, qpos, qvel, ctrl))
    ts = tstep.step(tm, _port_data(tm, qpos, qvel, ctrl), device="cpu")
    assert calls == [36]  # the elliptic block after the 36 limit rows
    assert bool(np.asarray(js.efc_force)[:, 36:].any())  # the claws pressing
    for k in ("qpos", "qvel", "qacc", "efc_force"):
        ref = np.asarray(getattr(js, k))
        err = np.abs(getattr(ts, k).numpy() - ref).max()
        assert err <= SUBSTEP_REL * np.abs(ref).max(), (k, err)


def test_line_search_noise_at_the_configs_budget(capsys):
    """The finding both packages share (ROADMAP C): the line search freezes
    when |phi'| < tol = tolerance * meaninertia * nv (3.6e-12 on the
    tethered stand-in), below phi''s float64 rounding noise at the fly's
    scale. Once alpha has converged to the last ulp the noise's sign picks
    a collapsed bracket or a bisection back into it, so after the configs'
    4 steps the port's plain solve and the JAX package's array path, equal
    in exact arithmetic, land apart on some of these seeded states; with 50
    steps the bisection re-converges and they agree at SUBSTEP_REL."""
    jm = _jax_model(False)
    tm = tspec.load_model(FILES[False], device="cpu")
    tol = float(jm.opt.tolerance) * float(jm.opt.meaninertia) * jm.nv
    assert tol < 1e-11
    qpos, qvel, ctrl = _states(jm, False, seed=7, n=16, vel=5.0)
    d = tstep.forward_to_constraint(tm, _port_data(tm, qpos, qvel, ctrl))
    args, kw = tS._kernel_args(tm, d, tCn.efc_layout(tm))
    gaps = {}
    for ls in (4, 50):
        kw_ls = dict(kw, ls_iters=ls)
        ours = tcg.cg_solve_fused_reference(*args, **kw_ls)[0].numpy()
        qM, J = tcg.assemble_qM_J(*args[:2], tcg._bm(args[11], args[2], 1, args[12].shape[0]),
                                  args[3], args[12], args[13], row_slot=kw["row_slot"],
                                  sz=kw["sz"], root_bounds=kw["root_bounds"],
                                  limit_dadr=kw["limit_dadr"])
        layout = jS.Cn.efc_layout(jm)
        meta = jS._cone_meta(jm, layout)
        quad = np.zeros(layout.nefc)
        quad[meta.quad_rows] = 1.0
        statics = dict(L1=np.eye(jm.nv)[jS.Cn.limit_dofs(jm)], iters=4, ls_iters=ls, tol=tol,
                       dt=float(jm.opt.timestep), damp=np.zeros(jm.nv), has_damping=False,
                       quad_mask=quad, ell0=kw["ell0"], ell_mu=np.asarray(kw["ell_mu"]),
                       ell_scale=np.asarray(kw["ell_scale"]))
        nlim = len(kw["limit_dadr"])
        jsign = np.asarray(J[:, np.arange(nlim), kw["limit_dadr"]])
        ref = np.asarray(jax.vmap(lambda qM_, Jc, js_, D, ar, ex, ec, qfs, qv: jS._cg_arrays(
            qM_, Jc, js_, D, ar, ex, ec, qfs, qv, **statics)[0])(
            qM.numpy(), J[:, nlim:].numpy(), jsign, args[4].numpy(), args[5].numpy(),
            np.asarray(d.efc_pos < d.efc_margin), args[7].numpy(), args[8].numpy(),
            args[9].numpy()))
        gaps[ls] = np.abs(ours - ref).max(-1) / np.abs(ref).max()
    with capsys.disabled():
        print(f"\nline search at 4 / 50 steps: the port's plain solve against the JAX array "
              f"path, largest qacc gap {gaps[4].max():.3e} / {gaps[50].max():.3e} of the scale "
              f"(envs apart by > 1e-6 at 4 steps: {int((gaps[4] > 1e-6).sum())} of 16)")
    assert gaps[4].max() > 1e-6
    assert gaps[50].max() <= SUBSTEP_REL


# ---------------------------------------------------------------------------
# the stac exports
# ---------------------------------------------------------------------------
