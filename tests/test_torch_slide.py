"""Slide joints on the planar minirat (assets/minirat_planar.xml: the
slides rootx, with a spring and a motor, and rootz, limited, and the hinge
rooty in place of the free joint), and the engine's small public helpers,
the port against MuJoCo C and the JAX package, float64 on the CPU.

- The committed file against a fresh freeze; it takes the solve kernel's
  layout (CG 4/4, one warp).
- Kinematics, cdof and cvel (``fwd_position_smooth`` /
  ``fwd_velocity_smooth``) at seeded states against MuJoCo C's
  mj_kinematics / mj_comPos / mj_comVel and the JAX package's, at 1e-12.
- The slide spring (qfrc_passive), the transmission through the slide
  (actuator_force, qfrc_actuator) and the slide limit's row against MuJoCo
  C and the JAX package, at 1e-10.
- The solve kernel's assembly of qM and J from cdof (its plain version;
  the CUDA kernel reads the same inputs) against the JAX dense ones: a
  slide dof needs no kernel change.
- 10 substeps against the JAX package's step (atol 1e-9).
- ``math/spatial.py``'s SpatialInertia, inert_mul and transform_inertia
  against the JAX package's, at 1e-12.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import brax_tracking_tpu.math.spatial as jsp
import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.math import spatial as tsp
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

B = 6
POS_ATOL, FRC_ATOL = 1e-12, 1e-10


@pytest.fixture(scope="module")
def models():
    jm = jspec.build_model(tspec.MINIRAT_PLANAR_XML, solver="cg", iterations=4,
                           ls_iterations=4, dtype=jnp.float64)
    tm = tspec.load_model(tspec.MINIRAT_PLANAR_NPZ, device="cpu")
    mj = mujoco.MjModel.from_xml_path(tspec.MINIRAT_PLANAR_XML)
    return jm, tm, mj


@pytest.fixture(scope="module")
def states(models):
    """Seeded states: the slides displaced (rootz past its lower limit in
    some envs), the hinges turned, random velocities and controls."""
    jm, _, _ = models
    rng = np.random.RandomState(0)
    qpos = np.asarray(jm.qpos0)[None].repeat(B, 0) + rng.uniform(-0.08, 0.08, (B, jm.nq))
    qpos[:, 1] = rng.uniform(-0.07, 0.02, B)
    return qpos, rng.uniform(-1, 1, (B, jm.nv)), rng.uniform(-1, 1, (B, jm.nu))


def _jax_data(jm, qpos, qvel, ctrl):
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (qpos.shape[0],) + x.shape),
                      jstep.make_data(jm))
    return jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def _port_data(tm, qpos, qvel, ctrl):
    return tstep.make_data(tm, qpos.shape[0], device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))


@pytest.fixture(scope="module")
def forwards(models, states):
    """The smooth stages, passive and actuation on both sides."""
    from brax_tracking_tpu.physics import actuation as jA
    from brax_tracking_tpu.physics import passive as jP
    from brax_tracking_tpu_torch.physics import actuation as tA
    from brax_tracking_tpu_torch.physics import passive as tP

    jm, tm, _ = models

    def jax_side(d):
        d = jstep.fwd_velocity_smooth(jm, jstep.fwd_position_smooth(jm, d))
        return jA.fwd_actuation(jm, jP.passive(jm, d))

    jd = jax.jit(jax.vmap(jax_side))(_jax_data(jm, *states))
    td = tstep.fwd_velocity_smooth(tm, tstep.fwd_position_smooth(tm, _port_data(tm, *states)))
    td = tA.fwd_actuation(tm, tP.passive(tm, td))
    return jd, td


def test_fixture(models, tmp_path):
    _, tm, mj = models
    fresh = str(tmp_path / "fresh.npz")
    tspec.freeze_mjcf(tspec.MINIRAT_PLANAR_XML, fresh)
    with np.load(tspec.MINIRAT_PLANAR_NPZ) as a, np.load(fresh) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jt = np.asarray(tm.jnt_type)
    assert (jt == TM.JNT_SLIDE).sum() == 2 and (tm.nq, tm.nv, tm.nu) == (mj.nq, mj.nv, mj.nu)
    assert tS.quad_kernel_eligible(tm)
    layout = tCn.efc_layout(tm)
    assert 1 in layout.limit_jnt  # rootz's limit is a scalar limit row


def test_stages_match_mujoco_and_jax(models, states, forwards):
    _, tm, mj = models
    jd, td = forwards
    for name in ("xpos", "xquat", "xanchor", "xaxis", "subtree_com", "cdof", "cvel",
                 "cdof_dot", "cinert_s", "cinert_h", "geom_xpos"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   atol=POS_ATOL, rtol=0, err_msg=name)
    for name in ("qfrc_passive", "qfrc_actuator", "actuator_force"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   atol=FRC_ATOL, rtol=0, err_msg=name)
    # MuJoCo C: its cdof and cvel are (n, 6) [angular, linear], the port's
    # component-major (6, n)
    qpos, qvel, ctrl = states
    d = mujoco.MjData(mj)
    for b in range(B):
        d.qpos[:], d.qvel[:], d.ctrl[:] = qpos[b], qvel[b], ctrl[b]
        mujoco.mj_forward(mj, d)
        for name, ref in (("xpos", d.xpos), ("xquat", d.xquat), ("subtree_com", d.subtree_com),
                          ("cdof", d.cdof.T), ("cvel", d.cvel.T)):
            np.testing.assert_allclose(getattr(td, name)[b].numpy(), ref, atol=POS_ATOL,
                                       rtol=0, err_msg=name)
        for name, ref in (("qfrc_passive", d.qfrc_passive), ("actuator_force", d.actuator_force),
                          ("qfrc_actuator", d.qfrc_actuator)):
            np.testing.assert_allclose(getattr(td, name)[b].numpy(), ref, atol=FRC_ATOL,
                                       rtol=0, err_msg=name)
    # the spring and the motor act on rootx
    assert float(td.qfrc_passive[:, 0].abs().min()) > 0
    assert float(td.qfrc_actuator[:, 0].abs().min()) > 0


def test_slide_limit_row_and_kernel_assembly(models, states):
    """The slide's limit row, and qM and J as the solve kernel assembles
    them from cdof (its plain version), against the JAX package."""
    from brax_tracking_tpu.physics import collision as jC
    from brax_tracking_tpu.physics import dynamics as jD

    jm, tm, _ = models

    def jax_side(d):
        d = jD.crb(jm, jC.collision(jm, jstep.fwd_position_smooth(jm, d)))
        d = jCn.make_constraint(jm, jstep.fwd_velocity_smooth(jm, d))
        return d, jCn.dense_J(jm, d)

    jf, jJ = jax.jit(jax.vmap(jax_side))(_jax_data(jm, *states))
    tf = tstep.forward_to_constraint(tm, _port_data(tm, *states))
    for k in ("efc_D", "efc_aref", "efc_pos", "efc_margin", "efc_jsign"):
        np.testing.assert_allclose(getattr(tf, k).numpy(), np.asarray(getattr(jf, k)),
                                   atol=FRC_ATOL, rtol=0, err_msg=k)
    row = int(tCn.efc_layout(tm).limit_rows[list(tCn.efc_layout(tm).limit_jnt).index(1)])
    assert bool((tf.efc_pos < tf.efc_margin)[:, row].any())  # rootz at its limit
    st = tS._solve_statics(tm, tCn.efc_layout(tm))
    kw = st["kw"]
    Bm = tcg._bm(st["P"], tf.con_A, len(kw["root_bounds"]), tm.ncon)
    qM, J = tcg.assemble_qM_J(tf.crb_f, tf.cdof, Bm, tf.efc_jsign, st["md"], tm.dof_armature,
                              row_slot=kw["row_slot"], sz=kw["sz"],
                              root_bounds=kw["root_bounds"], limit_dadr=kw["limit_dadr"])
    np.testing.assert_allclose(qM.numpy(), np.asarray(jf.qM), atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(tCn.dense_J(tm, tf).numpy(), np.asarray(jJ), atol=POS_ATOL,
                               rtol=0)


def test_rollout_on_the_kernel_layout_matches_jax(models, states):
    jm, tm, _ = models
    jd, td = _jax_data(jm, *states), _port_data(tm, *states)
    step = jax.jit(jax.vmap(lambda d: jstep.step(jm, d)))
    for _ in range(10):
        jd, td = step(jd), tstep.step(tm, td, device="cpu")
    for name in ("qpos", "qvel", "qacc", "efc_force"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   atol=1e-9, rtol=0, err_msg=name)
    assert torch.isfinite(td.qpos).all() and float(td.qpos[:, 0].abs().max()) > 1e-4


def test_spatial_helpers_match_jax():
    rng = np.random.RandomState(4)
    n = 5
    inert_d, mass = rng.uniform(0.1, 1, (n, 3)), rng.uniform(0.5, 2, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.stack([_mat(qi) for qi in q])
    off, v = rng.normal(size=(n, 3)), rng.normal(size=(n, 6))
    j = jsp.transform_inertia(*map(jnp.asarray, (inert_d, mass, rot, off)))
    t = tsp.transform_inertia(*map(torch.as_tensor, (inert_d, mass, rot, off)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POS_ATOL, rtol=0)
    s = t + t
    assert isinstance(s, tsp.SpatialInertia)
    np.testing.assert_allclose(tsp.inert_mul(s, torch.as_tensor(v)).numpy(),
                               np.asarray(jsp.inert_mul(j + j, jnp.asarray(v))), atol=POS_ATOL,
                               rtol=0)


def _mat(q):
    m = np.zeros(9)
    mujoco.mju_quat2Mat(m, q)
    return m.reshape(3, 3)
