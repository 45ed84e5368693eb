"""The port's engine against the JAX package on minirat batched states, f64.

Seeded states as in tests/test_ops_cg_fused.py (root pushed 1 cm into the
floor, so contacts and limits are active) go through ``jax.vmap`` of the
JAX forward/step and through the port's batched forward/step on the CPU,
with parameters carried across by ``model_from_numpy``.

Tolerances: atol 1e-12 on the position/velocity stages and contacts (same
formulas, rounding only); atol 1e-10 on forces, constraint rows and solve
outputs (values up to ~1e3; the gaps are summation order); one step at
atol 1e-12; the 20-substep trajectory at atol 1e-9 (measured ~1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.constraint as jCn
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

B = 4

STAGES = {
    # position / velocity stages and contacts
    1e-12: (
        "xpos", "xquat", "xipos", "xanchor", "xaxis", "geom_xpos",
        "geom_xquat", "subtree_com", "cinert_s", "cinert_h", "cdof", "cvel",
        "cdof_dot", "contact_dist", "contact_pos", "contact_frame", "con_A",
        "efc_jsign", "efc_pos", "efc_margin",
    ),
    # forces, constraint rows, the solve
    1e-10: (
        "crb_f", "qfrc_bias", "qfrc_passive", "qfrc_actuator", "qfrc_smooth",
        "efc_D", "efc_aref", "qacc_smooth", "efc_force", "qfrc_constraint",
        "qacc", "qvel_next",
    ),
}


@pytest.fixture(scope="module")
def models():
    jm = jspec.build_model(
        "builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4,
        dtype=jnp.float64,
    )
    tm = tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def states(models):
    jm, tm = models
    rng = np.random.RandomState(0)
    qpos = np.tile(np.asarray(jm.qpos0)[None], (B, 1))
    qpos[:, 2] -= 0.01
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (B, jm.nq - 7))
    qvel = rng.uniform(-0.5, 0.5, (B, jm.nv))
    ctrl = rng.uniform(-0.3, 0.3, (B, jm.nu))
    d0 = jstep.make_data(jm)
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))
    td = tstep.make_data(tm, B, device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl)
    )
    return jd, td


@pytest.fixture(scope="module")
def jax_step(models):
    """The JAX package's batched step, compiled once for this module."""
    jm, _ = models
    return jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))


@pytest.fixture(scope="module")
def forwards(models, states, jax_step):
    jm, tm = models
    jd, td = states
    # the JAX step returns forward's fields of the state it started from
    # (only qpos, qvel, act and time advance), so one compile serves both
    jf = jax_step(jd)
    return jf, tstep.forward(tm, td)


@pytest.mark.parametrize("atol", sorted(STAGES))
def test_forward_stages(forwards, atol):
    jf, tf = forwards
    assert bool(np.asarray(jf.efc_pos < jf.efc_margin).any())  # contacts active
    for name in STAGES[atol]:
        j, t = np.asarray(getattr(jf, name)), getattr(tf, name).numpy()
        assert j.shape == t.shape, name
        np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=name)


def test_mass_matrix_and_jacobian(models, forwards):
    """qM and the constraint jacobian, which the port leaves to the solve
    kernel, assembled from the port's factors by the kernel's plain version
    against the JAX package's dense ones."""
    jm, tm = models
    jf, tf = forwards
    st = tS._solve_statics(tm, tCn.efc_layout(tm))
    kw = st["kw"]
    Bm = tcg._bm(st["P"], tf.con_A, len(kw["root_bounds"]), tm.ncon)
    qM, J = tcg.assemble_qM_J(
        tf.crb_f, tf.cdof, Bm, tf.efc_jsign, st["md"], tm.dof_armature,
        row_slot=kw["row_slot"], sz=kw["sz"], root_bounds=kw["root_bounds"],
        limit_dadr=kw["limit_dadr"],
    )
    np.testing.assert_allclose(qM.numpy(), np.asarray(jf.qM), atol=1e-12, rtol=0)
    dense = np.asarray(jax.jit(jax.vmap(lambda d: jCn.dense_J(jm, d)))(jf))
    np.testing.assert_allclose(J.numpy(), dense, atol=1e-12, rtol=0)


def test_one_step(models, states, jax_step):
    jm, tm = models
    jd, td = states
    js = jax_step(jd)
    ts = tstep.step(tm, td, device="cpu")
    for name in ("qpos", "qvel", "time", "qacc"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=1e-12, rtol=0,
            err_msg=name,
        )


def test_trajectory_20_substeps(models, states, jax_step):
    jm, tm = models
    jd, td = states
    n = 20
    jq, jv, tq, tv = [], [], [], []
    d = td
    for _ in range(n):
        jd = jax_step(jd)
        jq.append(np.asarray(jd.qpos))
        jv.append(np.asarray(jd.qvel))
        d = tstep.step(tm, d, device="cpu")
        tq.append(d.qpos.numpy())
        tv.append(d.qvel.numpy())
    jq, jv = np.stack(jq), np.stack(jv)
    np.testing.assert_allclose(np.stack(tq), jq, atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.stack(tv), jv, atol=1e-9, rtol=0)
    assert np.abs(jq[-1] - jq[0]).max() > 1e-3  # the state really moved
