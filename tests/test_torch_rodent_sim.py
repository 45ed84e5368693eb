"""The rodent stand-in's sensors and damped substep (ROADMAP A.8) on the
CPU in float64, against the JAX package and MuJoCo C (the rest of its
pieces: tests/test_torch_rodent.py, whose helpers this file shares):

- the sensors against the JAX ``sensors`` at 1e-10 over seeded contact
  states of the stand-in; gyro, velocimeter and subtreelinvel also
  against MuJoCo C's ``sensordata`` at 1e-10, the accelerometer's and
  touch's gaps to MuJoCo reported (printed), not asserted: the JAX package
  differs from MuJoCo there by design (ROADMAP C);
- a damped substep of the stand-in (the solve kernel's plain version, its
  damped Euler tail) against the JAX package's step with its Pallas kernel
  in interpret mode, each field at 1e-10 of its scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import sensor as tsensor
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from brax_tracking_tpu_torch.physics import support as tsupport
from test_torch_rodent import (B, RODENT_YAML_OPTIONS, SENSOR_ATOL, SUBSTEP_REL, _jax_data,
                               _port_data, _states)

mujoco = pytest.importorskip("mujoco")


@pytest.fixture(scope="module")
def standin():
    """The JAX package's stand-in (its build_model of the XML, rescaled)
    and the port's frozen file."""
    jm = jspec.build_model(tspec.RODENT_STANDIN_XML, dtype=jnp.float64, solver="cg",
                           iterations=4, ls_iterations=4, scale_factor=0.9)
    tm = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu", **RODENT_YAML_OPTIONS)
    return jm, tm


@pytest.fixture(scope="module")
def sensed(standin):
    """Seeded contact states of the stand-in: the JAX package's vmapped step
    (its forward's sensordata is of the state it starts from) and the
    port's forward."""
    jm, tm = standin
    qpos, qvel, ctrl = _states(jm, seed=11)
    js = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))(_jax_data(jm, qpos, qvel, ctrl))
    tf = tstep.forward(tm, _port_data(tm, qpos, qvel, ctrl))
    return jm, tm, (qpos, qvel, ctrl), js, tf


def test_sensors_match_jax(sensed):
    jm, tm, _, js, tf = sensed
    j = np.asarray(js.sensordata)
    assert tf.sensordata.shape == j.shape == (B, 16)
    np.testing.assert_allclose(tf.sensordata.numpy(), j, atol=SENSOR_ATOL, rtol=0)
    touch = j[:, 9:13]
    assert (touch > 0).any() and (touch == 0).any()  # feet and hands on and off the floor
    # touch is the normal force of the contacts on the site's body
    normal = tsupport.contact_force(tm, tf)[..., 0].clamp(min=0)
    layout = tCn.efc_layout(tm)
    on = np.asarray(tm.geom_bodyid)[layout.con_geom2] == tm.site_bodyid[tm.sensor_objid[3]]
    np.testing.assert_allclose(tf.sensordata[:, 9].numpy(), normal[:, on].sum(-1).numpy(),
                               atol=SENSOR_ATOL)


def test_sensors_against_mujoco(sensed, capsys):
    """Gyro, velocimeter and subtreelinvel read position and velocity only:
    against MuJoCo C at SENSOR_ATOL. The accelerometer and touch read the
    solve, and MuJoCo's own 4-iteration CG stops elsewhere; touch also sums
    every contact on the site's body, where MuJoCo sums those inside the
    site. Their gaps, at CG 4/4 and with both solves converged, are
    printed, not asserted. The accelerometer's formula (the convective term
    w x v included) is held on MuJoCo's own qacc at SENSOR_ATOL."""
    jm, tm, (qpos, qvel, ctrl), _, tf = sensed
    mjm = jspec.build_model(tspec.RODENT_STANDIN_XML, scale_factor=0.9, return_mj=True,
                            solver="cg", iterations=4, ls_iterations=4)[1]
    mjd = mujoco.MjData(mjm)

    def mj_forward(mjm):
        """MuJoCo's sensordata and qacc at each state, from a cold start."""
        sens, qacc = [], []
        for b in range(B):
            mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos[b], qvel[b], ctrl[b]
            mjd.act[:], mjd.qacc_warmstart[:] = 0.0, 0.0
            mujoco.mj_forward(mjm, mjd)
            sens.append(mjd.sensordata.copy())
            qacc.append(mjd.qacc.copy())
        return sens, qacc

    ref, qacc = mj_forward(mjm)
    ref, ours = np.stack(ref), tf.sensordata.numpy()
    cols = {"accelerometer": slice(0, 3), "velocimeter": slice(3, 6), "gyro": slice(6, 9),
            "touch": slice(9, 13), "subtreelinvel": slice(13, 16)}
    for name in ("velocimeter", "gyro", "subtreelinvel"):
        np.testing.assert_allclose(ours[:, cols[name]], ref[:, cols[name]], atol=SENSOR_ATOL,
                                   rtol=0, err_msg=name)
    # the accelerometer's formula: on MuJoCo's own qacc it is MuJoCo's
    acc = tsensor.sensors(tm, tf.replace(qacc=torch.as_tensor(np.stack(qacc))))
    np.testing.assert_allclose(acc.sensordata[:, :3].numpy(), ref[:, :3], atol=SENSOR_ATOL,
                               rtol=0)
    # both solves run to convergence (100 iterations, tolerance 1e-12)
    conv = dataclasses.replace(tm, opt=dataclasses.replace(
        tm.opt, iterations=100, ls_iterations=50, tolerance=torch.tensor(1e-12)), cache={})
    ours_c = tstep.forward(conv, _port_data(conv, qpos, qvel, ctrl)).sensordata.numpy()
    mjm.opt.iterations, mjm.opt.ls_iterations, mjm.opt.tolerance = 100, 50, 1e-12
    ref_c = np.stack(mj_forward(mjm)[0])
    with capsys.disabled():
        for name in ("accelerometer", "touch"):
            c = cols[name]
            print(f"\n{name} against MuJoCo C: max gap {np.abs(ours[:, c] - ref[:, c]).max():.3e} "
                  f"at CG 4/4, {np.abs(ours_c[:, c] - ref_c[:, c]).max():.3e} converged (scale "
                  f"{np.abs(ref[:, c]).max():.3e}); qacc apart by up to "
                  f"{np.abs(tf.qacc.numpy() - np.stack(qacc)).max():.3e} at CG 4/4")


def test_damped_substep_matches_jax_kernel(standin, monkeypatch):
    """One substep of the damped stand-in: the port's kernel path on the CPU
    (the solve kernel's plain version with its damped Euler tail: the
    Cholesky of M + h diag(damping)) against the JAX package's step with
    its fused Pallas kernel in interpret mode (forced on the CPU by
    patching ``_use_pallas``, as tests/test_torch_pair.py does for Newton).
    Each field at SUBSTEP_REL of its scale."""
    from brax_tracking_tpu.ops import cg as jcg
    from brax_tracking_tpu.ops import cholesky as jchol

    jm, tm = standin
    assert tm.has_damping and tS.quad_kernel_eligible(tm)
    kernel = jcg.cg_solve_fused
    calls = []

    def interpreted(*a, **k):
        calls.append(k["has_damping"])
        return kernel(*a, **{**k, "unroll_iters": False, "unroll_ls": False,
                             "interpret": True})

    monkeypatch.setattr(jchol, "_use_pallas", lambda x: True)
    monkeypatch.setattr(jcg, "cg_solve_fused", interpreted)
    qpos, qvel, ctrl = _states(jm, seed=5, n=2)
    js = jax.jit(jax.vmap(lambda dd: jstep.step(jm, dd)))(_jax_data(jm, qpos, qvel, ctrl))
    ts = tstep.step(tm, _port_data(tm, qpos, qvel, ctrl), device="cpu")
    assert calls == [True]
    assert bool(np.asarray(js.efc_pos < js.efc_margin)[:, 67:].any())  # contacts active
    for k in ("qpos", "qvel", "qacc", "efc_force", "act", "sensordata"):
        ref = np.asarray(getattr(js, k))
        err = np.abs(getattr(ts, k).numpy() - ref).max()
        assert err <= SUBSTEP_REL * np.abs(ref).max(), (k, err)
