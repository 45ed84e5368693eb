"""The rodent's pieces (ROADMAP A.8) on the CPU in float64, against the JAX
package and MuJoCo C.

``assets/rodent_standin.xml`` (written by ``assets/make_ratpair.py``)
stands in for the flagship rodent, whose MJCF is not in the repository.
Here:

- the committed XML is what the generator writes, and the committed
  ``rodent_standin.npz`` equals a fresh ``freeze_mjcf`` of it with
  configs/dataset/rodent.yaml's options; it has the rodent's sizes and
  features, and ``kernel_layout`` sends it to the wide layout 1;
- the port's rescaled freeze (``scale_factor`` 0.9 under the torso) equals
  the JAX package's ``build_model(..., scale_factor=0.9)`` at 1e-12, on
  the minirat and on the stand-in; a sensor type the port does not map
  raises at freeze;
- the seven sphere and ellipsoid pair types against the JAX ``collision``
  at 1e-12 (dist, pos, frame; ellipsoid-ellipsoid's frame at 1e-11, see
  FRAME_ATOL), on the inline fixtures of
  tests/test_collision_extended.py copied here (sphere-ellipsoid,
  capsule-ellipsoid, ellipsoid-ellipsoid, and its floor-settling
  ellipsoid for plane-ellipsoid) and on fixtures of the same form for
  plane-sphere, sphere-sphere and sphere-capsule;
- ``contact_force`` and ``active_contacts`` on tests/test_support.py's
  fixtures (a box on a plane, pyramidal and elliptic): on the JAX
  package's solved rows against its own ``support`` at 1e-12 and against
  MuJoCo's ``mj_contactForce`` at that test's tolerances;
- the driver on the CPU: ``train=train_rodent dataset=rodent`` on the
  stand-in, cut to one training step.

The sensors and a damped substep against the JAX package:
tests/test_torch_rodent_sim.py. The env's control steps against the JAX
env: tests/test_torch_rodent_env.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.collision as jC
import brax_tracking_tpu.physics.spec as jspec
import brax_tracking_tpu.physics.step as jstep
from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.physics import support as jsupport
from brax_tracking_tpu_torch.assets import make_ratpair
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import collision as tC
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import kinematics as tK
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep
from brax_tracking_tpu_torch.physics import support as tsupport

mujoco = pytest.importorskip("mujoco")

B = 4
RODENT_YAML_OPTIONS = dict(solver="cg", iterations=4, ls_iterations=4, **tspec.RODENT_OPTIONS)
# the stand-in's sizes: nq, nv, nbody, njnt, ngeom, nsite, nu, na, ntendon,
# nsensor, nsensordata; contact slots and rows under pyramidal CG 4/4
SIZES = (74, 73, 67, 68, 101, 21, 38, 38, 4, 8, 16)
NCON, NEFC = 17, 135
SENSOR_ATOL = 1e-10
STAGE_ATOL = 1e-12
SUBSTEP_REL = 1e-10


def _carry(jm):
    return tspec.model_from_numpy(tspec.model_to_numpy(jm), device="cpu")


def _states(m, seed=0, drop=0.01, n=B):
    """Seeded states with the root 1 cm into the floor (contacts) and the
    hinges perturbed (chip_smoke.py::random_states' recipe)."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(m.qpos0, np.float64)[None], (n, 1))
    qpos[:, 2] -= drop
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (n, m.nq - 7))
    return qpos, rng.uniform(-0.5, 0.5, (n, m.nv)), rng.uniform(-0.3, 0.3, (n, m.nu))


def _jax_data(jm, qpos, qvel, ctrl):
    n = qpos.shape[0]
    jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), jstep.make_data(jm))
    return jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl))


def _port_data(tm, qpos, qvel, ctrl):
    return tstep.make_data(tm, qpos.shape[0], device="cpu").replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), ctrl=torch.as_tensor(ctrl))


# ---------------------------------------------------------------------------
# the fixture and its frozen file
# ---------------------------------------------------------------------------


def test_xml_is_the_generators():
    with open(tspec.RODENT_STANDIN_XML) as f:
        assert f.read() == make_ratpair.rodent_standin_xml()


def test_committed_npz_matches_fresh_freeze(tmp_path):
    fresh = tspec.freeze_mjcf(tspec.RODENT_STANDIN_XML, str(tmp_path / "r.npz"),
                              **RODENT_YAML_OPTIONS)
    with np.load(tspec.RODENT_STANDIN_NPZ) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert committed["frozen_scale_factor"] == 0.9
    assert str(committed["frozen_rescale_root"]) == "torso"


def test_standin_is_a_rodent():
    """The rodent's sizes and kinds of features; the config's names; the
    pose; the solve kernel's wide layout 1 (8 warps per env)."""
    from brax_tracking_tpu_torch.harness import config as hc

    m = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu")
    assert (m.nq, m.nv, m.nbody, m.njnt, m.ngeom, m.nsite, m.nu, m.na, m.ntendon, m.nsensor,
            m.nsensordata) == SIZES
    assert int((np.asarray(m.jnt_type) == TM.JNT_HINGE).sum()) == 67
    # per-class joint damping and armature
    assert len(set(m.dof_damping[6:].tolist())) >= 4 and m.has_damping
    assert len(set(m.dof_armature[6:].tolist())) >= 4
    # 38 filtered <general> actuators with an affine bias, four on tendons
    assert (np.asarray(m.actuator_dyntype) == TM.DYN_FILTER).all()
    assert (np.asarray(m.actuator_biastype) == TM.BIAS_AFFINE).all()
    assert int((np.asarray(m.actuator_trntype) == TM.TRN_TENDON).sum()) == 4
    # fixed tendons, none limited
    mjm = mujoco.MjModel.from_xml_path(tspec.RODENT_STANDIN_XML)
    assert not mjm.tendon_limited.any()
    assert (mjm.wrap_type == mujoco.mjtWrap.mjWRAP_JOINT).all()
    # touch on the feet and hands; accelerometer, velocimeter, gyro on a
    # torso site; the torso's subtree linear velocity
    types = np.asarray(m.sensor_type).tolist()
    assert types == [TM.SENS_ACCELEROMETER, TM.SENS_VELOCIMETER, TM.SENS_GYRO] + [
        TM.SENS_TOUCH] * 4 + [TM.SENS_SUBTREELINVEL]
    site_body = [m.names["body"][b] for b in np.asarray(m.site_bodyid)[m.sensor_objid[3:7]]]
    assert site_body == ["foot_L", "foot_R", "hand_L", "hand_R"]
    # floor contacts through plane-capsule, plane-sphere, plane-ellipsoid
    gt = np.asarray(m.geom_type)
    assert (gt[m.pairs.geom1] == TM.GEOM_PLANE).all()
    assert set(gt[m.pairs.geom2].tolist()) == {TM.GEOM_SPHERE, TM.GEOM_CAPSULE,
                                               TM.GEOM_ELLIPSOID}
    layout = tCn.efc_layout(m)
    assert (m.ncon, layout.nefc) == (NCON, NEFC)
    assert tS.quad_kernel_eligible(m)
    kl, _, warps = tcg.kernel_layout(m.nv, layout.nefc, 0, 1, m.ncon)
    assert (kl, warps) == (1, tcg.WIDE_WARPS[1]) and warps == 8
    # every name rodent.yaml looks up (strict_name_lookup) resolves
    args = hc.load_config(["dataset=rodent"])["dataset"]["env_args"]
    for kind, names in (("body", args["body_names"] + args["end_eff_names"] + ["torso"]),
                        ("joint", args["joint_names"])):
        assert [n for n in names if tspec.name2id(m, kind, n) < 0] == [], kind
    # at qpos0: the torso inside healthy_z_range, no contact, the feet and
    # hands within 7 mm of the floor
    d = tC.collision(m, tK.kinematics(m, tstep.make_data(m, 1, device="cpu")))
    lo, hi = args["healthy_z_range"]
    assert lo < float(d.xpos[0, tspec.name2id(m, "body", "torso"), 2]) < hi
    assert 0.0 < float(d.contact_dist.min()) < 0.007


@pytest.mark.parametrize("name", ["minirat", "rodent_standin"])
def test_rescaled_model_matches_jax(tmp_path, name):
    """spec.rescale_subtree through freeze_mjcf against the JAX package's
    build_model at scale_factor 0.9: every field at 1e-12 (the compiler
    refits masses and inertias from the scaled geometry on both sides)."""
    xml = {"minirat": tspec.MINIRAT_XML, "rodent_standin": tspec.RODENT_STANDIN_XML}[name]
    fields = tspec.freeze_mjcf(xml, str(tmp_path / f"{name}.npz"), **RODENT_YAML_OPTIONS)
    jm = jspec.build_model(xml, dtype=jnp.float64, solver="cg", iterations=4, ls_iterations=4,
                           scale_factor=0.9)
    port = tspec.model_to_numpy(tspec.model_from_numpy(fields, device="cpu"))
    jax_ = tspec.model_to_numpy(jm)
    assert sorted(port) == sorted(jax_) == sorted(TM.field_keys())
    for k in TM.field_keys():
        if port[k].dtype.kind == "f":
            np.testing.assert_allclose(port[k], jax_[k], atol=STAGE_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)
    unscaled = tspec.model_to_numpy(jspec.build_model(xml, dtype=jnp.float64, solver="cg"))
    np.testing.assert_allclose(port["geom_size"][1:], 0.9 * unscaled["geom_size"][1:], rtol=1e-12)


def test_freeze_raises_for_an_unmapped_sensor(tmp_path):
    xml = tmp_path / "jointpos.xml"
    xml.write_text("""<mujoco><worldbody><body><joint name="h" axis="0 1 0"/>
    <geom type="capsule" size="0.01 0.02"/></body></worldbody>
    <sensor><jointpos joint="h"/></sensor></mujoco>""")
    with pytest.raises(NotImplementedError, match=r"A\.12"):
        tspec.freeze_mjcf(str(xml), str(tmp_path / "j.npz"))


# ---------------------------------------------------------------------------
# collision: the sphere and ellipsoid pairs
# ---------------------------------------------------------------------------

# tests/test_collision_extended.py's fixtures (a free body against a world
# geom: radius range of the pose, seed), and the same form for the pairs
# that file holds elsewhere
_WORLD_VS_FREE = {
    "sphere-ellipsoid": ("""<mujoco><worldbody><geom type="ellipsoid" size="0.1 0.07 0.05"/>
    <body pos="0.15 0 0"><freejoint/><geom type="sphere" size="0.06"/>
    </body></worldbody></mujoco>""", (0.08, 0.16), 3),
    "capsule-ellipsoid": ("""<mujoco><worldbody><geom type="ellipsoid" size="0.09 0.06 0.04"/>
    <body pos="0.12 0 0"><freejoint/><geom type="capsule" size="0.04 0.1"/>
    </body></worldbody></mujoco>""", (0.07, 0.16), 4),
    "ellipsoid-ellipsoid": ("""<mujoco><worldbody><geom type="ellipsoid" size="0.1 0.08 0.06"/>
    <body pos="0.15 0 0"><freejoint/>
    <geom type="ellipsoid" size="0.09 0.06 0.05"/></body></worldbody></mujoco>""",
                            (0.08, 0.18), 5),
    "sphere-sphere": ("""<mujoco><worldbody><geom type="sphere" size="0.07"/>
    <body pos="0.15 0 0"><freejoint/><geom type="sphere" size="0.05"/>
    </body></worldbody></mujoco>""", (0.08, 0.16), 6),
    "sphere-capsule": ("""<mujoco><worldbody><geom type="sphere" size="0.06"/>
    <body pos="0.12 0 0"><freejoint/><geom type="capsule" size="0.04 0.1"/>
    </body></worldbody></mujoco>""", (0.07, 0.16), 7),
}
_ON_PLANE = {
    # test_collision_extended.py::test_settles_on_floor's ellipsoid
    "plane-ellipsoid": ("""<mujoco><worldbody><geom type="plane" size="2 2 .1"/>
    <body pos="0.02 0 0.3"><freejoint/><geom type="ellipsoid" size="0.09 0.07 0.05"
    euler="20 35 10"/></body></worldbody></mujoco>""", 8),
    "plane-sphere": ("""<mujoco><worldbody><geom type="plane" size="2 2 .1"/>
    <body pos="0.02 0 0.3"><freejoint/><geom type="sphere" size="0.06"/>
    </body></worldbody></mujoco>""", 9),
}
N_POSES = 12
# ellipsoid-ellipsoid's normal is the argmax of a gap that is flat at its
# maximum: the two packages' roundings leave dist and pos within STAGE_ATOL
# but move the 40-step ascent's direction, and so the frame, by a few 1e-12;
# its frame is held at 1e-11, every other field and pair at STAGE_ATOL
FRAME_ATOL = {"ellipsoid-ellipsoid": 1e-11}


def _free_qpos(rng, base_pos, spread):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    return np.concatenate([base_pos + rng.uniform(-spread, spread, 3), q])


def _poses(pair):
    """N_POSES free-body poses: around the world geom at distances that
    overlap and separate (test_collision_extended.py's recipe), or above the
    plane from 2 cm inside it to 5 cm clear of it."""
    if pair in _WORLD_VS_FREE:
        _, (lo, hi), seed = _WORLD_VS_FREE[pair]
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(N_POSES):
            p = rng.uniform(-1, 1, 3)
            out.append(_free_qpos(rng, p / np.linalg.norm(p) * rng.uniform(lo, hi), 0.0))
        return np.stack(out)
    rng = np.random.RandomState(_ON_PLANE[pair][1])
    return np.stack([_free_qpos(rng, np.array([0.0, 0.0, rng.uniform(0.03, 0.1)]), 0.02)
                     for _ in range(N_POSES)])


@pytest.mark.parametrize("pair", sorted(_WORLD_VS_FREE) + sorted(_ON_PLANE))
def test_collision_pair_matches_jax(pair):
    xml = (_WORLD_VS_FREE.get(pair) or _ON_PLANE[pair])[0]
    mjm = mujoco.MjModel.from_xml_string(xml)
    jm = jspec.model_from_mj(mjm, dtype=jnp.float64)
    tm = _carry(jm)
    t1, t2 = (pair.split("-"))
    types = {"plane": TM.GEOM_PLANE, "sphere": TM.GEOM_SPHERE, "capsule": TM.GEOM_CAPSULE,
             "ellipsoid": TM.GEOM_ELLIPSOID}
    assert [(int(tm.geom_type[a]), int(tm.geom_type[b]))
            for a, b in zip(tm.pairs.geom1, tm.pairs.geom2)] == [(types[t1], types[t2])]
    qpos = _poses(pair)
    n = qpos.shape[0]
    zeros = np.zeros((n, tm.nv))
    jd = _jax_data(jm, qpos, zeros, np.zeros((n, 0)))
    js = jax.jit(jax.vmap(lambda d: jC.collision(jm, jstep.fwd_position_smooth(jm, d))))(jd)
    ts = tC.collision(tm, tK.kinematics(tm, _port_data(tm, qpos, zeros, np.zeros((n, 0)))))
    dist = np.asarray(js.contact_dist)
    assert (dist < 0).any() and (dist > 0).any()  # overlapping and clear poses
    for name in ("contact_dist", "contact_pos", "contact_frame"):
        atol = FRAME_ATOL.get(pair, STAGE_ATOL) if name == "contact_frame" else STAGE_ATOL
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# support: contact forces
# ---------------------------------------------------------------------------

# tests/test_support.py's fixtures
PYRAMID_XML = """<mujoco>
<option timestep="0.002" solver="CG" iterations="50" ls_iterations="25"
        cone="pyramidal"/>
<worldbody><geom type="plane" size="2 2 .1"/>
<body pos="0 0 0.045"><freejoint/><geom type="box" size="0.08 0.06 0.05"/>
</body></worldbody></mujoco>"""
ELLIPTIC_XML = PYRAMID_XML.replace("pyramidal", "elliptic")


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_contact_force_matches_jax_and_mujoco(cone):
    """The port's decode of the JAX package's solved rows (the plane-box
    pair is not ported, so the rows come from the JAX forward) against the
    JAX package's decode of the same rows, in the contact frame and in the
    world frame, and against mj_contactForce matched by position."""
    from engine_harness import jit_forward

    mjm = mujoco.MjModel.from_xml_string(PYRAMID_XML if cone == "pyramidal" else ELLIPTIC_XML)
    mjd = mujoco.MjData(mjm)
    mujoco.mj_forward(mjm, mjd)
    jm = jspec.model_from_mj(mjm, dtype=jnp.float64)
    jd = jit_forward(jm)(jstep.make_data(jm).replace(qpos=jnp.array(mjd.qpos)))
    tm = _carry(jm)
    t = lambda x: torch.as_tensor(np.array(x))[None]
    td = tstep.make_data(tm, 1, device="cpu").replace(
        efc_force=t(jd.efc_force), contact_frame=t(jd.contact_frame),
        contact_dist=t(jd.contact_dist))
    for world in (False, True):
        ours = tsupport.contact_force(tm, td, world_frame=world)[0].numpy()
        np.testing.assert_allclose(ours, np.asarray(jsupport.contact_force(jm, jd, world)),
                                   atol=STAGE_ATOL, rtol=0)
    act = tsupport.active_contacts(tm, td)[0].numpy()
    np.testing.assert_array_equal(act, np.asarray(jsupport.active_contacts(jm, jd)))
    assert act.sum() == mjd.ncon > 0
    ours = tsupport.contact_force(tm, td)[0].numpy()
    pos = np.asarray(jd.contact_pos)
    for i in range(mjd.ncon):
        w = np.zeros(6)
        mujoco.mj_contactForce(mjm, mjd, i, w)
        s = min(np.nonzero(act)[0], key=lambda k: np.linalg.norm(pos[k] - mjd.contact[i].pos))
        np.testing.assert_allclose(ours[s], w, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the damped substep on the solve kernel's path
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRIVER_CUTS = ["train=train_rodent", "dataset=rodent",
               "dataset.env_args.mjcf_path=builtin:rodent_standin.xml",
               "train.num_envs=8", "train.batch_size=8", "train.num_eval_envs=4",
               "train.unroll_length=4", "train.num_minibatches=2",
               "train.num_updates_per_batch=1", "train.num_timesteps=64",
               "train.eval_every=64", "train.force_episode_length=true",
               "train.episode_length=4", "dataset.clip_length=8"]


def test_driver_trains_the_standin_on_cpu(tmp_path, monkeypatch):
    """The flagship command on the stand-in, cut to one training step of 8
    envs, with its own data_dir (the committed data/Rodent clip is not one
    of the stand-in): the synthetic clip built through the frozen model and
    cached, every artifact, finite logged numbers."""
    import json

    from brax_tracking_tpu_torch.harness import driver

    monkeypatch.setenv("WANDB_MODE", "disabled")
    base = tmp_path / "r"
    metrics = driver.main(DRIVER_CUTS + [f"paths.base_dir={base}",
                                         f"paths.data_dir={tmp_path}/d"], device="cpu")
    assert os.listdir(tmp_path / "d" / "clips") == ["0.npz"]
    assert metrics["training/sps"] > 0 and np.isfinite(metrics["eval/episode_reward"])
    run = "rodent_single_clip_track_debug"
    for p in ("run_config.yaml", "logs/metrics.jsonl", "ckpt/64/training_state.pt",
              f"ckpt/{run}/64", f"ckpt/{run}/final", f"ckpt/{run}/rollout_64.p",
              "figures/perframe_64.csv"):
        assert (base / p).is_file(), p
    for line in (base / "logs" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float)), rec
