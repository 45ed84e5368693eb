"""The rodent stand-in on a terrain (ROADMAP A.12's meshes and height
fields), the port against the JAX package and MuJoCo C, float64 on the CPU.

``assets/rodent_standin_terrain.xml`` (written by
``assets/make_ratpair.py``) is the rodent stand-in (nq 74, nv 73) dressed
in non-colliding visual meshes and standing on a height field, a box step,
a cylinder and two convex mesh rocks, which its limbs' spheres, capsules
and hand ellipsoids touch from the first substep. Here:

- the committed XMLs are the generator's and the committed ``.npz`` files
  a fresh freeze (configs/dataset/rodent.yaml's options for the scene,
  unscaled for its render scene); the freeze carried through
  ``model_from_numpy`` equals the JAX package's ``build_model`` at 1e-12;
- the scene's pair types are the eleven terrain types and the rodent's
  floor types, with no hfield-ellipsoid; its slots, rows, K and solve
  kernel layout;
- at qpos0 the port's active terrain slots are MuJoCo C's contacts, pair
  for pair, and every terrain pair type has one;
- ``RodentSingleClip`` on the scene against the JAX env from the same
  reset (the terrain's contacts active): one control step, and ten
  physics substeps each started from the JAX state, at
  tests/test_torch_rodent_env.py's tolerances plus twice the JAX package's
  own spread (its runs from the qposes scaled by 1 +- 1e-15 and 1 +-
  3e-15: the convex pairs' contact points jump with the normal, so one
  control step of the JAX env moves by ~1e-3 under such a change);
- the render scene's pixels (visual meshes and terrain drawn, the height
  field skipped) against the JAX ``NativeRenderer`` on MuJoCo's poses, to
  tests/test_torch_render.py's standard (equal);
- the driver on the CPU: the terrain command with ``train.render_video``,
  cut to one training step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brax_tracking_tpu.physics.spec as jspec
from brax_tracking_tpu_torch.assets import make_ratpair
from brax_tracking_tpu_torch.ops import cg as tcg
from brax_tracking_tpu_torch.physics import collision as tC
from brax_tracking_tpu_torch.physics import constraint as tCn
from brax_tracking_tpu_torch.physics import kinematics as tK
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import solver as tS
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.physics import step as tstep

mujoco = pytest.importorskip("mujoco")

OPTIONS = dict(solver="cg", iterations=4, ls_iterations=4, **tspec.RODENT_OPTIONS)
STAGE_ATOL = 1e-12
ATOL, RTOL = 1e-10, 1e-9  # tests/test_torch_rodent_env.py's
N, SUBSTEPS, T = 4, 10, 32
# the terrain's pair types (world geom type first, as the pair table orders)
TERRAIN_TYPES = {
    "sphere-box": (TM.GEOM_SPHERE, TM.GEOM_BOX), "capsule-box": (TM.GEOM_CAPSULE, TM.GEOM_BOX),
    "ellipsoid-box": (TM.GEOM_ELLIPSOID, TM.GEOM_BOX),
    "sphere-cylinder": (TM.GEOM_SPHERE, TM.GEOM_CYLINDER),
    "capsule-cylinder": (TM.GEOM_CAPSULE, TM.GEOM_CYLINDER),
    "ellipsoid-cylinder": (TM.GEOM_ELLIPSOID, TM.GEOM_CYLINDER),
    "sphere-mesh": (TM.GEOM_SPHERE, TM.GEOM_MESH), "capsule-mesh": (TM.GEOM_CAPSULE, TM.GEOM_MESH),
    "ellipsoid-mesh": (TM.GEOM_ELLIPSOID, TM.GEOM_MESH),
    "hfield-sphere": (TM.GEOM_HFIELD, TM.GEOM_SPHERE),
    "hfield-capsule": (TM.GEOM_HFIELD, TM.GEOM_CAPSULE),
}
FLOOR_TYPES = {(TM.GEOM_PLANE, TM.GEOM_SPHERE), (TM.GEOM_PLANE, TM.GEOM_CAPSULE),
               (TM.GEOM_PLANE, TM.GEOM_ELLIPSOID)}
# slots (17 on the floor, 58 on the terrain), rows under pyramidal CG 4/4, K
NCON, NEFC, PATCH = 75, 367, 5


@pytest.fixture(scope="module")
def terrain():
    """The JAX package's scene (its build_model of the XML, rescaled) and
    the port's frozen file."""
    jm = jspec.build_model(tspec.RODENT_STANDIN_TERRAIN_XML, dtype=jnp.float64, solver="cg",
                           iterations=4, ls_iterations=4, scale_factor=0.9)
    tm = tspec.load_model(tspec.RODENT_STANDIN_TERRAIN_NPZ, device="cpu", **OPTIONS)
    return jm, tm


def pair_types(m):
    t = np.asarray(m.geom_type)
    return [(int(t[a]), int(t[b])) for a, b in zip(m.pairs.geom1, m.pairs.geom2)]


def active_by_type(m, dist):
    """{pair type: active slots (dist < margin) of a (B, ncon) dist}."""
    slot_pair = np.repeat(np.arange(len(m.pairs.geom1)), m.pairs.npoint)
    margin = m.pairs.margin.numpy()[slot_pair]
    types = np.asarray(pair_types(m))[slot_pair]
    out = {}
    for k, tt in TERRAIN_TYPES.items():
        cols = np.nonzero((types == tt).all(-1))[0]
        out[k] = int((dist[:, cols] < margin[cols]).sum())
    return out


# ---------------------------------------------------------------------------
# the scenes and their frozen files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,terrain_xml", [
    (tspec.RODENT_STANDIN_TERRAIN_XML, make_ratpair.rodent_standin_xml),
    (tspec.RODENT_STANDIN_TERRAIN_PAIR_XML, make_ratpair.rodent_standin_pair_xml),
], ids=["scene", "render_scene"])
def test_xml_is_the_generators(path, terrain_xml):
    with open(path) as f:
        assert f.read() == terrain_xml(terrain=True)


@pytest.mark.parametrize("xml,npz,options", [
    (tspec.RODENT_STANDIN_TERRAIN_XML, tspec.RODENT_STANDIN_TERRAIN_NPZ, OPTIONS),
    (tspec.RODENT_STANDIN_TERRAIN_PAIR_XML, tspec.RODENT_STANDIN_TERRAIN_PAIR_NPZ, {}),
], ids=["scene", "render_scene"])
def test_committed_npz_matches_fresh_freeze(tmp_path, xml, npz, options):
    fresh = tspec.freeze_mjcf(xml, str(tmp_path / "t.npz"), **options)
    with np.load(npz) as z:
        assert sorted(fresh) == sorted(z.files)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_freeze_matches_jax(terrain):
    """The frozen scene through model_from_numpy against the JAX package's
    build_model at scale 0.9: every field at 1e-12, the mesh and height
    field fields included."""
    jm, tm = terrain
    port, jax_ = tspec.model_to_numpy(tm), tspec.model_to_numpy(jm)
    assert sorted(port) == sorted(jax_) == sorted(TM.field_keys())
    for k in TM.field_keys():
        if port[k].dtype.kind == "f":
            np.testing.assert_allclose(port[k], jax_[k], atol=STAGE_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)


def test_scene_is_the_rodent_on_terrain(terrain):
    """The rodent's sizes, the visual meshes out of every pair, the eleven
    terrain pair types and the floor's, the slots, rows and K, and the
    solve kernel's wide layout 1 (8 warps per env)."""
    _, tm = terrain
    standin = tspec.load_model(tspec.RODENT_STANDIN_NPZ, device="cpu", **OPTIONS)
    assert (tm.nq, tm.nv, tm.nbody, tm.nu, tm.nsensor) == (standin.nq, standin.nv, standin.nbody,
                                                          standin.nu, standin.nsensor)
    for k in ("body_mass", "body_inertia", "dof_damping", "actuator_gainprm"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), getattr(standin, k).numpy(), k)
    skins = [g for g, n in enumerate(tm.names["geom"]) if n.endswith("_skin")]
    assert len(skins) == len(make_ratpair.VISUAL_MESHES)
    assert (np.asarray(tm.geom_type)[skins] == TM.GEOM_MESH).all()
    assert not set(skins) & (set(tm.pairs.geom1) | set(tm.pairs.geom2))
    assert (np.asarray(tm.geom_meshidx)[skins] == -1).all()  # only the rocks are packed
    assert set(pair_types(tm)) == set(TERRAIN_TYPES.values()) | FLOOR_TYPES
    assert (TM.GEOM_HFIELD, TM.GEOM_ELLIPSOID) not in pair_types(tm)
    layout = tCn.efc_layout(tm)
    assert (tm.ncon, layout.nefc, tm.hfield_patch) == (NCON, NEFC, PATCH)
    nell = int(tS._cone_meta(tm, layout).ell_con.size)
    nroots = len(tS._fused_statics(tm, layout)["root_bounds"])
    assert tcg.kernel_layout(tm.nv, layout.nefc, nell, nroots, tm.ncon)[::2] == (1, 8)
    with np.load(tspec.RODENT_STANDIN_TERRAIN_PAIR_NPZ) as z:
        assert int(z["nq"]) == 2 * tm.nq and int(z["render_mesh_facenum"].size) == 5


def test_active_slots_are_mujocos_contacts(terrain):
    """At qpos0 the limbs stand on the terrain: the port's active terrain
    slots (float64) are between the geom pairs MuJoCo C reports contacts
    for, every one of those pairs has one, and so does every terrain pair
    type."""
    _, tm = terrain
    spec = mujoco.MjSpec.from_file(tspec.RODENT_STANDIN_TERRAIN_XML)
    tspec.rescale_subtree(spec, "torso", 0.9)
    mj = spec.compile()
    d = mujoco.MjData(mj)
    mujoco.mj_forward(mj, d)
    floor = tspec.name2id(tm, "geom", "floor")
    want = {tuple(sorted((int(c.geom1), int(c.geom2)))) for c in d.contact[:d.ncon]
            if floor not in (c.geom1, c.geom2)}
    td = tC.collision(tm, tK.kinematics(tm, tstep.make_data(tm, 1, device="cpu")))
    dist = td.contact_dist.numpy()
    slot_pair = np.repeat(np.arange(len(tm.pairs.geom1)), tm.pairs.npoint)
    got = {tuple(sorted((int(tm.pairs.geom1[p]), int(tm.pairs.geom2[p]))))
           for p in slot_pair[dist[0] < 0]}
    got = {p for p in got if floor not in p}
    assert got == want
    counts = active_by_type(tm, dist)
    assert all(counts.values()), counts


# ---------------------------------------------------------------------------
# the env against the JAX env
# ---------------------------------------------------------------------------


# the JAX package's rounding sensitivity: its runs again from the reset
# qposes scaled by these
SPREAD_SCALES = (1.0 + 1e-15, 1.0 - 1e-15, 1.0 + 3e-15, 1.0 - 3e-15)


def _spread(runs, key):
    """How far the JAX runs from the scaled qposes land from the first."""
    a = [np.asarray(key(r)) for r in runs]
    return np.max([np.abs(x - a[0]) for x in a[1:]], axis=0)


def _close(want, got, spread=0.0, err=""):
    """|got - want| within ATOL + RTOL |want| + twice the JAX spread."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    gap = np.abs(got - want)
    bad = gap > ATOL + RTOL * np.abs(want) + 2.0 * np.asarray(spread)
    assert not bad.any(), f"{err}: {int(bad.sum())} elements, max gap {gap[bad].max():.3e}"


@pytest.fixture(scope="module")
def envs(terrain):
    """The JAX RodentSingleClip on the scene (with the driver's synthetic
    clip), the port's, and N JAX reset states: the terrain's contacts are
    active there."""
    from brax_tracking_tpu.data import clips as jclips
    from brax_tracking_tpu.envs import rodent as jrodent
    from brax_tracking_tpu_torch.data import clips as tclips
    from brax_tracking_tpu_torch.envs import registry
    from brax_tracking_tpu_torch.harness import config as hc

    jm, tm = terrain
    env_args = dict(hc.load_config(["dataset=rodent"])["dataset"]["env_args"],
                    mjcf_path="builtin:rodent_standin_terrain.xml")
    q = np.tile(np.asarray(jm.qpos0, np.float64), (T, 1))
    q[:, 2] += 0.01
    q[:, 0] += np.linspace(0.0, 0.2, T)
    jc = jax.jit(lambda x: jclips.process_clip(jm, x))(jnp.asarray(q))
    tc = tclips.process_clip(tm, torch.as_tensor(q))
    jenv = jrodent.RodentSingleClip(reference_clip=jc, **dict(
        env_args, mjcf_path=tspec.RODENT_STANDIN_TERRAIN_XML, dtype=jnp.float64))
    tenv = registry.get_environment("rodent_single_clip", reference_clip=tc, device="cpu",
                                    **env_args)
    js = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(0), N))
    return jenv, tenv, js


def _port_state(tenv, js):
    ps = js.pipeline_state
    return tenv.init_state(torch.as_tensor(np.array(js.info["cur_frame"])),
                           torch.as_tensor(np.array(ps.qpos)), torch.as_tensor(np.array(ps.qvel)))


def _scaled(js, scale):
    return js.replace(pipeline_state=js.pipeline_state.replace(qpos=js.pipeline_state.qpos * scale))


def test_reset_stands_on_the_terrain(envs):
    _, tenv, js = envs
    ts = _port_state(tenv, js)
    m = tenv.model
    d = tC.collision(m, tK.kinematics(m, ts.pipeline_state))
    counts = active_by_type(m, d.contact_dist.numpy())
    assert all(counts.values()), counts
    _close(js.obs, ts.obs, err="obs")


def test_control_step_matches_jax(envs):
    """One control step (5 substeps) from the reset with seeded actions:
    obs, reward, every metric, the frame clocks, qpos, qvel and the
    sensors. The convex pairs' contact point is the midpoint of the two
    support witnesses, a hull vertex or a box corner, which jumps as the
    contact normal crosses a face's normal: over 5 substeps of a rodent
    standing on flat faces the JAX package's own run moves by ~1e-3 when
    its reset qposes move by 1e-15 of themselves, so each field is held at
    tests/test_torch_rodent_env.py's tolerances plus twice that spread."""
    jenv, tenv, js = envs
    a = np.random.RandomState(1).uniform(-1.0, 1.0, (N, tenv.action_size))
    step = jax.jit(jax.vmap(jenv.step))
    runs = [step(s, jnp.asarray(a)) for s in [js] + [_scaled(js, x) for x in SPREAD_SCALES]]
    ts = tenv.step(_port_state(tenv, js), torch.as_tensor(a))
    want = runs[0]
    assert ts.obs.shape == want.obs.shape == (N, tenv.observation_size)
    fields = {"obs": lambda s: s.obs, "reward": lambda s: s.reward,
              **{f"metrics/{k}": (lambda s, k=k: s.metrics[k]) for k in want.metrics},
              **{k: (lambda s, k=k: getattr(s.pipeline_state, k))
                 for k in ("qpos", "qvel", "sensordata")}}
    for name, key in fields.items():
        _close(key(want), key(ts).numpy(), _spread(runs, key), name)
    for key in ("cur_frame", "steps_taken_cur_frame"):
        np.testing.assert_array_equal(ts.info[key].numpy(), np.asarray(want.info[key]))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(want.done))


def test_substeps_match_jax(envs, terrain):
    """SUBSTEPS physics substeps from the reset with seeded controls, each
    started on both sides from the JAX package's state: qpos, qvel, act and
    the contacts at the rodent env tests' tolerances plus twice the JAX
    package's own spread over the same substep."""
    from brax_tracking_tpu.physics import step as jstep

    jm, tm = terrain
    _, _, js = envs
    step = jax.jit(jax.vmap(lambda d: jstep.step(jm, d)))
    d = js.pipeline_state
    rng = np.random.RandomState(2)
    t = lambda x: torch.as_tensor(np.array(x))
    for k in range(SUBSTEPS):
        d = d.replace(ctrl=jnp.asarray(rng.uniform(-1.0, 1.0, (N, jm.nu))))
        runs = [step(d.replace(qpos=d.qpos * x)) for x in (1.0,) + SPREAD_SCALES]
        td = tstep.make_data(tm, N, device="cpu").replace(
            qpos=t(d.qpos), qvel=t(d.qvel), act=t(d.act), ctrl=t(d.ctrl),
            qacc_warmstart=t(d.qacc_warmstart))
        got = tstep.step(tm, td, device="cpu")
        for name in ("qpos", "qvel", "act", "contact_dist", "contact_pos", "sensordata"):
            key = lambda s, name=name: getattr(s, name)
            _close(key(runs[0]), key(got).numpy(), _spread(runs, key), f"substep {k} {name}")
        d = runs[0]


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def test_renderer_pixels_match_jax():
    """Fed MuJoCo's poses of the render scene, the port's NativeRenderer
    gives the JAX NativeRenderer's pixels, from every camera and the
    default orbit: the visual meshes and the terrain drawn, the height field
    skipped by both."""
    from brax_tracking_tpu.native import softraster as jraster
    from brax_tracking_tpu_torch.native import softraster as traster

    mj = mujoco.MjModel.from_xml_path(tspec.RODENT_STANDIN_TERRAIN_PAIR_XML)
    d = mujoco.MjData(mj)
    r = tspec.render_fields(tspec.RODENT_STANDIN_TERRAIN_PAIR_NPZ)
    hf = int(np.nonzero(np.asarray(r.geom_type) == TM.GEOM_HFIELD)[0][0])
    assert traster.tessellate_geom(r, hf) is None
    mesh = [g for g in range(r.ngeom) if r.geom_type[g] == TM.GEOM_MESH]
    assert len(mesh) == 2 * len(make_ratpair.VISUAL_MESHES) + 2
    for g in mesh:
        v, f, _ = traster.tessellate_geom(r, g)
        assert f.shape[0] > 0 and v.shape[0] == r.mesh_vertnum[r.geom_dataid[g]]
    jr = jraster.NativeRenderer(mj, height=90, width=120)
    tr = traster.NativeRenderer(r, height=90, width=120)
    rng = np.random.RandomState(5)
    for _ in range(2):
        d.qpos[:] = mj.qpos0
        d.qpos[7:74] += rng.uniform(-0.1, 0.1, 67)
        d.qpos[81:] += rng.uniform(-0.1, 0.1, mj.nq - 81)
        mujoco.mj_forward(mj, d)
        for cam in [-1] + list(range(mj.ncam)):
            jr.update_scene(d, camera=cam)
            tr.update_scene(d.geom_xpos, d.geom_xmat, d.cam_xpos, d.cam_xmat, camera=cam)
            a, b = jr.render(), tr.render()
            np.testing.assert_array_equal(b, a, err_msg=f"camera {cam}")
            assert 0 < b.std(), f"camera {cam} renders a blank frame"


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRIVER_CUTS = ["train=train_rodent", "dataset=rodent",
               "dataset.env_args.mjcf_path=builtin:rodent_standin_terrain.xml",
               "dataset.rendering_mjcf=builtin:rodent_standin_terrain_pair.xml",
               "train.render_video=true",
               "train.num_envs=4", "train.batch_size=4", "train.num_eval_envs=2",
               "train.unroll_length=2", "train.num_minibatches=2",
               "train.num_updates_per_batch=1", "train.num_timesteps=16",
               "train.eval_every=16", "train.force_episode_length=true",
               "train.episode_length=2", "dataset.clip_length=7"]


def test_driver_trains_and_renders_on_cpu(tmp_path, monkeypatch):
    """The terrain command, cut to one training step of 4 envs, with the
    eval video of its render scene: every artifact, finite logged numbers
    and a video of the rollout's frames."""
    import json

    from brax_tracking_tpu_torch.harness import driver
    from brax_tracking_tpu_torch.native import video as vid

    monkeypatch.setenv("WANDB_MODE", "disabled")
    base = tmp_path / "r"
    metrics = driver.main(DRIVER_CUTS + [f"paths.base_dir={base}",
                                         f"paths.data_dir={tmp_path}/d"], device="cpu")
    assert metrics["training/sps"] > 0 and np.isfinite(metrics["eval/episode_reward"])
    run = "rodent_single_clip_track_debug"
    for p in ("run_config.yaml", "logs/metrics.jsonl", "ckpt/16/training_state.pt",
              f"ckpt/{run}/16", f"ckpt/{run}/final", f"ckpt/{run}/rollout_16.p"):
        assert (base / p).is_file(), p
    records = [json.loads(line) for line in
               (base / "logs" / "metrics.jsonl").read_text().splitlines()]
    for rec in records:
        assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float)), rec
    videos = [r for r in records if "rollout/video" in r]
    assert len(videos) == 1 and os.path.isfile(videos[0]["rollout/video"])
    assert vid.count_frames(videos[0]["rollout/video"]) == videos[0]["rollout/video_frames"] > 0
