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
- the render scene's pixels (visual meshes and terrain drawn, the height
  field skipped) against the JAX ``NativeRenderer`` on MuJoCo's poses, to
  tests/test_torch_render.py's standard (equal);
- the driver on the CPU: the terrain command with ``train.render_video``,
  cut to one training step.

``RodentSingleClip`` on the scene against the JAX env:
tests/test_torch_terrain_env.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import brax_tracking_tpu.physics.spec as jspec
from _torch_threads import torch_one_thread  # noqa: F401
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
