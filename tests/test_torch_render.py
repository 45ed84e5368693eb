"""The port's eval videos, offline replay and demos (ROADMAP A.13) against
the JAX package and MuJoCo C, on the CPU.

- The render scenes: the pair stand-ins' generators and fresh freezes, their
  joints (the reference body first, in the env model's order), the frozen
  ``render_*`` fields of every scene against ``MjModel`` (exact); a mesh
  geom freezes with its triangles and an SDF geom raises.
- Poses: ``harness/render.py::scene_poses`` (one batched kinematics call)
  against ``mj_forward`` at seeded poses, 1e-12: geom positions and frames,
  and the cameras in the three modes (fixed in a moving body and in the
  world, track, trackcom); the cameras that aim at a body (targetbody,
  targetbodycom) at 1e-9.
- Pixels: the port's ``NativeRenderer`` fed MuJoCo's poses gives the JAX
  ``NativeRenderer``'s pixels exactly, from every camera and the default
  orbit; ``render_rollout_vs_reference`` gives the JAX one's frames on the
  same scene (the JAX side with its native renderer, never GL); the video
  writers write the JAX writers' bytes, and without imageio and Pillow
  ``save_video`` writes the GIF.
- The driver on the CPU with ``train.render_video`` writes a video of T
  frames; ``examples/policy_replay.py`` on that run writes the callback's
  per-frame table again; ``profile_dir`` writes a trace when the run
  returns and when it raises; the two demos run a few steps.
"""

import ast
import glob
import json
import os
import pickle
import subprocess
import sys
import types

import mujoco
import numpy as np
import pytest
import torch

from brax_tracking_tpu.harness import render as jrender
from brax_tracking_tpu.native import softraster as jraster
from brax_tracking_tpu.native import video as jvideo
from brax_tracking_tpu_torch import native as tnative
from brax_tracking_tpu_torch.assets import make_fly_standin, make_ratpair
from brax_tracking_tpu_torch.data.clips import ReferenceClip
from brax_tracking_tpu_torch.examples import contact_force_demo, env_rollout_demo, policy_replay
from brax_tracking_tpu_torch.harness import driver as tdriver
from brax_tracking_tpu_torch.harness import render as trender
from brax_tracking_tpu_torch.native import softraster as traster
from brax_tracking_tpu_torch.native import video as tvideo
from brax_tracking_tpu_torch.physics import model as TM
from brax_tracking_tpu_torch.physics import spec as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "brax_tracking_tpu_torch")
POSE_ATOL = 1e-12
# (scene as a config names it, free_jnt, its frozen file, its MJCF)
SCENES = [
    ("builtin:rodent_standin_pair.xml", True, tspec.RODENT_STANDIN_PAIR_NPZ,
     tspec.RODENT_STANDIN_PAIR_XML),
    ("builtin:fly_standin_pair.xml", True, tspec.FLY_STANDIN_PAIR_NPZ, tspec.FLY_STANDIN_PAIR_XML),
    ("builtin:fly_standin_pair.xml", False, tspec.FLY_STANDIN_PAIR_TETHERED_NPZ,
     tspec.FLY_STANDIN_PAIR_XML),
]
SCENE_IDS = ["rodent_pair", "fly_pair", "fly_pair_tethered"]
# the env each scene renders: its frozen file and the rollout's nq
ENV_OF_SCENE = {
    tspec.RODENT_STANDIN_PAIR_NPZ: tspec.RODENT_STANDIN_NPZ,
    tspec.FLY_STANDIN_PAIR_NPZ: tspec.FLY_STANDIN_NPZ,
    tspec.FLY_STANDIN_PAIR_TETHERED_NPZ: tspec.FLY_STANDIN_TETHERED_NPZ,
}
# the driver's cuts (tests/test_torch_harness.py): 11 control steps in the
# callback's rollout, so 12 qpos frames against a 16-frame clip
CUTS = ["train=smoke", "dataset=minirat", "train.num_timesteps=64", "train.eval_every=64",
        "train.episode_length=4", "dataset.clip_length=16"]


@pytest.fixture(autouse=True)
def _wandb_off(monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "disabled")


def _spec(xml, free):
    """MuJoCo's spec of a scene as the JAX render builds it: every free
    joint deleted for a tethered one. (The JAX render deletes them by
    ``joint.delete()``, which this mujoco's MjsJoint lacks: ROADMAP C.)"""
    ms = mujoco.MjSpec.from_file(xml)
    if not free:
        for joint in list(ms.joints):
            if joint.type == mujoco.mjtJoint.mjJNT_FREE:
                ms.delete(joint)
    return ms


def _compile(xml, free):
    return _spec(xml, free).compile()


def _seeded_qpos(mj, n, seed, scale=0.3):
    """n poses near qpos0 with unit root quaternions."""
    rng = np.random.RandomState(seed)
    q = np.tile(mj.qpos0, (n, 1)) + rng.normal(0.0, scale, (n, mj.nq))
    for j in np.nonzero(mj.jnt_type == mujoco.mjtJoint.mjJNT_FREE)[0]:
        a = mj.jnt_qposadr[j] + 3
        q[:, a:a + 4] /= np.linalg.norm(q[:, a:a + 4], axis=1, keepdims=True)
    return q


def _mj_poses(mj, qpos):
    d = mujoco.MjData(mj)
    out = []
    for q in qpos:
        d.qpos[:] = q
        mujoco.mj_forward(mj, d)
        out.append((d.geom_xpos.copy(), d.geom_xmat.reshape(-1, 3, 3).copy(),
                    d.cam_xpos.copy(), d.cam_xmat.reshape(-1, 3, 3).copy()))
    return [np.stack(x) for x in zip(*out)]


# ---------------------------------------------------------------------------
# the render scenes and their frozen fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,text", [
    (tspec.RODENT_STANDIN_PAIR_XML, make_ratpair.rodent_standin_pair_xml),
    (tspec.FLY_STANDIN_PAIR_XML, make_fly_standin.fly_standin_pair_xml),
], ids=["rodent_pair", "fly_pair"])
def test_pair_xml_is_the_generators(path, text):
    with open(path) as f:
        assert f.read() == text()


@pytest.mark.parametrize("scene,free,npz,xml", SCENES, ids=SCENE_IDS)
def test_committed_pair_npz_matches_fresh_freeze(tmp_path, scene, free, npz, xml):
    fresh = tspec.freeze_mjcf(xml, str(tmp_path / "p.npz"), free_jnt=free, render_scene=True)
    with np.load(npz) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed)
    for k, v in fresh.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert tspec.frozen_path(scene, free) == npz


@pytest.mark.parametrize("scene,free,npz,xml", SCENES, ids=SCENE_IDS)
def test_pair_puts_the_reference_body_first_in_the_env_order(scene, free, npz, xml):
    """The scene's joints are the env model's, suffixed -0 (the reference
    clip's body) then -1 (the rollout's), so its nq is twice the env's and
    the render takes the pair branch."""
    with np.load(npz) as z, np.load(ENV_OF_SCENE[npz]) as e:
        pair, env = list(z["names_joint"]), list(e["names_joint"])
        assert int(z["nq"]) == 2 * int(e["nq"])
        np.testing.assert_array_equal(z["jnt_qposadr"][:len(env)], e["jnt_qposadr"])
    assert pair == [f"{n}-0" for n in env] + [f"{n}-1" for n in env]


def test_ratpair_is_not_the_rodent_stand_in():
    """ratpair.xml pairs rat.xml's rats: nq 74 each, as the stand-in, but
    other joint names in another order, so it cannot render the rodent."""
    with np.load(tspec.RAT_NPZ) as rat, np.load(tspec.RODENT_STANDIN_NPZ) as standin:
        assert int(rat["nq"]) == int(standin["nq"]) == 74
        assert list(rat["names_joint"]) != list(standin["names_joint"])


@pytest.mark.parametrize("npz,xml,free", [
    (tspec.MINIRAT_NPZ, tspec.MINIRAT_XML, True),
    (tspec.RODENT_STANDIN_PAIR_NPZ, tspec.RODENT_STANDIN_PAIR_XML, True),
    (tspec.FLY_STANDIN_PAIR_NPZ, tspec.FLY_STANDIN_PAIR_XML, True),
    (tspec.FLY_STANDIN_PAIR_TETHERED_NPZ, tspec.FLY_STANDIN_PAIR_XML, False),
], ids=["minirat", "rodent_pair", "fly_pair", "fly_pair_tethered"])
def test_render_fields_match_mjmodel(npz, xml, free):
    mj = _compile(xml, free)
    r = tspec.render_fields(npz)
    for k in TM.RENDER_FIELDS:
        want = getattr(mj.stat, k[5:]) if k.startswith("stat_") else getattr(mj, k)
        np.testing.assert_array_equal(getattr(r, k), want, err_msg=k)
    np.testing.assert_array_equal(r.geom_type, mj.geom_type)
    np.testing.assert_array_equal(r.geom_size, mj.geom_size)
    assert (r.ngeom, r.ncam) == (mj.ngeom, mj.ncam)
    assert r.names_camera == [mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_CAMERA, i)
                              for i in range(mj.ncam)]


def test_every_committed_npz_has_render_fields():
    for npz in glob.glob(os.path.join(tspec.ASSETS, "*.npz")):
        r = tspec.render_fields(npz)
        assert r.geom_rgba.shape == (r.ngeom, 4), npz


def test_mesh_geom_raises_at_freeze(tmp_path):
    """A mesh geom freezes with its triangles (ROADMAP A.12's meshes); an SDF
    geom, which the JAX package cannot collide, raises at freeze."""
    xml = tmp_path / "mesh.xml"
    xml.write_text("""<mujoco><asset><mesh name="tet" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>
    <worldbody><geom type="plane" size="1 1 .1"/><body pos="0 0 .5"><freejoint/>
    <geom type="mesh" mesh="tet" contype="0" conaffinity="0"/><geom type="sphere" size=".1"/>
    </body></worldbody></mujoco>""")
    tspec.freeze_mjcf(str(xml), str(tmp_path / "mesh.npz"))
    r = tspec.render_fields(str(tmp_path / "mesh.npz"))
    assert (r.mesh_vertnum.tolist(), r.mesh_facenum.tolist()) == ([4], [4])
    mj = mujoco.MjModel.from_xml_path(str(xml))
    mj.geom_type[1] = TM.GEOM_SDF
    with pytest.raises(NotImplementedError, match="§A.12"):
        tspec._render_fields(mj, mujoco)


# ---------------------------------------------------------------------------
# poses and cameras against MuJoCo C
# ---------------------------------------------------------------------------


def _three_mode_scene(tmp_path):
    """The rodent pair with two more cameras: ``track`` on the reference's
    torso and one fixed in the rollout's skull (a moving body)."""
    text = open(tspec.RODENT_STANDIN_PAIR_XML).read()
    text = text.replace('<freejoint name="free-0"/>', '<freejoint name="free-0"/>\n'
                        '<camera name="chase" mode="track" pos="-0.4 0 0.15" '
                        'xyaxes="0 -1 0 0.3 0 1"/>')
    text = text.replace('<body name="skull-1" pos="0.008 0 0.003">',
                        '<body name="skull-1" pos="0.008 0 0.003">\n<camera name="eye" '
                        'pos="0.05 0 0.02" xyaxes="0 -1 0 0 0 1" fovy="60"/>')
    xml = tmp_path / "three_modes.xml"
    xml.write_text(text)
    npz = str(tmp_path / "three_modes.npz")
    tspec.freeze_mjcf(str(xml), npz)
    return str(xml), npz, True


@pytest.mark.parametrize("case", SCENE_IDS + ["three_modes"])
def test_poses_match_mujoco(tmp_path, case):
    if case == "three_modes":
        xml, npz, free = _three_mode_scene(tmp_path)
    else:
        _, free, npz, xml = SCENES[SCENE_IDS.index(case)]
    mj = _compile(xml, free)
    m = tspec.load_model(npz, device="cpu")
    r = tspec.render_fields(npz)
    if case == "three_modes":
        assert sorted(r.cam_mode.tolist()) == [TM.CAM_FIXED, TM.CAM_FIXED, TM.CAM_TRACK,
                                               TM.CAM_TRACKCOM]
    qpos = _seeded_qpos(mj, 6, 3)
    got = trender.scene_poses(m, r, torch.as_tensor(qpos))
    for name, a, b in zip(("geom_xpos", "geom_xmat", "cam_xpos", "cam_xmat"), got,
                          _mj_poses(mj, qpos)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=POSE_ATOL, rtol=0, err_msg=name)


TARGET_ATOL = 1e-9


@pytest.mark.parametrize("scene", ["rodent_pair", "minirat_cameras"])
def test_target_body_camera_raises(tmp_path, scene):
    """Cameras that aim at a body, which raised before they were ported:
    ``targetbody`` (at the target's origin) and ``targetbodycom`` (at its
    subtree centre of mass), one fixed in the world and one riding a moving
    body, match MuJoCo's ``mj_camlight`` at 1e-9 on seeded poses; on the
    rodent pair (the reference's torso aimed at from the reference's free
    body and the rollout's skull) and on the committed fixture
    ``assets/minirat_cameras.xml``, which is also its fresh freeze."""
    if scene == "rodent_pair":
        text = open(tspec.RODENT_STANDIN_PAIR_XML).read().replace(
            '<freejoint name="free-0"/>', '<freejoint name="free-0"/>\n<camera name="aim" '
            'mode="targetbody" target="torso-1" pos="0 -0.3 0.1"/>')
        text = text.replace('<body name="skull-1" pos="0.008 0 0.003">',
                            '<body name="skull-1" pos="0.008 0 0.003">\n<camera name="aimcom" '
                            'mode="targetbodycom" target="torso-0" pos="0.05 0.1 0.02"/>')
        xml = tmp_path / "target.xml"
        xml.write_text(text)
        xml, npz = str(xml), str(tmp_path / "target.npz")
        tspec.freeze_mjcf(xml, npz)
    else:
        xml, npz = tspec.MINIRAT_CAMERAS_XML, tspec.MINIRAT_CAMERAS_NPZ
        fresh = tspec.freeze_mjcf(xml, str(tmp_path / "fresh.npz"))
        committed = dict(np.load(npz))
        assert sorted(fresh) == sorted(committed)
        for k, v in fresh.items():
            np.testing.assert_array_equal(committed[k], v, err_msg=k)
    mj = _compile(xml, True)
    m = tspec.load_model(npz, device="cpu")
    r = tspec.render_fields(npz)
    aims = [TM.CAM_TARGETBODY, TM.CAM_TARGETBODYCOM]
    assert sorted(c for c in r.cam_mode.tolist() if c in aims) == aims
    assert (r.cam_targetbodyid[np.isin(r.cam_mode, aims)] >= 0).all()
    qpos = _seeded_qpos(mj, 6, 4)
    got = trender.scene_poses(m, r, torch.as_tensor(qpos))
    for name, a, b in list(zip(("geom_xpos", "geom_xmat", "cam_xpos", "cam_xmat"), got,
                               _mj_poses(mj, qpos)))[2:]:
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=TARGET_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# pixels against the JAX renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SCENE_IDS + ["minirat"])
def test_renderer_pixels_match_jax(case):
    """Fed MuJoCo's poses, the port's NativeRenderer (built from the frozen
    fields) gives the JAX NativeRenderer's pixels (built from the MjModel),
    from each camera, by name and from the default orbit."""
    if case == "minirat":
        xml, free, npz = tspec.MINIRAT_XML, True, tspec.MINIRAT_NPZ
    else:
        _, free, npz, xml = SCENES[SCENE_IDS.index(case)]
    mj = _compile(xml, free)
    d = mujoco.MjData(mj)
    jr = jraster.NativeRenderer(mj, height=90, width=120)
    tr = traster.NativeRenderer(tspec.render_fields(npz), height=90, width=120)
    cameras = [-1] + list(range(mj.ncam)) + (["track"] if mj.ncam else [])
    for q in _seeded_qpos(mj, 2, 5):
        d.qpos[:] = q
        mujoco.mj_forward(mj, d)
        for cam in cameras:
            jr.update_scene(d, camera=cam)
            tr.update_scene(d.geom_xpos, d.geom_xmat, d.cam_xpos, d.cam_xmat, camera=cam)
            a, b = jr.render(), tr.render()
            np.testing.assert_array_equal(b, a, err_msg=f"camera {cam}")
            assert 0 < b.std(), f"camera {cam} renders a blank frame"


def test_rasterizer_source_is_a_byte_copy():
    with open(os.path.join(REPO, "native", "rasterizer.cc"), "rb") as a, open(
            os.path.join(PORT, "native", "csrc", "rasterizer.cc"), "rb") as b:
        assert a.read() == b.read()


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_CSRC", str(tmp_path))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken.cc"):
        tnative.load_library("broken")


@pytest.mark.parametrize("case", SCENE_IDS + ["minirat"])
def test_render_rollout_matches_jax(monkeypatch, tmp_path, case):
    """render_rollout_vs_reference on a seeded rollout and clip: the port's
    frames (poses from one batched kinematics call) equal the JAX
    function's (mj_forward per frame, its native renderer) on the same
    scene, the same stride, T and branch."""
    if case == "minirat":
        scene, free, env_npz, xml = "builtin:minirat.xml", True, tspec.MINIRAT_NPZ, None
        camera = -1
    else:
        scene, free, npz, xml = SCENES[SCENE_IDS.index(case)]
        env_npz, camera = ENV_OF_SCENE[npz], 1
    env = tspec.load_model(env_npz, device="cpu")
    mj_env = types.SimpleNamespace(qpos0=env.qpos0.numpy(), nq=env.nq,
                                   jnt_type=np.asarray(env.jnt_type),
                                   jnt_qposadr=np.asarray(env.jnt_qposadr))
    rollout = _seeded_qpos(mj_env, 13, 7, 0.2)
    ref = _seeded_qpos(mj_env, 6, 8, 0.2)
    root = 7 if free and int(env.jnt_type[0]) == TM.JNT_FREE else 0
    clip = dict(joints=ref[:, root:], position=ref[:, :3] if root else None,
                quaternion=ref[:, 3:7] if root else None)

    captured = {}

    def capture(key):
        def save_video(path, frames, fps=50.0):
            captured[key] = [np.array(f) for f in frames]
            return path
        return save_video

    monkeypatch.setattr(jvideo, "save_video", capture("jax"))
    monkeypatch.setattr(tvideo, "save_video", capture("port"))
    monkeypatch.setattr(jrender, "make_renderer",
                        lambda m, height, width: jraster.NativeRenderer(m, height, width))
    kw = dict(camera=camera, height=72, width=96)
    jax_xml = xml or scene
    if not free:  # the JAX render's own strip fails here (_spec): strip first
        jax_xml = str(tmp_path / "stripped.xml")
        with open(jax_xml, "w") as f:
            f.write(_spec(xml, free).to_xml())
    jrender.render_rollout_vs_reference(jax_xml, rollout, types.SimpleNamespace(**clip),
                                        "v.mp4", free_jnt=True, **kw)
    timings = {}
    trender.render_rollout_vs_reference(
        scene, torch.as_tensor(rollout),
        ReferenceClip(**{k: None if v is None else torch.as_tensor(v) for k, v in clip.items()}),
        "v.mp4", free_jnt=free, timings=timings, **kw)
    assert len(captured["port"]) == len(captured["jax"]) == timings["frames"] == 6
    for t, (a, b) in enumerate(zip(captured["jax"], captured["port"])):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {t}")


def test_multi_clip_reference_takes_clip_zero():
    clip = ReferenceClip(position=torch.rand(3, 5, 3), quaternion=torch.rand(3, 5, 4),
                         joints=torch.rand(3, 5, 6))
    q = trender.reference_qpos_trajectory(clip, True)
    torch.testing.assert_close(q, torch.cat([clip.position[0], clip.quaternion[0],
                                             clip.joints[0]], 1), rtol=0, atol=0)
    assert torch.equal(trender.reference_qpos_trajectory(clip, False), clip.joints[0])


# ---------------------------------------------------------------------------
# the video writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["write_gif", "write_mjpeg_avi"])
def test_writers_match_jax(tmp_path, writer):
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (30, 40, 3), dtype=np.uint8) for _ in range(4)]
    a = getattr(jvideo, writer)(str(tmp_path / "a"), frames, fps=25)
    b = getattr(tvideo, writer)(str(tmp_path / "b"), frames, fps=25)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tvideo.count_frames(b) == 4


def test_save_video_writes_gif_without_imageio_or_pil(tmp_path, monkeypatch):
    """Where neither imageio nor Pillow imports, the numpy GIF."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    frames = [np.full((20, 30, 3), 40 * k, np.uint8) for k in range(5)]
    path = tvideo.save_video(str(tmp_path / "v.mp4"), frames)
    assert path == str(tmp_path / "v.gif")
    assert open(path, "rb").read() == open(jvideo.write_gif(str(tmp_path / "j.gif"), frames),
                                           "rb").read()
    assert tvideo.count_frames(path) == 5


def test_render_modules_import_no_mujoco_pil_or_imageio():
    """The render path runs where none of them is installed: no module of
    it imports mujoco; Pillow and imageio only native/video.py imports, in
    the writer that uses each, whose ImportError falls to the next one."""
    files = (glob.glob(os.path.join(PORT, "native", "*.py"))
             + glob.glob(os.path.join(PORT, "examples", "*.py"))
             + [os.path.join(PORT, "harness", "render.py"),
                os.path.join(PORT, "harness", "driver.py")])
    assert len(files) == 9
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                for name in names:
                    root = name.split(".")[0]
                    assert root not in ("mujoco", "jax", "brax_tracking_tpu"), (path, name)
                    if root in ("PIL", "imageio"):
                        assert path.endswith(os.path.join("native", "video.py")), (path, name)
                        assert id(node) not in top, (path, name)


# ---------------------------------------------------------------------------
# the driver, the replay, the profile and the demos on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def video_run(tmp_path_factory):
    """The driver's smoke run with train.render_video, once for the module."""
    tmp = tmp_path_factory.mktemp("video_run")
    base = tmp / "run"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WANDB_MODE", "disabled")
        tdriver.main(CUTS + [f"paths.base_dir={base}", f"paths.data_dir={tmp}/data",
                             "train.render_video=true"], device="cpu")
    records = [json.loads(line) for line in open(base / "logs" / "metrics.jsonl")]
    return base, records


def test_driver_renders_video_on_cpu(video_run):
    base, records = video_run
    logged = {k: v for r in records for k, v in r.items() if k.startswith("rollout/video")}
    run_dir = base / "ckpt" / "single_clip_tracking_track_smoke"
    path = logged["rollout/video"]
    assert os.path.dirname(path) == str(run_dir)
    assert os.path.basename(path).split(".")[0] == "rollout_64" and os.path.isfile(path)
    # 12 qpos frames (the reset and 11 control steps) at stride 1 against 16
    # clip frames: T = 12, the single-model branch of the minirat
    assert tvideo.count_frames(path) == logged["rollout/video_frames"] == 12
    for k in ("setup_s", "kinematics_s", "raster_s_per_frame", "encode_s"):
        assert logged[f"rollout/video_{k}"] > 0, k


def test_policy_replay_reproduces_the_callback(video_run, tmp_path):
    base, _ = video_run
    out = policy_replay.main([str(base), "--video", "--device", "cpu",
                              "--out", str(tmp_path / "replay")])
    run_dir = base / "ckpt" / "single_clip_tracking_track_smoke"
    with open(run_dir / "rollout_64.p", "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(out, "rollout_64.p"), "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    videos = [p for p in glob.glob(os.path.join(out, "rollout_64.*")) if not p.endswith(".p")]
    assert len(videos) == 1 and tvideo.count_frames(videos[0]) == 12
    assert policy_replay.latest_checkpoint(str(base / "ckpt")) == str(run_dir / "64")


def test_driver_missing_render_scene_raises_before_training(tmp_path):
    """The configs' own rendering_mjcf (the reference's pair MJCF) is not in
    the repository: with render_video on, the run raises before it trains."""
    base = tmp_path / "run"
    with pytest.raises(FileNotFoundError, match="rodent_pair.xml"):
        tdriver.main(CUTS + [f"paths.base_dir={base}", f"paths.data_dir={tmp_path}/data",
                             "train.render_video=true",
                             "dataset.rendering_mjcf=/absent/rodent_pair.xml"], device="cpu")
    assert not any((base / "ckpt").iterdir())  # no training state, no snapshot


@pytest.mark.parametrize("ends", ["returns", "raises"])
def test_profile_dir_writes_a_trace(tmp_path, ends):
    """profile_dir traces main()'s run however it ends: a run of no
    training steps (num_timesteps 0), and one whose trainer refuses its
    widths once the env and its clip are built (8 rows per minibatch over 5
    envs)."""
    extra = ["train.num_timesteps=0"] if ends == "returns" else ["train.num_envs=5"]
    argv = CUTS + [f"paths.base_dir={tmp_path}/run", f"paths.data_dir={tmp_path}/data",
                   f"profile_dir={tmp_path}/trace", *extra]
    if ends == "returns":
        tdriver.main(argv, device="cpu")
    else:
        with pytest.raises(ValueError, match="divide"):
            tdriver.main(argv, device="cpu")
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_contact_force_demo_runs_on_the_rodent_stand_in(tmp_path, capsys):
    path = contact_force_demo.main(["rodent", "--steps", "3", "--video",
                                    str(tmp_path / "cf.avi"), "--device", "cpu"])
    assert tvideo.count_frames(path) == 3
    assert "active contacts" in capsys.readouterr().out


def test_env_rollout_demo_runs_on_the_fly_stand_in(tmp_path, capsys):
    env_rollout_demo.main(["fly", "--steps", "2", "--video", str(tmp_path / "er.avi"),
                           "--contacts", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "nq=36" in out and "contacts at final step" in out
    path = out.split("video: ")[-1].strip()
    assert tvideo.count_frames(path) == 3


@pytest.mark.parametrize("name", ["policy_replay", "env_rollout_demo", "contact_force_demo"])
def test_examples_run_as_modules(name):
    out = subprocess.run([sys.executable, "-m", f"brax_tracking_tpu_torch.examples.{name}",
                          "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout, out.stderr
