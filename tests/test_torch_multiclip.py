"""Multi-clip tracking, the clip cache and stac ingestion of the port
against the JAX package, float64 on the CPU.

- The env: 3 stacked synthetic minirat clips (qpos0 walking 1 m in three
  directions over 64 frames), 8 envs pinned to clips [0, 1, 2, 0, 1, 2, 2,
  1]. The JAX side resets by its vmapped ``reset_to_clip`` under ``wrap``;
  the port starts from the same state (``init_state`` with the clip
  indices) under its ``wrap``. 5 control steps (a frame roll-over at every
  step, too-far terminations from step 1, truncation at step 3) must agree
  as ``tests/test_torch_env.py`` holds the single-clip env: atol 1e-10 +
  rtol 1e-9 on obs, reward, metrics and the distance infos; done, the
  clocks and ``clip_idx`` exactly.

  The JAX mixin's ``reset`` and ``reset_to_clip`` reach its
  ``reset_to_frame``, which pins clip 0 while the reset observation is
  built (tracking.py:493), so its reset observation (and the
  auto-reset snapshot of it) reads clip 0's reference whatever the env's
  clip. The port reads each env's own clip there, as every step does; the
  JAX side here builds its reset observation under the pinned clip so the
  two compute the same thing (ROADMAP C).
- The clip cache: the committed ``data/Minirat/clips/0.p`` (a pickle of the
  JAX package's ``ReferenceClip``) read by the port equals the JAX
  ``load_clip`` exactly; the ``.npz`` round trip is exact; the driver's
  synthetic clip 0, built by the port in float64, matches the float32 file
  within FILE_ATOL (float32 rounding of positions ~0.2 m is ~1.5e-8, and
  the finite-difference velocities divide it by dt = 0.02).
- Stac ingestion on a synthetic minirat export in the layouts the JAX
  package accepts (flat, nested, snips; pickle and h5): ``load_stac_qpos``
  exactly, ``process_clip_to_train`` within atol 1e-12 (both float64).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tracking_tpu.data import clips as jclips
from brax_tracking_tpu.data import h5io as jh5io
from brax_tracking_tpu.envs import tracking as jtracking
from brax_tracking_tpu.envs import wrappers as jwrappers
from brax_tracking_tpu.physics import spec as jspec
from brax_tracking_tpu_torch.data import clips as tclips
from brax_tracking_tpu_torch.data import h5io as th5io
from brax_tracking_tpu_torch.envs import registry
from brax_tracking_tpu_torch.envs import tracking as ttracking
from brax_tracking_tpu_torch.envs import wrappers as twrappers
from brax_tracking_tpu_torch.harness import config as tconfig
from brax_tracking_tpu_torch.harness import driver as tdriver
from brax_tracking_tpu_torch.physics import spec as tspec

ENV_ARGS = tconfig.load_config(["dataset=minirat"])["dataset"]["env_args"]

ATOL, RTOL = 1e-10, 1e-9
B, STEPS, EPISODE = 8, 5, 3
CLIP_IDX = np.array([0, 1, 2, 0, 1, 2, 2, 1], np.int32)
N_CLIPS = 3
FILE_ATOL = 5e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINIRAT_CLIP = os.path.join(REPO, "data", "Minirat", "clips", "0.p")


def _walk(qpos0, ang, T=64, dist=1.0):
    q = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    q[:, 2] += 0.01
    q[:, 0] += np.cos(ang) * np.linspace(0.0, dist, T)
    q[:, 1] += np.sin(ang) * np.linspace(0.0, dist, T)
    return q


class _PinnedMultiClip(jtracking.GenericMultiClip):
    """``reset((clip_idx, key))`` is ``reset_to_clip``, its reset
    observation read from the pinned clip (see the module docstring)."""

    def reset(self, rng):
        clip_idx, key = rng
        return self.reset_to_clip(clip_idx, key)

    def reset_to_frame(self, start_frame, rng1, rng2):
        return jtracking.TrackingEnv.reset_to_frame(self, start_frame, rng1, rng2)


@pytest.fixture(scope="module")
def jax_model():
    return jspec.build_model(
        "builtin:minirat.xml", solver="cg", iterations=4, ls_iterations=4, dtype=jnp.float64
    )


@pytest.fixture(scope="module")
def rollouts(jax_model):
    qs = [_walk(jax_model.qpos0, 2 * np.pi * i / N_CLIPS) for i in range(N_CLIPS)]
    proc = jax.jit(lambda q: jclips.process_clip(jax_model, q))
    jclip = jclips.stack_clips([proc(jnp.asarray(q)) for q in qs])
    jenv = jwrappers.wrap(
        _PinnedMultiClip(reference_clip=jclip, dtype=jnp.float64, **ENV_ARGS),
        episode_length=EPISODE,
    )
    tm = tspec.load_model(device="cpu")
    tclip = tclips.stack_clips([tclips.process_clip(tm, torch.as_tensor(q)) for q in qs])
    tenv = twrappers.wrap(
        ttracking.GenericMultiClip(reference_clip=tclip, device="cpu", **ENV_ARGS),
        episode_length=EPISODE,
    )

    js = jax.jit(jenv.reset)((jnp.asarray(CLIP_IDX), jax.random.split(jax.random.PRNGKey(0), B)))
    ts = tenv.init_state(
        torch.as_tensor(np.array(js.info["cur_frame"])),
        torch.as_tensor(np.array(js.pipeline_state.qpos)),
        torch.as_tensor(np.array(js.pipeline_state.qvel)),
        torch.as_tensor(np.array(js.info["clip_idx"])),
    )
    out = [(js, ts)]
    rng = np.random.RandomState(1)
    jstep = jax.jit(jenv.step)
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (B, tenv.action_size))
        js = jstep(js, jnp.asarray(a))
        ts = tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return out


def _close(j, t, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **kw)


@pytest.mark.parametrize("k", range(STEPS + 1))
def test_multiclip_step_matches(rollouts, k):
    js, ts = rollouts[k]
    _close(js.obs, ts.obs, atol=ATOL, rtol=RTOL)
    _close(js.reward, ts.reward, atol=ATOL, rtol=RTOL)
    _close(js.done, ts.done, atol=0, rtol=0)
    assert js.metrics.keys() == ts.metrics.keys()
    for key in js.metrics:
        _close(js.metrics[key], ts.metrics[key], atol=ATOL, rtol=RTOL)
    for key in ("summed_pos_distance", "quat_distance", "joint_distance"):
        _close(js.info[key], ts.info[key], atol=ATOL, rtol=RTOL)
    for key in ("cur_frame", "steps_taken_cur_frame", "steps", "truncation", "clip_idx"):
        _close(js.info[key], ts.info[key], atol=0, rtol=0)
    assert ts.info["clip_idx"].dtype == torch.int32


def test_multiclip_rollout_covers_rollover_and_done(rollouts):
    frames = np.stack([np.asarray(js.info["cur_frame"]) for js, _ in rollouts])
    dones = np.stack([np.asarray(js.done) for js, _ in rollouts[1:]])
    assert (np.diff(frames[:2], axis=0) == 1).any()  # a frame roll-over
    assert dones[: EPISODE - 1].any() and not dones[: EPISODE - 1].all()  # early done
    assert dones[EPISODE - 1].all()  # truncation
    assert (frames[1:] != frames[:1]).any(axis=0).sum() >= 4


def test_multiclip_resets_draw_and_pin_clips():
    tm = tspec.load_model(device="cpu")
    qs = [_walk(tm.qpos0.numpy(), 2 * np.pi * i / N_CLIPS, T=16) for i in range(N_CLIPS)]
    clip = tclips.stack_clips([tclips.process_clip(tm, torch.as_tensor(q)) for q in qs])
    env = registry.get_environment("multi_clip_tracking", reference_clip=clip, device="cpu",
                                   **ENV_ARGS)
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 64)
    assert sorted(set(state.info["clip_idx"].tolist())) == [0, 1, 2]
    idx = torch.tensor([2, 1, 0, 2], dtype=torch.int32)
    assert torch.equal(env.reset_to_clip(idx, gen).info["clip_idx"], idx)
    pinned = twrappers.RenderRolloutWrapperTracking(env).reset(gen, 3)
    assert pinned.info["clip_idx"].tolist() == [0, 0, 0]
    assert pinned.info["cur_frame"].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="clip indices"):
        env.reset_to_clip(torch.tensor([3]), gen)
    with pytest.raises(ValueError, match="stacked"):
        registry.get_environment("multi_clip_tracking", reference_clip=tclips.process_clip(
            tm, torch.as_tensor(qs[0])), device="cpu", **ENV_ARGS)


@pytest.mark.parametrize("name,item", [
    ("rodent_single_clip", None), ("rodent_multi_clip", None),
    ("fly_single_clip", None), ("fly_single_clip_freejnt", None),
])
def test_registry_unported_envs_raise(name, item):
    """Every name the JAX registry holds is ported: the rodent's and the
    fly's names resolve to the port's classes (built on their stand-ins in
    tests/test_torch_rodent_env.py and tests/test_torch_fly_env.py), and
    the registry knows no name the JAX one does not."""
    from brax_tracking_tpu.envs import registry as jregistry
    from brax_tracking_tpu_torch.envs import fly, rodent

    assert item is None
    cls = registry.lookup(name)
    assert cls is {"rodent_single_clip": rodent.RodentSingleClip,
                   "rodent_multi_clip": rodent.RodentMultiClip,
                   "fly_single_clip": fly.FlyTethered,
                   "fly_single_clip_freejnt": fly.FlyFreeJoint}[name]
    assert sorted(registry._REGISTRY) == sorted(jregistry._REGISTRY)


def test_registry_unknown_env_raises():
    with pytest.raises(KeyError, match="single_clip_tracking"):
        registry.get_environment("no_such_env")
    assert registry.lookup("single_clip_tracking") is ttracking.GenericSingleClip


# ---------------------------------------------------------------------------
# clip cache
# ---------------------------------------------------------------------------


def _fields(clip):
    return {k: v for k, v in vars(clip).items() if v is not None}


def test_load_committed_jax_clip_exactly():
    jclip = jclips.load_clip(MINIRAT_CLIP)
    tclip = tclips.load_clip(MINIRAT_CLIP)
    jf, tf = _fields(jclip), _fields(tclip)
    assert jf.keys() == tf.keys() and len(tf) == 8
    for k in jf:
        assert tf[k].dtype == torch.float32
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)


def test_npz_round_trip_and_stack(tmp_path):
    clip = tclips.load_clip(MINIRAT_CLIP)
    path = str(tmp_path / "0.npz")
    tclips.save_clip(path, clip)
    back = tclips.load_clip(path)
    for k, v in _fields(clip).items():
        assert torch.equal(getattr(back, k), v), k
    with pytest.raises(ValueError, match="npz"):
        tclips.save_clip(str(tmp_path / "0.p"), clip)

    other = clip.replace(position=clip.position + 1.0)
    tstack = tclips.stack_clips([clip, other, clip])
    jstack = jclips.stack_clips([jclips.load_clip(MINIRAT_CLIP)] * 3)
    for k, v in _fields(tstack).items():
        assert v.shape == np.asarray(getattr(jstack, k)).shape, k
    assert torch.equal(tstack.position[1], clip.position + 1.0)
    with pytest.raises(ValueError, match="position"):
        tclips.stack_clips([clip, clip.replace(position=None)])


def test_synthetic_clip_matches_committed_file(tmp_path):
    """The driver's synthetic clip 0 (configs/dataset/minirat.yaml) built by
    the port in float64, against the JAX-built float32 cache file."""
    cfg = tconfig.load_config(["dataset=minirat", f"paths.data_dir={tmp_path}"])
    model = tspec.load_model(device="cpu")
    built = tdriver._build_one_clip(cfg, model, 0)
    assert os.path.exists(tmp_path / "clips" / "0.npz")
    ref = tclips.load_clip(MINIRAT_CLIP)
    for k, v in _fields(ref).items():
        np.testing.assert_allclose(getattr(built, k).numpy(), v.double().numpy(), atol=FILE_ATOL,
                                   rtol=0, err_msg=k)
    cached = tdriver._build_one_clip(cfg, model, 0)  # the cache now
    for k, v in _fields(built).items():
        assert torch.equal(getattr(cached, k), v), k


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


def test_unpickler_refuses_foreign_globals(tmp_path):
    path = str(tmp_path / "evil.p")
    with open(path, "wb") as f:
        pickle.dump({"qpos": _Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|os.getcwd|refusing"):
        tclips.load_clip(path)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tclips.load_stac_qpos(path)


def test_h5_reference_clip_from_jax(tmp_path):
    jclip = jclips.load_clip(MINIRAT_CLIP)
    path = str(tmp_path / "clips.h5")
    jh5io.save_reference_clip(path, ["a", "b"], jclips.stack_clips([jclip, jclip]))
    back = th5io.load_reference_clip(path, ["a", "b"])
    for k, v in _fields(jclip).items():
        np.testing.assert_array_equal(getattr(back, k)[1].numpy(), np.asarray(v), err_msg=k)
    th5io.save_reference_clip(str(tmp_path / "one.h5"), "a", tclips.load_clip(MINIRAT_CLIP))
    one = jh5io.load_reference_clip(str(tmp_path / "one.h5"), "a")
    np.testing.assert_array_equal(np.asarray(one.joints), np.asarray(jclip.joints))


# ---------------------------------------------------------------------------
# stac ingestion
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stac_qpos(jax_model):
    """A moving minirat trajectory: the root walks and turns, the hips
    swing."""
    T = 24
    t = np.linspace(0.0, 1.0, T)
    q = np.tile(np.asarray(jax_model.qpos0, np.float64), (T, 1))
    q[:, 0] += 0.3 * t
    q[:, 2] += 0.01 + 0.005 * np.sin(6 * t)
    yaw = 0.8 * t
    q[:, 3:7] = np.stack([np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)], -1)
    q[:, 7:] += 0.3 * np.sin(9 * t[:, None] + np.arange(q.shape[1] - 7))
    return q


LAYOUTS = {
    "flat": lambda q: {"qpos": q, "n_frames": q.shape[0]},
    "nested": lambda q: {"stac": {"qpos": q, "names": {"n": 3}}},
    "snips": lambda q: {"snip_1": {"qpos": q[10:]}, "snip_0": {"qpos": q[:10]}},
}


def _write(tmp_path, layout, q, ext):
    path = str(tmp_path / f"stac_{layout}{ext}")
    data = LAYOUTS[layout](q)
    if ext == ".h5":
        th5io.save(path, data)
    else:
        with open(path, "wb") as f:
            pickle.dump(data, f)
    return path


@pytest.mark.parametrize("ext", [".p", ".h5"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_stac_qpos_layouts(tmp_path, stac_qpos, layout, ext):
    path = _write(tmp_path, layout, stac_qpos, ext)
    got = tclips.load_stac_qpos(path, nq=stac_qpos.shape[1])
    np.testing.assert_array_equal(got, jclips.load_stac_qpos(path, nq=stac_qpos.shape[1]))
    np.testing.assert_array_equal(got, stac_qpos)


def test_process_clip_to_train_matches_jax(tmp_path, monkeypatch, jax_model, stac_qpos):
    # the JAX side's per-frame kinematics jitted (eager vmap costs seconds)
    process = jclips.process_clip
    monkeypatch.setattr(jclips, "process_clip", lambda m, q, max_qvel, dt: jax.jit(
        lambda q: process(m, q, max_qvel=max_qvel, dt=dt))(q))
    bad = stac_qpos.copy()
    bad[7, :] = np.nan
    bad[12, 3:7] = np.nan
    path = _write(tmp_path, "flat", bad, ".h5")
    kw = dict(start_step=2, clip_length=20, dt=0.02, max_qvel=5.0, nan_policy="interpolate")
    jclip = jclips.process_clip_to_train(path, jax_model, **kw)
    tclip = tclips.process_clip_to_train(path, tspec.load_model(device="cpu"), **kw)
    jf, tf = _fields(jclip), _fields(tclip)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), atol=1e-12, rtol=0,
                                   err_msg=k)


def test_clean_stac_qpos_matches_jax(stac_qpos):
    bad = stac_qpos.copy()
    bad[0, 1] = np.nan
    bad[5, 3:9] = np.nan
    np.testing.assert_array_equal(
        tclips.clean_stac_qpos(bad, "interpolate", quat_cols=(3,)),
        np.asarray(jclips.clean_stac_qpos(bad, "interpolate", quat_cols=(3,))),
    )
    for args, match in (((bad,), "interpolate"), ((bad, "fill"), "unknown"),
                        ((np.full_like(bad, np.nan), "interpolate"), "refusing")):
        with pytest.raises(ValueError, match=match):
            jclips.clean_stac_qpos(*args)
        with pytest.raises(ValueError, match=match):
            tclips.clean_stac_qpos(*args)


@pytest.mark.parametrize("case", ["no_qpos", "rank", "ints", "widths", "nq", "range"])
def test_stac_errors_match_jax(tmp_path, jax_model, stac_qpos, case):
    q = stac_qpos
    data, call, err = {
        "no_qpos": ({"positions": np.zeros((4, 3))}, "load", KeyError),
        "rank": ({"qpos": np.zeros((4, 3, 2))}, "load", ValueError),
        "ints": ({"qpos": np.zeros((4, 9), np.int32)}, "load", ValueError),
        "widths": ({"a": {"qpos": q[:5]}, "b": {"qpos": q[:5, :-1]}}, "load", ValueError),
        "nq": ({"qpos": q[:, :-2]}, "process", ValueError),
        "range": ({"qpos": q}, "process", ValueError),
    }[case]
    path = str(tmp_path / "bad.h5")
    th5io.save(path, data)
    for C, model in ((jclips, jax_model), (tclips, tspec.load_model(device="cpu"))):
        with pytest.raises(err):
            if call == "load":
                C.load_stac_qpos(path)
            else:
                C.process_clip_to_train(path, model, start_step=q.shape[0] - 4, clip_length=8)
