"""The fly stand-in's clips and driver (ROADMAP A.9) on the CPU in float64
(the rest of its pieces: tests/test_torch_fly.py, whose helpers this file
shares):

- the stac exports through ``process_clip_to_train`` against the JAX clips;
- the driver on the CPU for both fly configs, cut to one training step.
"""

import os

import numpy as np
import pytest

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu_torch.physics import spec as tspec
from test_torch_fly import FILES, PARAMS, STACS, STAGE_ATOL, _jax_clip, _jax_model


@PARAMS
def test_stac_clip_matches_jax(free):
    """Each export through process_clip_to_train against the JAX package's
    clip of the same frames at 1e-12; the export is a MuJoCo C rollout of
    the free stand-in (250 frames), its tethered file the same qpos less
    the root columns. A full-width export on the tethered model is read as
    wide as it is, by both packages (ROADMAP C)."""
    from brax_tracking_tpu_torch.data import clips as tclips

    jm = _jax_model(free)
    tm = tspec.load_model(FILES[free], device="cpu")
    t = tclips.process_clip_to_train(STACS[free], tm, start_step=24, clip_length=48)
    j = _jax_clip(STACS[free], jm, start_step=24, clip_length=48)
    for f in ("position", "quaternion", "joints", "body_positions", "body_quaternions",
              "velocity", "angular_velocity", "joints_velocity"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None) == (f in ("position", "quaternion") and not free), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STAGE_ATOL, rtol=0,
                                       err_msg=f)
    full = tclips.load_stac_qpos(tspec.FLY_STANDIN_STAC)
    np.testing.assert_array_equal(tclips.load_stac_qpos(tspec.FLY_STANDIN_TETHERED_STAC),
                                  full[:, 7:])
    assert full.shape == (250, 43) and np.abs(np.diff(full, axis=0)).max() > 1e-3
    if not free:
        wide = tclips.process_clip_to_train(tspec.FLY_STANDIN_STAC, tm, clip_length=8)
        assert wide.joints.shape == tuple(
            _jax_clip(tspec.FLY_STANDIN_STAC, jm, clip_length=8).joints.shape) == (8, 43)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRIVER_CUTS = ["dataset.env_args.mjcf_path=builtin:fly_standin.xml",
               "train.num_envs=8", "train.batch_size=8", "train.num_eval_envs=4",
               "train.unroll_length=4", "train.num_minibatches=2",
               "train.num_updates_per_batch=1", "train.num_timesteps=64",
               "train.eval_every=64", "train.force_episode_length=true",
               "train.episode_length=2", "dataset.clip_length=6"]


@pytest.mark.parametrize("train,dataset", [("train_fly", "fly"),
                                           ("train_fly_freejnt", "fly_freejnt")])
def test_driver_trains_the_fly_on_cpu(tmp_path, monkeypatch, train, dataset):
    """Both fly commands on the stand-in, cut to one training step of 8
    envs, the clip from the stand-in's stac export for the config's width:
    the clip built through the frozen model and cached, every artifact,
    finite logged numbers."""
    import json

    from brax_tracking_tpu_torch.harness import driver

    monkeypatch.setenv("WANDB_MODE", "disabled")
    free = dataset == "fly_freejnt"
    base = tmp_path / "r"
    metrics = driver.main([f"train={train}", f"dataset={dataset}", *DRIVER_CUTS,
                           f"dataset.stac_path={STACS[free]}", f"paths.base_dir={base}",
                           f"paths.data_dir={tmp_path}/d"], device="cpu")
    assert os.listdir(tmp_path / "d" / "clips") == ["0.npz"]
    assert metrics["training/sps"] > 0 and np.isfinite(metrics["eval/episode_reward"])
    run = f"fly_single_clip{'_freejnt' if free else ''}_track_debug"
    for p in ("run_config.yaml", "logs/metrics.jsonl", "ckpt/64/training_state.pt",
              f"ckpt/{run}/64", f"ckpt/{run}/final", f"ckpt/{run}/rollout_64.p",
              "figures/perframe_64.csv"):
        assert (base / p).is_file(), p
    for line in (base / "logs" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert all(np.isfinite(v) for v in rec.values() if isinstance(v, float)), rec
