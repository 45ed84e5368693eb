"""The port's driver on the CPU, in more runs (the harness's config,
metrics, single-clip driver run and param snapshots:
tests/test_torch_harness.py, whose cuts and helpers this file shares):

- two clips: the run logs the JAX driver's keys plus
  ``eval/episode_reward_clip0..1``, without matplotlib (the CSV and no
  PNG, as on the card);
- ``debug_nans=true`` and ``BTT_DEBUG_NANS=1`` run the cut driver with the
  mode on (training/debug_nans.py; its parity with the JAX package:
  tests/test_torch_debug_nans.py): every checked call of the run sees it
  on, the run trains and writes its files, and the mode is off again after
  ``main()``;
- a model with a slide joint builds its clip cache and trains.
"""

import json
import os

import numpy as np
import pytest

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu_torch.harness import driver as tdriver
from brax_tracking_tpu_torch.harness import eval_plots
from brax_tracking_tpu_torch.physics import spec as tspec
from test_torch_harness import CUTS, JAX_DRIVER_KEYS, _logged_keys, _run, _wandb_off  # noqa: F401


def test_driver_multi_clip(tmp_path, monkeypatch):
    # as where matplotlib is absent: the CSV and no PNG
    monkeypatch.setattr(eval_plots, "_pyplot", lambda: None)
    _, metrics, base, data, records = _run(
        tmp_path, ["dataset.n_clips=2", "train.env_name=multi_clip_tracking"])
    per_clip = {"eval/episode_reward_clip0", "eval/episode_reward_clip1"}
    pngs = {"rollout/perframe_rewards_png", "rollout/thorax_height_png"}
    assert _logged_keys(records) == (JAX_DRIVER_KEYS - pngs) | per_clip
    assert not list((base / "figures").glob("*.png"))
    logged = {k: v for r in records for k, v in r.items() if k in per_clip}
    assert all(np.isfinite(v) for v in logged.values())
    assert sorted(os.listdir(data / "clips")) == ["0.npz", "1.npz"]


@pytest.mark.parametrize("extra,env", [
    (["debug_nans=true"], {}),
    ([], {"BTT_DEBUG_NANS": "1"}),
])
def test_driver_unported_options_raise(tmp_path, monkeypatch, extra, env):
    """The two switches that raised before debug_nans was ported now run the
    driver with the mode on: each checked call (resets, rollout_step,
    learn_step, eval unrolls) runs with it, the run trains and writes its
    files, nothing raises on the clean run, and the mode is off after it."""
    from brax_tracking_tpu_torch.training import debug_nans

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    plain = debug_nans.call

    def recording(name, fn, *args, **kwargs):
        seen.append((name, debug_nans.enabled()))
        return plain(name, fn, *args, **kwargs)

    monkeypatch.setattr(debug_nans, "call", recording)
    # the clip cut to 8 frames: the callback's rollout takes 3 control steps
    _, metrics, base, _, records = _run(tmp_path, ["dataset.clip_length=8", *extra])
    assert {n for n, _ in seen} == {"the env reset", "rollout_step", "learn_step",
                                    "the evaluator's unroll"}
    assert all(on for _, on in seen) and not debug_nans.enabled()
    run = "single_clip_tracking_track_smoke"
    for rel in ("run_config.yaml", "logs/metrics.jsonl", "ckpt/64/training_state.pt",
                f"ckpt/{run}/final", f"ckpt/{run}/rollout_64.p"):
        assert (base / rel).is_file(), rel
    assert np.isfinite(metrics["eval/episode_reward"]) and records[0]["_config"][
        "debug_nans"] is ("debug_nans=true" in extra)


def test_driver_unported_env_raises_before_building(tmp_path):
    """The env this test pinned, a model with a slide joint, raised (ROADMAP
    A.12) while its clip was built; slide joints are ported now, so the
    driver builds its clip cache and trains on it (a site transmission,
    still not ported, raises at the first step instead:
    test_torch_model.py)."""
    xml = tmp_path / "slide.xml"
    # the minirat with one hip a limited, actuated slide joint
    with open(tspec.MINIRAT_XML) as f:
        text = f.read()
    hip = '<joint name="hip_FL" axis="0 1 0" range="-60 60"/>'
    assert hip in text
    xml.write_text(text.replace(hip, '<joint name="hip_FL" type="slide" axis="0 0 1" '
                                     'range="-0.01 0.01"/>'))
    npz = str(tmp_path / "slide.npz")
    tspec.freeze_mjcf(str(xml), npz)
    base = tmp_path / "r"
    tdriver.main(CUTS + [f"dataset.env_args.mjcf_path={npz}", f"paths.base_dir={base}",
                         f"paths.data_dir={tmp_path}/d"], device="cpu")
    assert (tmp_path / "d" / "clips" / "0.npz").is_file()
    (log,) = base.rglob("metrics.jsonl")
    records = [json.loads(line) for line in open(log)]
    assert any("training/sps" in r for r in records)
    assert all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float))
