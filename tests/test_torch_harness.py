"""The port's harness (config, metrics, driver) and param snapshots against
the JAX package, on the CPU.

- Config: the port's YAML reader gives what ``yaml.safe_load`` gives on
  every file of its configs (byte copies of the JAX package's);
  ``load_config`` gives what the JAX ``load_config`` gives; ``save_config``
  round trips through both readers; the driver imports without ``yaml``.
- Driver: ``main(..., device="cpu")`` in a temporary directory, the smoke
  config cut to one training step, a 4-step eval episode and a 16-frame
  clip (so 11 control steps in the callback's rollouts), because an eager
  control step of the minirat costs ~0.2 s on the CPU. It writes every
  artifact and logs exactly the metric keys the JAX driver logs for the
  same run (listed below from harness/driver.py, training/acting.py and
  agents/ppo/losses.py); with two clips also ``eval/episode_reward_clip0..1``
  (that run without matplotlib, as on the card: the CSV and no PNG).
- Param snapshots: a (256, 256) policy initialised by the JAX package and
  pickled by its ``save_params`` acts the same in the port, within 1e-12
  (float64).
- ``debug_nans=true`` and ``BTT_DEBUG_NANS=1`` run the cut driver with the
  mode on (training/debug_nans.py; its parity with the JAX package:
  tests/test_torch_debug_nans.py): every checked call of the run sees it
  on, the run trains and writes its files, and the mode is off again after
  ``main()`` (the video and the profile trace: tests/test_torch_render.py);
  a default ``main()`` without a card raises.
"""

import ast
import glob
import importlib
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.harness import config as jconfig
from brax_tracking_tpu.training import checkpoint as jcheckpoint
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.harness import config as tconfig
from brax_tracking_tpu_torch.harness import driver as tdriver
from brax_tracking_tpu_torch.physics import spec as tspec
from brax_tracking_tpu_torch.harness import eval_plots
from brax_tracking_tpu_torch.harness import metrics as tmetrics
from brax_tracking_tpu_torch.training import checkpoint as tcheckpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "brax_tracking_tpu_torch")
CONFIGS = sorted(glob.glob(os.path.join(PORT, "configs", "**", "*.yaml"), recursive=True))

# the argvs of tests/test_harness.py, the smoke run and two resolver cases
ARGVS = [
    [],
    ["train=smoke", "dataset=minirat", "train.num_envs=4", "seed=7"],
    ["version=v3"],
    ["dataset=fly", "train=train_fly"],
    ["dataset=minirat", "train=smoke", "seed=7", "train.num_envs=4"],
    ["dataset=rodent_multiclip", "train=train_rodent_multiclip", "train.learning_rate=1e-3",
     "train.mlp_policy_layer_sizes=[32, 32]", "train.note='a # b'"],
    ["paths=local", "paths.user=${env:BTT_HARNESS_TEST_VAR,fallback}",
     "train.note=${oc.env:BTT_HARNESS_TEST_VAR}"],
]

# the driver's cuts (see the module docstring) and its metric names
CUTS = ["train=smoke", "dataset=minirat", "train.num_timesteps=64", "train.eval_every=64",
        "train.episode_length=4", "dataset.clip_length=16"]
_ENV_METRICS = ("pos_reward", "quat_reward", "joint_reward", "angvel_reward", "bodypos_reward",
                "endeff_reward", "reward_quadctrl", "reward_alive", "too_far", "bad_pose",
                "bad_quat", "fall")
JAX_DRIVER_KEYS = (
    # train(): the epoch's training metrics (agents/ppo/train.py, losses.py)
    {"training/sps", "training/walltime", "training/total_loss", "training/policy_loss",
     "training/v_loss", "training/entropy_loss"}
    # the eval (training/acting.py Evaluator)
    | {f"eval/episode_{k}{s}" for k in _ENV_METRICS + ("reward",) for s in ("", "_std")}
    | {"eval/avg_episode_length", "eval/epoch_eval_time", "eval/sps", "eval/walltime"}
    # the callback (harness/driver.py) and eval_plots' artifacts
    | {f"rollout/{k}_{s}" for k in _ENV_METRICS for s in ("mean", "min")}
    | {"rollout/summed_pos_distance_mean", "rollout/perframe_csv",
       "rollout/perframe_rewards_png", "rollout/thorax_height_png"}
    | {"final_params"}
)


@pytest.fixture(autouse=True)
def _wandb_off(monkeypatch):
    """Where wandb is installed, it runs as a no-op (the driver's logger
    calls wandb.init wherever wandb imports)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, PORT))
def test_config_files_read_as_yaml_reads_them(path):
    with open(path) as f:
        text = f.read()
    assert tconfig.yaml_loads(text) == yaml.safe_load(text)
    jax_copy = os.path.join(REPO, "brax_tracking_tpu", os.path.relpath(path, PORT))
    with open(jax_copy) as f:
        assert f.read() == text


def test_config_files_are_all_copied():
    jax_files = glob.glob(os.path.join(REPO, "brax_tracking_tpu", "configs", "**", "*.yaml"),
                          recursive=True)
    assert len(CONFIGS) == len(jax_files) == 14


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_load_config_matches_jax(argv, monkeypatch):
    monkeypatch.setenv("BTT_HARNESS_TEST_VAR", "from-env")
    cfg = tconfig.load_config(argv)
    assert cfg == jconfig.load_config(argv)
    text = tconfig.yaml_dumps(cfg)
    assert yaml.safe_load(text) == cfg == tconfig.yaml_loads(text)


def test_config_values():
    cfg = tconfig.load_config(ARGVS[5])
    assert cfg["train"]["learning_rate"] == "1e-3"  # no dot: a string in YAML 1.1
    assert cfg["train"]["num_timesteps"] == 3_000_000_000
    assert cfg["train"]["mlp_policy_layer_sizes"] == [32, 32]
    assert cfg["train"]["note"] == "a # b"
    assert cfg["train"]["version"] == "debug"
    assert cfg["compilation_cache_dir"] == "~/.cache/btt_jax_cache"
    assert cfg["dataset"]["n_clips"] == 8


def test_env_resolver(monkeypatch):
    argv = ARGVS[6]
    monkeypatch.delenv("BTT_HARNESS_TEST_VAR", raising=False)
    cfg = tconfig.load_config(argv)
    assert (cfg["paths"]["user"], cfg["train"]["note"]) == ("fallback", "")
    assert cfg == jconfig.load_config(argv)
    monkeypatch.setenv("BTT_HARNESS_TEST_VAR", "x")
    assert tconfig.load_config(argv)["paths"]["user"] == "x"


def test_config_errors():
    with pytest.raises(tconfig.ConfigError, match="unknown dataset config"):
        tconfig.load_config(["dataset=nonexistent"])
    with pytest.raises(tconfig.ConfigError, match="key=value"):
        tconfig.load_config(["seed"])
    for text in ("a: &x 1", "a: !!str 1", "a: |\n  x", "a: {b: 1}", "a: 2001-12-14",
                 "a:\n  b\n  c", "a: 'open"):
        with pytest.raises(tconfig.ConfigError):
            tconfig.yaml_loads(text)


def test_save_config_round_trip(tmp_path):
    cfg = tconfig.load_config(["dataset=fly", "train=train_fly", "seed=3"])
    cfg["extra"] = {"floats": [1e-5, 1e16, -0.05, float("inf")], "none": None, "empty": [],
                    "nested": [[1, 2], {"k": "it's"}], "tricky": ["3e-4", "true", "", "~",
                                                                   "a: b", "#c", "- x"]}
    path = str(tmp_path / "run_config.yaml")
    tconfig.save_config(cfg, path)
    with open(path) as f:
        assert yaml.safe_load(f) == cfg
    assert tconfig.read_yaml(path) == cfg


def test_harness_imports_without_yaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    for name in [m for m in sys.modules if m.startswith("brax_tracking_tpu_torch.harness")]:
        monkeypatch.delitem(sys.modules, name)
    cfg_mod = importlib.import_module("brax_tracking_tpu_torch.harness.config")
    importlib.import_module("brax_tracking_tpu_torch.harness.driver")
    assert cfg_mod.load_config(["dataset=minirat"])["dataset"]["name"] == "Minirat"


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_harness_imports_no_jax_or_yaml():
    files = glob.glob(os.path.join(PORT, "harness", "*.py")) + [
        os.path.join(PORT, "envs", "registry.py"), os.path.join(PORT, "data", "h5io.py"),
        os.path.join(PORT, "data", "pickles.py"), os.path.join(PORT, "data", "clips.py"),
        os.path.join(REPO, "chip_smoke.py")]
    assert len(files) == 12  # harness/launch.py since the data-parallel slice
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "jax", "jaxlib", "brax_tracking_tpu", "flax", "optax", "orbax", "yaml"), (path, mod)


def test_metrics_logger_plain_values(tmp_path):
    logger = tmetrics.MetricsLogger("p", "r", str(tmp_path), config={"a": 1}, use_wandb=False)
    logger.log({"t": torch.tensor(2.5), "n": np.float32(1.5), "v": torch.arange(3),
                "s": "x"}, step=7)
    logger.finish()
    lines = [json.loads(line) for line in open(logger.path)]
    assert lines[0]["_config"] == {"a": 1}
    assert {k: lines[1][k] for k in ("t", "n", "v", "s", "_step")} == {
        "t": 2.5, "n": 1.5, "v": [0, 1, 2], "s": "x", "_step": 7}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _run(tmp_path, extra=()):
    base, data = tmp_path / "run", tmp_path / "data"
    argv = CUTS + [f"paths.base_dir={base}", f"paths.data_dir={data}", *extra]
    metrics = tdriver.main(argv, device="cpu")
    records = [json.loads(line) for line in open(base / "logs" / "metrics.jsonl")]
    return argv, metrics, base, data, records


def _logged_keys(records):
    return {k for r in records for k in r if not k.startswith("_")}


def test_driver_single_clip(tmp_path):
    argv, metrics, base, data, records = _run(tmp_path)
    assert "eval/episode_reward" in metrics and "training/sps" in metrics
    run = "single_clip_tracking_track_smoke"
    for rel in ("run_config.yaml", "logs/metrics.jsonl", "ckpt/64/training_state.pt",
                f"ckpt/{run}/64", f"ckpt/{run}/final", f"ckpt/{run}/rollout_64.p",
                "figures/perframe_64.csv"):
        assert (base / rel).is_file(), rel
    assert (data / "clips" / "0.npz").is_file()
    assert _logged_keys(records) == JAX_DRIVER_KEYS
    cfg = tconfig.load_config(argv)
    assert tconfig.read_yaml(str(base / "run_config.yaml")) == cfg == records[0]["_config"]
    for r in records[1:]:
        for k, v in r.items():
            if isinstance(v, float):
                assert np.isfinite(v), k
    # the rollout table: one entry per control step of the clip
    with open(base / "ckpt" / run / "rollout_64.p", "rb") as f:
        table = pickle.load(f)
    assert set(table) == set(_ENV_METRICS) and {v.shape for v in table.values()} == {(11,)}
    csv_rows = open(base / "figures" / "perframe_64.csv").read().splitlines()
    assert len(csv_rows) == 1 + 12  # header, reset + 11 steps (thorax height)
    # the snapshot loads back as the policy's params
    normalizer, policy = tcheckpoint.load_policy(str(base / "ckpt" / run / "final"),
                                                 device="cpu")
    assert [layer.out_features for layer in policy.layers] == [64, 64, 2 * 4]


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


def test_driver_needs_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdriver.main(CUTS + [f"paths.base_dir={tmp_path}/r"])
    assert not (tmp_path / "r").exists()


# ---------------------------------------------------------------------------
# param snapshots of the JAX package
# ---------------------------------------------------------------------------


def test_jax_param_snapshot_acts_the_same(tmp_path):
    obs_size, action_size, hidden = 57, 4, (256, 256)
    rng = np.random.RandomState(0)
    net = jnetworks.make_ppo_networks(obs_size, action_size,
                                      preprocess_observations_fn=jrs.normalize,
                                      policy_hidden_layer_sizes=hidden)
    policy = jax.tree.map(lambda x: x.astype(jnp.float64),
                          net.policy_network.init(jax.random.PRNGKey(3)))
    normalizer = jrs.update(jrs.init_state(jnp.zeros(obs_size, jnp.float64)),
                            jnp.asarray(rng.normal(1.0, 2.0, (64, obs_size))))
    path = str(tmp_path / "params")
    jcheckpoint.save_params(path, (normalizer, policy))

    obs = rng.normal(1.0, 2.0, (16, obs_size))
    want, _ = jnetworks.make_inference_fn(net)((normalizer, policy), deterministic=True)(
        jnp.asarray(obs), jax.random.PRNGKey(0))

    params = tcheckpoint.load_policy(path, device="cpu")
    tnet = tnetworks.make_ppo_networks(obs_size, action_size, tnetworks.normalize_preprocessor,
                                       hidden, hidden, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    got, _ = tnetworks.make_inference_fn(tnet)(params, deterministic=True)(
        torch.as_tensor(obs), None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-12, rtol=0)
    assert [layer.in_features for layer in params[1].layers] == [obs_size, 256, 256]
