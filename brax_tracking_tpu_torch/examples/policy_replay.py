"""Offline policy replay with the eval deep-dive artifacts.

Counterpart of ``examples/policy_replay.py``: load a driver run's config
snapshot and a saved policy, roll the deterministic policy on the tracking
env with the driver's eval callback, and write its per-frame reward table
and CSV, the reward and thorax-height figures and, with ``--video``, the
rollout-vs-reference video, without retraining.

    python -m brax_tracking_tpu_torch.examples.policy_replay RUN_DIR [--ckpt STEP]
        [--video] [--out DIR] [--device cuda|cpu]

RUN_DIR is a driver ``save_dir`` holding ``run_config.yaml`` and
``ckpt/<run_name>/<step>`` param snapshots (the layout
``harness/driver.py`` writes; the JAX package's snapshots read the same).
The replay runs on the card unless ``--device cpu``; the artifacts go to
RUN_DIR/replay unless ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import os


def latest_checkpoint(ckpt_root: str) -> str:
    """The snapshot ``<ckpt_root>/<run_name>/<step>`` of the largest step."""
    runs = sorted(glob.glob(os.path.join(ckpt_root, "*", "*")))
    steps = [p for p in runs if os.path.basename(p).isdigit()]
    if not steps:
        raise SystemExit(f"no checkpoints under {ckpt_root}")
    return max(steps, key=lambda p: int(os.path.basename(p)))


def main(argv=None) -> str:
    """Runs the replay; returns the artifact directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--ckpt", default=None, help="step number (default: latest)")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--out", default=None, help="artifact dir (default: RUN_DIR/replay)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from brax_tracking_tpu_torch.agents.ppo import networks as ppo_networks
    from brax_tracking_tpu_torch.device import resolve_device
    from brax_tracking_tpu_torch.harness import driver
    from brax_tracking_tpu_torch.harness.config import read_yaml
    from brax_tracking_tpu_torch.harness.metrics import MetricsLogger
    from brax_tracking_tpu_torch.training import checkpoint

    dev = resolve_device(args.device)
    cfg_path = os.path.join(args.run_dir, "run_config.yaml")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"missing {cfg_path}")
    cfg = read_yaml(cfg_path)  # the resolved snapshot main() wrote
    tr = cfg["train"]
    if args.video:
        tr["render_video"] = True

    env = driver.build_env_from_cfg(cfg, dev)

    ckpt_root = cfg["paths"]["ckpt_dir"]
    if args.ckpt:
        run_name = f"{tr['env_name']}_{tr['task_name']}_{tr['version']}"
        ckpt = os.path.join(ckpt_root, run_name, str(args.ckpt))
    else:
        ckpt = latest_checkpoint(ckpt_root)
    print(f"loading params from {ckpt}")
    params = checkpoint.load_policy(ckpt, device=dev)

    # the policy as the trainer's make_policy builds it; make_policy reads
    # the loaded params, so the networks' own weights are never used
    normalize = (ppo_networks.normalize_preprocessor if tr.get("normalize_observations", True)
                 else ppo_networks.identity_preprocessor)
    nets = ppo_networks.make_ppo_networks(
        env.observation_size,
        env.action_size,
        preprocess_observations_fn=normalize,
        policy_hidden_layer_sizes=tuple(tr["mlp_policy_layer_sizes"]),
        value_hidden_layer_sizes=tuple(tr.get("mlp_value_layer_sizes",
                                              tr["mlp_policy_layer_sizes"])),
        generator=torch.Generator(device=dev).manual_seed(0),
        device=dev,
    )
    make_policy = ppo_networks.make_inference_fn(nets)

    out_dir = args.out or os.path.join(args.run_dir, "replay")
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(project="replay", run_name="replay", log_dir=out_dir, config=cfg)
    policy_params_fn = driver._eval_callback(cfg, env, logger, out_dir, fig_dir=out_dir)
    policy_params_fn(int(os.path.basename(ckpt)), make_policy, params)
    logger.finish()
    print(f"replay artifacts written under {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
