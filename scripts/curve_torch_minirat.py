"""Learning curve of the port's PPO trainer on the minirat tracking env.

    python3 scripts/curve_torch_minirat.py [--out DIR] [--seed N]

Trains ``brax_tracking_tpu_torch``'s ``train()`` on the minirat single-clip
tracking env (configs/dataset/minirat.yaml: CG 4/4, 10 substeps, the
driver's synthetic 64-frame clip walking 0.2 m along x, built by
``harness.driver.build_env_from_cfg`` and cached in ``DIR/data``) on the
card in float32, and writes one JSON line per eval to
``DIR/metrics.jsonl`` (default ``runs/curve_torch_minirat``), the first
line the run's config.
Each eval is also printed, with the card's name and power limit.

The config follows the JAX package's CPU curve
(benchmarks/curve_cpu_minirat: MLPs (64, 64), unroll 16, 4 minibatches,
4 updates per batch, episode_length 64, lr 3e-4, entropy 1e-3, discount
0.99, normalized observations, 64 eval envs) at the card's width: 2048
envs and batch 512 (the CPU curve: 128 and 128), 1,048,576 env steps with
an eval every 131,072.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TRAIN = dict(num_envs=2048, batch_size=512, num_minibatches=4, num_updates_per_batch=4,
             unroll_length=16, episode_length=64, learning_rate=3e-4, entropy_cost=1e-3,
             discounting=0.99, clipping_epsilon=0.3, reward_scaling=1.0,
             normalize_observations=True, num_eval_envs=64)
HIDDEN = (64, 64)
NUM_TIMESTEPS, EVAL_EVERY = 1_048_576, 131_072


def make_env(device, data_dir):
    """The driver's minirat env (configs/dataset/minirat.yaml) on its
    synthetic demo clip 0: qpos0 lifted 1 cm, walking 0.2 m along x over 64
    frames, cached under ``data_dir``. Returns (dataset config, env)."""
    from brax_tracking_tpu_torch.harness import config, driver

    cfg = config.load_config(["train=smoke", "dataset=minirat", f"paths.data_dir={data_dir}"])
    return cfg["dataset"], driver.build_env_from_cfg(cfg, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="runs/curve_torch_minirat")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-timesteps", type=int, default=NUM_TIMESTEPS)
    args = p.parse_args(argv)

    from brax_tracking_tpu_torch.agents.ppo import networks, train

    card = chip_smoke.card_line() if torch.device(args.device).type == "cuda" else "cpu"
    print(card, flush=True)
    num_evals = args.num_timesteps // EVAL_EVERY + 1
    os.makedirs(args.out, exist_ok=True)
    dataset, env = make_env(args.device, os.path.join(args.out, "data"))
    path = os.path.join(args.out, "metrics.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"_config": dict(TRAIN, hidden=HIDDEN, num_timesteps=args.num_timesteps,
                                            num_evals=num_evals, seed=args.seed, dataset=dataset,
                                            card=card)}) + "\n")
    t0 = time.perf_counter()

    def progress(step, metrics):
        with open(path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")
        print(f"step {step}: eval/episode_reward {metrics['eval/episode_reward']:.3f}, "
              f"eval/avg_episode_length {metrics['eval/avg_episode_length']:.3f}, training/sps "
              f"{metrics.get('training/sps', float('nan')):.1f}, eval/sps "
              f"{metrics['eval/sps']:.1f}, {time.perf_counter() - t0:.1f} s on {card}",
              flush=True)

    train.train(
        env, num_timesteps=args.num_timesteps, num_evals=num_evals,
        network_factory=functools.partial(networks.make_ppo_networks,
                                          policy_hidden_layer_sizes=HIDDEN,
                                          value_hidden_layer_sizes=HIDDEN),
        progress_fn=progress, seed=args.seed, device=args.device, **TRAIN)
    print(f"curve done in {time.perf_counter() - t0:.1f} s; metrics in {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
