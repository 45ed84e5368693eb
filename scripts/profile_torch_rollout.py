"""Where a control step of the PyTorch port's minirat rollout spends its time.

    python3 scripts/profile_torch_rollout.py [--envs 2048] [--steps 3]

Run from the root of a checkout on a machine with a CUDA card. It builds
the same env as chip_smoke.py (GenericSingleClip + wrappers, 10 substeps),
warms up, then profiles ``--steps`` control steps with torch.profiler and
prints one JSON line: wall ms per control step (timed without the
profiler, then with it), device busy ms per control step (sum of the
device times of CUDA kernels and copies; one stream, so they do not
overlap), the device idle share against the unprofiled wall time, device
ops per substep, and the top ops by device time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from brax_tracking_tpu_torch.ops import cg as ops_cg

    card = chip_smoke.card_line()
    print(card)
    ops_cg.build()
    env = chip_smoke.make_env("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = env.reset(gen, args.envs)
    act = lambda: 2.0 * torch.rand(args.envs, env.action_size, generator=gen, device="cuda") - 1.0
    for _ in range(2):  # warmup
        state = env.step(state, act())
    torch.cuda.synchronize()

    acts = [act() for _ in range(args.steps)]
    t0 = time.perf_counter()  # unprofiled wall time of the same work
    for a in acts:
        state = env.step(state, a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    by_name: dict = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    n_sub = args.steps * chip_smoke.N_SUBSTEPS
    print(json.dumps({
        "card": card,
        "envs": args.envs,
        "control_steps": args.steps,
        "wall_ms_per_control_step": wall * 1e3 / args.steps,
        "wall_ms_per_control_step_profiled": wall_profiled * 1e3 / args.steps,
        "device_busy_ms_per_control_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ops_per_substep": len(events) / n_sub,
        "top_device_ops": [
            {"name": k[:80], "count_per_substep": n / n_sub, "ms_per_substep": t / 1e3 / n_sub}
            for k, (n, t) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
