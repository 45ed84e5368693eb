"""Where a step of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_rollout.py [--model minirat] [--envs 2048] [--steps 3]

Run from the root of a checkout on a machine with a CUDA card. ``--model
minirat`` and ``minirat_elliptic`` build the same envs as chip_smoke.py
(GenericSingleClip + wrappers, 10 substeps) and a step is a control step;
so does ``ratpair``: the rodent_pair env on the two-rat stand-in (5
substeps, the solve kernel's layout 2), at 1024 envs unless ``--envs``, and
``rodent_standin``: the flagship rodent_single_clip env on the rodent
stand-in (5 substeps, the wide layout 1 with its damped tail, sensors);
``fly_standin`` and ``fly_standin_tethered``: the fly_single_clip_freejnt
and fly_single_clip envs on the fly stand-in (5 substeps, the one-warp
elliptic instance, the fluid model), their clips from the stac exports;
``rodent_standin_terrain``: the flagship env on the rodent stand-in's
terrain (5 substeps, the narrowphase's box, cylinder, mesh and
height-field pairs every substep); ``rodent_standin_randomized``: the
flagship env with per-env models (chip_smoke.py's ``scaled`` draws of
RAND_LEAVES, the solve kernel with a per-env armature);
``fly_standin_ball``: the fly_single_clip_freejnt env on the ball-coxa fly
stand-in (5 substeps, off the kernel layout: the array CG path with one
``spd_inverse`` per substep and a host read of the done flags per CG
iteration); ``ballmuscle_cg`` and
``ballmuscle_newton`` step chip_smoke.py's posed ballmuscle states,
``minirat_newton`` its seeded Newton minirat states, ``minirat_planar``
the planar minirat's (slide joints) and ``fly_standin_ball_newton`` the
ball fly's Newton copy's (the array Newton path) seeded states, and
``props`` the props from qpos0 with seeded velocities, through
``physics.step``, and a step is
one substep; ``terrain_narrowphase`` and ``props_narrowphase`` run the
narrowphase alone (kinematics and ``collision`` at chip_smoke.py's
pair-gate poses), and a step is one call. It warms up, then profiles
``--steps`` steps with torch.profiler and prints one JSON line. ``--model
minirat_ppo`` profiles training steps of chip_smoke.py's PPO geometry
(``rollout_step`` and ``learn_step``: 2 unrolls of 16 control steps, then
2 passes of 2 minibatch updates through MLPs 256 x 256); a step is one
training step. The line holds: wall ms per step (timed without the
profiler, then with it), device busy ms per step
(sum of the device times of CUDA kernels and copies; one stream, so they
do not overlap), the device idle share against the unprofiled wall time,
device ops and device-to-host reads per substep, the device time per
launch of the port's own kernels, and the top ops by device time.
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


def _ppo_stepper(envs: int):
    """(advance one training step, substeps per training step)."""
    from brax_tracking_tpu_torch.agents.ppo import networks, train
    from brax_tracking_tpu_torch.envs import wrappers

    a = dict(chip_smoke.PPO_ARGS, num_envs=envs)
    env = wrappers.wrap(chip_smoke.tracking_env("cuda"), episode_length=a["episode_length"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    A, T = env.action_size, a["unroll_length"]
    state = env.reset(gen, envs)
    dtype = state.obs.dtype
    box = [state, chip_smoke.ppo_state(env.observation_size, A, chip_smoke.PPO_HIDDEN,
                                       a["learning_rate"], "cuda", dtype, 0)]
    steps_per, n_unrolls, rows = chip_smoke.ppo_geometry(a)
    make_policy = networks.make_inference_fn(box[1].params)
    loss_fn = chip_smoke.ppo_loss_fn(a)

    def advance():
        eps = train.rollout_draws(gen, n_unrolls, T, envs, A, dtype)
        box[0], data, normalizer = train.rollout_step(env, make_policy, box[1], box[0], eps)
        perms, ent = train.learn_draws(gen, a["num_updates_per_batch"], a["num_minibatches"],
                                       rows, T, A, dtype)
        box[1], _ = train.learn_step(box[1], data, normalizer, perms, ent, loss_fn, steps_per)

    return advance, n_unrolls * T * chip_smoke.N_SUBSTEPS


def _stepper(model: str, envs: int):
    """(advance, substeps per step) for the profiled model."""
    if model == "minirat_ppo":
        return _ppo_stepper(envs)
    configs = ("minirat", "minirat_elliptic", "ratpair", "rodent_standin",
               "rodent_standin_terrain", "fly_standin_ball",
               "rodent_standin_randomized") + chip_smoke.FLY_MODELS
    if model in configs:
        if model == "rodent_standin_randomized":
            import functools

            from brax_tracking_tpu_torch.envs import wrappers

            draws = torch.Generator(device="cuda").manual_seed(3)
            env = wrappers.wrap(
                chip_smoke.config_env("cuda", None, "rodent_standin"), episode_length=1000,
                randomization_fn=functools.partial(chip_smoke.rodent_randomization("scaled"),
                                                   num_envs=envs, generator=draws))
        else:
            env = chip_smoke.make_env("cuda", model=model)
        gen = torch.Generator(device="cuda").manual_seed(0)
        box = [env.reset(gen, envs)]
        act = lambda: 2.0 * torch.rand(envs, env.action_size, generator=gen, device="cuda") - 1.0

        def advance():
            box[0] = env.step(box[0], act())

        return advance, {"ratpair": chip_smoke.PAIR_SUBSTEPS,
                         "rodent_standin": chip_smoke.RODENT_SUBSTEPS,
                         "rodent_standin_randomized": chip_smoke.RODENT_SUBSTEPS,
                         "rodent_standin_terrain": chip_smoke.RODENT_SUBSTEPS,
                         "fly_standin_ball": chip_smoke.FLY_SUBSTEPS,
                         **dict.fromkeys(chip_smoke.FLY_MODELS, chip_smoke.FLY_SUBSTEPS)}.get(
                             model, chip_smoke.N_SUBSTEPS)
    from brax_tracking_tpu_torch.physics import step as pstep

    if model.endswith("_narrowphase"):
        scene = {"terrain": "rodent_standin_terrain", "props": "props"}[model.split("_")[0]]
        m = chip_smoke.load(scene, "cuda")
        qpos = chip_smoke.gate_qpos(m, scene, envs, 0)
        return (lambda: chip_smoke.narrowphase(m, qpos)), 1
    if model in ("minirat_planar", "fly_standin_ball_newton"):
        m = chip_smoke.load(model, "cuda")
        box = [chip_smoke.random_states(m, envs, 0, vel=1.0)]

        def advance():
            box[0] = pstep.step(m, box[0], device="cuda")

        return advance, 1
    if model == "props":
        m = chip_smoke.load(model, "cuda")
        box = [pstep.make_data(m, envs, device="cuda")]

        def advance():
            box[0] = pstep.step(m, box[0], device="cuda")

        return advance, 1
    if model == "minirat_newton":
        m = chip_smoke.load(model, "cuda")
        box = [chip_smoke.random_states(m, envs, 0)]
        lo, width = -0.3, 0.6
    else:
        m = chip_smoke.bm_model("cuda", model.split("_")[1])
        box = [chip_smoke.bm_posed(m, envs)]
        lo, width = -0.5, 1.5
    gen = torch.Generator(device="cuda").manual_seed(0)

    def advance():
        ctrl = lo + width * torch.rand(envs, m.nu, generator=gen, device="cuda")
        box[0] = pstep.step(m, box[0].replace(ctrl=ctrl), device="cuda")

    return advance, 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="minirat",
                    choices=("minirat", "minirat_elliptic", "minirat_newton",
                             "ballmuscle_cg", "ballmuscle_newton", "minirat_ppo", "ratpair",
                             "rodent_standin", "rodent_standin_terrain", "props",
                             "terrain_narrowphase", "props_narrowphase",
                             "rodent_standin_randomized", "fly_standin_ball",
                             "fly_standin_ball_newton", "minirat_planar")
                    + chip_smoke.FLY_MODELS)
    ap.add_argument("--envs", type=int, default=None,
                    help="envs (default 1024 for ratpair, the pair config's, else 2048)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if args.envs is None:
        args.envs = chip_smoke.B_PAIR if args.model == "ratpair" else chip_smoke.B_MAIN
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from brax_tracking_tpu_torch.ops import library

    card = chip_smoke.card_line()
    print(card)
    library.build()
    advance, substeps = _stepper(args.model, args.envs)
    for _ in range(2):  # warmup
        advance()
    torch.cuda.synchronize()

    t0 = time.perf_counter()  # unprofiled wall time of the same work
    for _ in range(args.steps):
        advance()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            advance()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    by_name: dict = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the port's own kernels (ops/csrc), by device time per launch
    ours = {k: v for k, v in by_name.items() if any(
        tag in k for tag in ("cg_fused_kernel", "cg_batched_kernel", "spd_inverse_kernel",
                             "spd_solve_kernel", "factor_kernel", "solve_kernel"))}
    n_sub = args.steps * substeps
    print(json.dumps({
        "card": card,
        "model": args.model,
        "envs": args.envs,
        "steps": args.steps,
        "substeps_per_step": substeps,
        "wall_ms_per_step": wall * 1e3 / args.steps,
        "wall_ms_per_step_profiled": wall_profiled * 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_ops_per_substep": len(events) / n_sub,
        # device-to-host copies: each is a read the host waits for
        "host_reads_per_substep": sum("DtoH" in e.name for e in events) / n_sub,
        "port_kernels": [
            {"name": k[:60], "launches_per_substep": n / n_sub, "us_per_launch": t / n}
            for k, (n, t) in ours.items()
        ],
        "top_device_ops": [
            {"name": k[:80], "count_per_substep": n / n_sub, "ms_per_substep": t / 1e3 / n_sub}
            for k, (n, t) in top
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
