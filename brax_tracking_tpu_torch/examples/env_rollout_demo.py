"""Env bring-up demo: build a tracking env on a stand-in, roll a constant
action, print the reward and metric stats and, with ``--video``, render the
rollout with the native rasterizer.

Counterpart of ``examples/env_rollout_demo.py``, whose models are not in
this repository: here the rodent is the rodent stand-in
(``builtin:rodent_standin.xml``, ``RodentSingleClip``, rescaled by 0.9 as
its config freezes it) and the fly the tethered fly stand-in
(``builtin:fly_standin.xml``, ``FlyTethered``), each at CG 4/4 on a
synthetic clip. The video renders the env's own frozen model from the
default orbit camera.

    python -m brax_tracking_tpu_torch.examples.env_rollout_demo [rodent|fly]
        [--steps 100] [--video out.avi] [--contacts] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_env(which: str, device="cuda"):
    """The demo's env on ``device`` and its frozen model file."""
    from brax_tracking_tpu_torch.data import clips as C
    from brax_tracking_tpu_torch.physics import spec

    if which == "fly":
        from brax_tracking_tpu_torch.envs.fly import FlyTethered

        model = spec.load_model(spec.FLY_STANDIN_TETHERED_NPZ, device=device)
        qpos = model.qpos0.expand(128, model.nq)
        clip = C.process_clip(model, qpos)
        return FlyTethered(
            reference_clip=clip,
            mjcf_path="builtin:fly_standin.xml",
            center_of_mass="thorax",
            end_eff_names=["claw_T1_left", "claw_T1_right"],
            body_names=["thorax", "head", "abdomen"],
            joint_names=["coxa_flexion_T1_left", "coxa_flexion_T1_right"],
            iterations=4,
            ls_iterations=4,
            device=device,
        ), spec.FLY_STANDIN_TETHERED_NPZ
    from brax_tracking_tpu_torch.envs.rodent import RodentSingleClip

    model = spec.load_model(spec.RODENT_STANDIN_NPZ, device=device)
    qpos = np.tile(model.qpos0.cpu().numpy().astype(np.float64), (128, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, 0.05, 128)
    clip = C.process_clip(model, torch.as_tensor(qpos))
    return RodentSingleClip(
        reference_clip=clip, mjcf_path="builtin:rodent_standin.xml", iterations=4,
        ls_iterations=4, device=device,
    ), spec.RODENT_STANDIN_NPZ


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("env", nargs="?", default="rodent", choices=["rodent", "fly"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--video", default="")
    ap.add_argument("--contacts", action="store_true",
                    help="print the per-contact force table at the last step")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from brax_tracking_tpu_torch.device import resolve_device, synchronize

    dev = resolve_device(args.device)
    env, npz = build_env(args.env, dev)
    m = env.model
    print(f"{args.env}: nq={m.nq} nv={m.nv} nu={m.nu} obs={env.observation_size} "
          f"act={env.action_size}")

    state = env.reset(torch.Generator(device=dev).manual_seed(0), 1)
    action = torch.zeros(1, env.action_size, dtype=m.dtype, device=dev)
    t0 = time.perf_counter()
    state = env.step(state, action)
    synchronize(dev)
    print(f"first step: {time.perf_counter() - t0:.2f}s")

    rollout = [state]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = env.step(state, action)
        rollout.append(state)
    synchronize(dev)
    print(f"{args.steps} steps: {(time.perf_counter() - t0) / max(args.steps, 1) * 1e3:.2f} "
          "ms/step (one env, eager dispatch; training batches thousands)")

    rewards = torch.cat([s.reward for s in rollout]).cpu().numpy()
    print(f"reward: mean {rewards.mean():.4f} min {rewards.min():.4f} max {rewards.max():.4f}")
    for k, v in rollout[-1].metrics.items():
        print(f"  metrics[{k}] = {float(v):.4f}")

    if args.contacts:
        from brax_tracking_tpu_torch.physics import support

        d = rollout[-1].pipeline_state
        forces = support.contact_force(m, d)[0].cpu().numpy()
        active = support.active_contacts(m, d)[0].cpu().numpy()
        pos, dist = d.contact_pos[0].cpu().numpy(), d.contact_dist[0].cpu().numpy()
        slot_pair = np.repeat(np.arange(m.pairs.geom1.size), m.pairs.npoint)
        print(f"contacts at final step: {int(active.sum())}/{active.size} slots")
        for s in np.nonzero(active)[0]:
            pr = slot_pair[s]
            print(f"  geoms {m.pairs.geom1[pr]:3d}-{m.pairs.geom2[pr]:3d}  dist {dist[s]:+.5f}  "
                  f"pos {np.round(pos[s], 4)}  f[n,t1,t2] {np.round(forces[s, :3], 4)}")

    if args.video:
        # the env's own model from the default orbit camera, at most ~250 frames
        from brax_tracking_tpu_torch.harness import render
        from brax_tracking_tpu_torch.native.video import save_video
        from brax_tracking_tpu_torch.physics import spec

        r = spec.render_fields(npz)
        qposes = torch.cat([s.pipeline_state.qpos for s in rollout])
        poses = render.scene_poses(m, r, qposes[:: max(1, len(rollout) // 250)])
        out = save_video(args.video, render.render_frames(r, poses, camera=-1), fps=50)
        print("video:", out)


if __name__ == "__main__":
    main()
