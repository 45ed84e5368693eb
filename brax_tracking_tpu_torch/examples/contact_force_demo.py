"""Contact-force demo: roll a tracking env on a stand-in, decode each
contact's wrench from the solved constraint rows
(``physics/support.py::contact_force``, MuJoCo's ``mj_contactForce``), print
a table of the active contacts and render the frames with world-frame force
arrows drawn over the native rasterizer's output.

Counterpart of ``examples/contact_force_demo.py`` on the port's stand-ins
(``env_rollout_demo.build_env``). The video goes through ``save_video``'s
chain (an AVI where Pillow imports, else a GIF).

    python -m brax_tracking_tpu_torch.examples.contact_force_demo [rodent|fly]
        [--steps 40] [--video contact_forces.avi] [--scale 0.002] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _project(viewproj: np.ndarray, pts: np.ndarray, w: int, h: int):
    """World points (N,3) -> pixel coords (N,2) + in-front mask."""
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    clip = hom @ viewproj.T
    ok = clip[:, 3] > 1e-6
    ndc = clip[:, :3] / np.maximum(clip[:, 3:4], 1e-6)
    px = (ndc[:, 0] + 1.0) * 0.5 * w
    py = (1.0 - ndc[:, 1]) * 0.5 * h
    return np.stack([px, py], axis=1), ok


def _draw_line(img: np.ndarray, p0, p1, color):
    """Tiny Bresenham-ish line into an (H, W, 3) uint8 frame."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).round().astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color
    # thicken by one pixel for visibility
    keep2 = keep & (ys + 1 < h)
    img[ys[keep2] + 1, xs[keep2]] = color


@torch.no_grad()
def main(argv=None) -> str:
    """Runs the demo; returns the written video's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("env", nargs="?", default="rodent", choices=["rodent", "fly"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--video", default="contact_forces.avi")
    ap.add_argument("--scale", type=float, default=0.002,
                    help="meters of arrow per Newton of force")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from brax_tracking_tpu_torch.device import resolve_device
    from brax_tracking_tpu_torch.examples.env_rollout_demo import build_env
    from brax_tracking_tpu_torch.harness import render
    from brax_tracking_tpu_torch.native.softraster import NativeRenderer
    from brax_tracking_tpu_torch.native.video import save_video
    from brax_tracking_tpu_torch.physics import spec, support

    dev = resolve_device(args.device)
    env, npz = build_env(args.env, dev)
    m = env.model
    state = env.reset(torch.Generator(device=dev).manual_seed(0), 1)
    action = torch.zeros(1, env.action_size, dtype=m.dtype, device=dev)
    qposes, cpos, cdist, cforce = [], [], [], []
    for _ in range(args.steps):
        state = env.step(state, action)
        d = state.pipeline_state
        qposes.append(d.qpos)
        cpos.append(d.contact_pos[0])
        cdist.append(d.contact_dist[0])
        cforce.append(support.contact_force(m, d, world_frame=True)[0])
    cpos, cdist, cforce = (torch.stack(x).cpu().numpy() for x in (cpos, cdist, cforce))

    # per-step console table of the active contacts
    for t in (0, len(qposes) // 2, len(qposes) - 1):
        active = np.nonzero(cdist[t] < 0)[0]
        print(f"step {t}: {len(active)} active contacts")
        for s in active[:8]:
            f = cforce[t][s]
            print(f"  slot {s:3d} |f_n|={np.linalg.norm(f[:3]):8.4f} pos={np.round(cpos[t][s], 4)}")

    # the env model's poses on the device, then the frames on the host with
    # world-frame force arrows
    r = spec.render_fields(npz)
    poses = render.scene_poses(m, r, torch.cat(qposes))
    renderer = NativeRenderer(r, height=480, width=640)
    frames = []
    red = np.array([230, 40, 40], np.uint8)
    for t in range(len(qposes)):
        renderer.update_scene(*(p[t] for p in poses), camera=-1)
        img = renderer.render()
        active = np.nonzero(cdist[t] < 0)[0]
        if active.size:
            p0 = cpos[t][active]
            p1 = p0 + args.scale * cforce[t][active, :3]
            px0, ok0 = _project(renderer.viewproj, p0, 640, 480)
            px1, ok1 = _project(renderer.viewproj, p1, 640, 480)
            for a, b, ok in zip(px0, px1, ok0 & ok1):
                if ok:
                    _draw_line(img, a, b, red)
        frames.append(img)
    out = save_video(args.video, frames, fps=50)
    print(f"wrote {out} ({len(frames)} frames with force overlays)")
    return out


if __name__ == "__main__":
    main()
