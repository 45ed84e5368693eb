"""Policy-vs-reference videos: the rollout and its reference clip, side by
side in a two-body render scene.

Counterpart of ``brax_tracking_tpu/harness/render.py``. The JAX package
compiles the render MJCF with ``mujoco``, runs ``mj_forward`` on the host
once per frame and rasterizes; the card's machine has no ``mujoco``, so
here the render scene is a frozen model file
(``spec.frozen_path(rendering_mjcf, free_jnt)``, its ``render_*`` fields
frozen beside the physics ones), the poses of every frame come from one
batched ``kinematics`` + ``com_pos`` call on the rollout's device (the
frames are the batch), the cameras from ``camlight`` (MuJoCo's
``mj_camlight``, every camera mode), and the poses are copied to the host
once. The host then rasterizes each frame with ``native/softraster.py``
and encodes the video with ``native/video.py``.

The frame stride, ``T = min(...)`` and the pair / single-model branches are
the JAX version's: with a pair scene (its nq differs from the rollout's)
each frame is [reference qpos ++ rollout qpos], the reference body first;
with a single model whose nq matches, only the rollout is shown.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.device import synchronize
from brax_tracking_tpu_torch.physics import kinematics as K
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.physics import spec
from brax_tracking_tpu_torch.physics import step as pstep


def reference_qpos_trajectory(ref_traj, free_jnt: bool) -> torch.Tensor:
    """Full qpos frames (T, nq) of a ReferenceClip; of clip 0 for a stacked
    multi-clip one."""
    parts = [ref_traj.joints]
    if free_jnt and ref_traj.position is not None:
        parts = [ref_traj.position, ref_traj.quaternion, ref_traj.joints]
    if parts[-1].dim() == 3:  # (n_clips, T, ...)
        parts = [p[0] for p in parts]
    return torch.cat(parts, dim=1)


def load_scene(mjcf_path: str, free_jnt: bool, device, dtype=None):
    """The render scene of ``mjcf_path``: its Model on ``device`` and its
    render fields (numpy, ``spec.render_fields``)."""
    npz = spec.frozen_path(mjcf_path, free_jnt)
    model = spec.load_model(npz, device=device, dtype=dtype, free_jnt=free_jnt)
    return model, spec.render_fields(npz)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """MuJoCo's ``mju_normalize3``: a vector shorter than mjMINVAL (1e-15)
    becomes (1, 0, 0)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.where(n < 1e-15, v.new_tensor([1.0, 0.0, 0.0]), v / torch.clamp(n, min=1e-15))


def camlight(m: M.Model, r, d: M.Data):
    """Camera positions (B, ncam, 3) and frames (B, ncam, 3, 3) as MuJoCo's
    ``mj_camlight`` computes them: fixed, the camera's pose in its body's
    frame; track, the body's position plus ``cam_pos0`` and the frame
    ``cam_mat0``; trackcom, the body's subtree CoM plus ``cam_poscom0`` and
    ``cam_mat0``; targetbody and targetbodycom, the fixed position and a
    frame whose z axis points from the target body's position (its subtree
    CoM) to the camera and whose x axis is level (z cross world z), where
    the camera names a target. ``d`` holds kinematics and com_pos."""
    B = d.qpos.shape[0]
    if r.ncam == 0:
        return d.qpos.new_zeros(B, 0, 3), d.qpos.new_zeros(B, 0, 3, 3)
    mode = np.asarray(r.cam_mode)
    b = m.idx(r.cam_bodyid)
    xquat, xpos = d.xquat[:, b], d.xpos[:, b]
    pos = xpos + btm.quat_rotate(xquat, m.const(r.cam_pos))
    mat = btm.quat_to_mat(btm.quat_mul(xquat, m.const(r.cam_quat)))
    mat0 = m.const(np.asarray(r.cam_mat0).reshape(-1, 3, 3)).expand(B, -1, 3, 3)
    track = m.const(mode == M.CAM_TRACK, torch.bool)
    trackcom = m.const(mode == M.CAM_TRACKCOM, torch.bool)
    target = np.asarray(r.cam_targetbodyid)
    aim = (mode == M.CAM_TARGETBODY) | (mode == M.CAM_TARGETBODYCOM)
    aim &= target >= 0
    if aim.any():
        t = m.idx(np.maximum(target, 0))
        look = torch.where(m.const(mode == M.CAM_TARGETBODY, torch.bool)[:, None],
                           d.xpos[:, t], d.subtree_com[:, t])
        z = _normalize(pos - look)
        x = _normalize(torch.linalg.cross(z.new_tensor([0.0, 0.0, 1.0]).expand_as(z), z))
        y = _normalize(torch.linalg.cross(z, x))
        mat = torch.where(m.const(aim, torch.bool)[:, None, None],
                          torch.stack([x, y, z], dim=-1), mat)
    pos = torch.where(track[:, None], xpos + m.const(r.cam_pos0), pos)
    pos = torch.where(trackcom[:, None], d.subtree_com[:, b] + m.const(r.cam_poscom0), pos)
    mat = torch.where((track | trackcom)[:, None, None], mat0, mat)
    return pos, mat


@torch.no_grad()
def scene_poses(m: M.Model, r, qpos: torch.Tensor):
    """Geom and camera poses of every frame of ``qpos`` (T, nq), one batch
    on the model's device; returns numpy geom_xpos (T, ngeom, 3), geom_xmat
    (T, ngeom, 3, 3), cam_xpos (T, ncam, 3) and cam_xmat (T, ncam, 3, 3),
    copied to the host in one transfer."""
    T = qpos.shape[0]
    d = pstep.make_data(m, T, device=m.device).replace(qpos=qpos.to(m.dtype))
    d = K.com_pos(m, K.kinematics(m, d))
    cam_xpos, cam_xmat = camlight(m, r, d)
    parts = (d.geom_xpos, btm.quat_to_mat(d.geom_xquat), cam_xpos, cam_xmat)
    flat = torch.cat([p.reshape(T, -1) for p in parts], dim=1).cpu().numpy()
    out, at = [], 0
    for p in parts:
        n = int(np.prod(p.shape[1:]))
        out.append(flat[:, at:at + n].reshape(p.shape))
        at += n
    return tuple(out)


def render_frames(r, poses, camera=1, height: int = 480, width: int = 640):
    """One RGB frame (height, width, 3) uint8 per frame of ``poses``
    (scene_poses' arrays) through the native rasterizer."""
    from brax_tracking_tpu_torch.native.softraster import NativeRenderer

    geom_xpos, geom_xmat, cam_xpos, cam_xmat = poses
    renderer = NativeRenderer(r, height=height, width=width)
    frames = []
    for t in range(len(geom_xpos)):
        renderer.update_scene(geom_xpos[t], geom_xmat[t], cam_xpos[t], cam_xmat[t], camera)
        frames.append(renderer.render())
    renderer.close()
    return frames


def scene_qpos(m: M.Model, qposes_rollout: torch.Tensor, ref_traj, free_jnt: bool,
               frame_stride: Optional[int] = None) -> torch.Tensor:
    """The render scene's qpos of every frame (T, nq): the rollout
    subsampled to the clip's rate, T = min(clip frames, rollout frames),
    and with a pair scene the reference's qpos first."""
    qposes_ref = reference_qpos_trajectory(ref_traj, free_jnt).to(qposes_rollout)
    if frame_stride is None:  # env steps per mocap frame
        frame_stride = max(1, round(len(qposes_rollout) / len(qposes_ref)))
    qposes_rollout = qposes_rollout[::frame_stride]
    T = min(len(qposes_ref), len(qposes_rollout))
    if m.nq == qposes_rollout.shape[1]:
        return qposes_rollout[:T]
    qpos = torch.cat([qposes_ref[:T], qposes_rollout[:T]], dim=1)
    if qpos.shape[1] != m.nq:
        raise ValueError(f"the render scene has nq {m.nq}; the reference and the rollout "
                         f"give {qposes_ref.shape[1]} + {qposes_rollout.shape[1]}")
    return qpos


def render_rollout_vs_reference(
    pair_mjcf: str,
    qposes_rollout: torch.Tensor,
    ref_traj,
    out_path: str,
    camera=1,
    free_jnt: bool = True,
    height: int = 480,
    width: int = 640,
    fps: float = 50.0,
    frame_stride: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
) -> str:
    """Renders the rollout's qpos (N, nq) beside the reference clip through
    the render scene of ``pair_mjcf`` and writes the video (``save_video``'s
    chain); returns its path. The poses are computed on the rollout's
    device. ``timings``, if given, receives the seconds of the device
    kinematics (with the copy to the host), of rasterizing per frame and of
    encoding, and the frame count."""
    from brax_tracking_tpu_torch.native.video import save_video

    dev = qposes_rollout.device
    t0 = time.perf_counter()
    m, r = load_scene(pair_mjcf, free_jnt, dev, qposes_rollout.dtype)
    qpos = scene_qpos(m, qposes_rollout, ref_traj, free_jnt, frame_stride)
    synchronize(dev)
    t1 = time.perf_counter()
    poses = scene_poses(m, r, qpos)
    t2 = time.perf_counter()
    frames = render_frames(r, poses, camera, height, width)
    t3 = time.perf_counter()
    path = save_video(out_path, frames, fps=fps)
    t4 = time.perf_counter()
    if timings is not None:
        timings.update(setup_s=t1 - t0, kinematics_s=t2 - t1,
                       raster_s_per_frame=(t3 - t2) / len(frames), encode_s=t4 - t3,
                       frames=len(frames))
    return path
