"""Reference-clip preprocessing: mocap qpos -> tracking features.

Counterpart of ``brax_tracking_tpu/data/clips.py``: forward kinematics over
all frames of a clip, run as one batch (frames are the batch dimension),
finite-difference velocities (``process_clip``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import kinematics as K
from portbench.ref.physics import model as M
from portbench.ref.physics import step as pstep


@dataclasses.dataclass
class ReferenceClip:
    """Per-frame tracking targets (leading axis: frame)."""

    position: Optional[torch.Tensor] = None  # (T, 3) free-joint translation
    quaternion: Optional[torch.Tensor] = None  # (T, 4) free-joint orientation
    joints: Optional[torch.Tensor] = None  # (T, nq-7) or (T, nq) if tethered
    body_positions: Optional[torch.Tensor] = None  # (T, nbody, 3)
    body_quaternions: Optional[torch.Tensor] = None  # (T, nbody, 4)
    velocity: Optional[torch.Tensor] = None  # (T, 3)
    angular_velocity: Optional[torch.Tensor] = None  # (T, 3)
    joints_velocity: Optional[torch.Tensor] = None  # (T, nq-7)

    def replace(self, **kwargs) -> "ReferenceClip":
        return dataclasses.replace(self, **kwargs)

    def to(self, device, dtype=None) -> "ReferenceClip":
        return ReferenceClip(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
        })


def _free_root(m: M.Model) -> bool:
    return m.njnt > 0 and int(m.jnt_type[0]) == M.JNT_FREE


def extract_features(m: M.Model, mocap_qpos: torch.Tensor) -> ReferenceClip:
    """Forward kinematics of every frame, the frames as one batch."""
    d = pstep.make_data(m, mocap_qpos.shape[0], device=m.device)
    d = K.kinematics(m, d.replace(qpos=mocap_qpos.to(m.dtype)))
    if _free_root(m):
        return ReferenceClip(
            position=mocap_qpos[:, :3],
            quaternion=mocap_qpos[:, 3:7],
            joints=mocap_qpos[:, 7:],
            body_positions=d.xpos,
            body_quaternions=d.xquat,
        )
    return ReferenceClip(joints=mocap_qpos, body_positions=d.xpos, body_quaternions=d.xquat)


def compute_velocity_from_kinematics(qpos_trajectory: torch.Tensor, dt: float) -> torch.Tensor:
    """Finite-difference generalized velocities of a free-root trajectory."""
    qvel_translation = (qpos_trajectory[1:, :3] - qpos_trajectory[:-1, :3]) / dt
    diff = btm.quat_diff(qpos_trajectory[:-1, 3:7], qpos_trajectory[1:, 3:7])
    diff = diff / torch.linalg.norm(diff, dim=-1, keepdim=True)
    qvel_gyro = btm.quat_to_axis_angle(diff) / dt
    qvel_joints = (qpos_trajectory[1:, 7:] - qpos_trajectory[:-1, 7:]) / dt
    return torch.cat([qvel_translation, qvel_gyro, qvel_joints], dim=1)


def process_clip(
    m: M.Model, mocap_qpos: torch.Tensor, max_qvel: float = 20.0, dt: float = 0.02
) -> ReferenceClip:
    """One clip: features + velocities, on the model's device and dtype."""
    mocap_qpos = mocap_qpos.to(device=m.device, dtype=m.dtype)
    clip = extract_features(m, mocap_qpos)
    # pad the last frame so velocities have T entries
    mocap_qpos = torch.cat([mocap_qpos, mocap_qpos[-1:]], dim=0)
    if not _free_root(m):
        # tethered models: 6 zero root-velocity columns, identity root quat
        root = torch.zeros_like(mocap_qpos[:, :7])
        root[:, 3] = 1.0
        mocap_qpos = torch.cat([root, mocap_qpos], dim=1)
    qvel = compute_velocity_from_kinematics(mocap_qpos, dt)
    return clip.replace(
        velocity=qvel[:, :3],
        angular_velocity=qvel[:, 3:6],
        joints_velocity=torch.clamp(qvel[:, 6:], -max_qvel, max_qvel),
    )
