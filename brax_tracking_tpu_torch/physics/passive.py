"""Passive forces: joint springs and dof dampers, batch-first.

Counterpart of ``brax_tracking_tpu/physics/passive.py`` (mj_passive
semantics) for free, hinge and ball joints and fixed tendons. The fluid
model raises.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.physics import model as M


def _sub_quat(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """mju_subQuat: 3D velocity-space difference qa - qb."""
    return btm.quat_to_axis_angle(btm.quat_mul(btm.quat_conj(qb), qa))


def spring_damper(m: M.Model, d: M.Data) -> torch.Tensor:
    jt = np.asarray(m.jnt_type)
    if np.any(jt == M.JNT_SLIDE):
        M.unported("slide joint springs", "§A.12")
    qadr = np.asarray(m.jnt_qposadr)
    dadr = np.asarray(m.jnt_dofadr)
    qfrc = torch.zeros_like(d.qvel)

    # hinge springs, all at once
    h = np.nonzero(jt == M.JNT_HINGE)[0]
    if h.size:
        hq = m.idx(qadr[h])
        k = m.jnt_stiffness[m.idx(h)]
        qfrc[:, m.idx(dadr[h])] = -k * (d.qpos[:, hq] - m.qpos_spring[hq])
    # free-joint springs (translation and orientation) and ball springs
    for jid in np.nonzero((jt == M.JNT_FREE) | (jt == M.JNT_BALL))[0]:
        k = m.jnt_stiffness[int(jid)]
        qa, da = int(qadr[jid]), int(dadr[jid])
        if jt[jid] == M.JNT_FREE:
            qfrc[:, da : da + 3] = -k * (d.qpos[:, qa : qa + 3] - m.qpos_spring[qa : qa + 3])
            qa, da = qa + 3, da + 3
        dif = _sub_quat(d.qpos[:, qa : qa + 4], m.qpos_spring[qa : qa + 4])
        qfrc[:, da : da + 3] = -k * dif

    # dof dampers
    qfrc = qfrc - m.dof_damping * d.qvel

    # tendon springs (with a deadband) and dampers
    if m.ntendon:
        ten_vel = (d.ten_J @ d.qvel[..., None])[..., 0]
        lo, hi = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
        length = d.ten_length
        zero = torch.zeros((), dtype=length.dtype, device=length.device)
        displacement = torch.where(
            length > hi, hi - length, torch.where(length < lo, lo - length, zero)
        )
        frc = m.tendon_stiffness * displacement - m.tendon_damping * ten_vel
        qfrc = qfrc + (d.ten_J.transpose(-1, -2) @ frc[..., None])[..., 0]
    return qfrc


def passive(m: M.Model, d: M.Data) -> M.Data:
    if m.has_fluid:
        M.unported("the inertia-box fluid model", "§A.9")
    return d.replace(qfrc_passive=spring_damper(m, d))
