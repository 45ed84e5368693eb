"""Passive forces: joint springs and dof dampers, batch-first.

Counterpart of ``brax_tracking_tpu/physics/passive.py`` (mj_passive
semantics) for free and hinge joints. Tendon springs and the fluid model
raise: the minirat has neither.
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
    if np.any((jt == M.JNT_BALL) | (jt == M.JNT_SLIDE)):
        M.unported("ball and slide joint springs", "§A.8")
    if m.ntendon:
        M.unported("tendon springs and dampers", "§A.4")
    qadr = np.asarray(m.jnt_qposadr)
    dadr = np.asarray(m.jnt_dofadr)
    qfrc = torch.zeros_like(d.qvel)

    # hinge springs, all at once
    h = np.nonzero(jt == M.JNT_HINGE)[0]
    if h.size:
        hq = m.idx(qadr[h])
        k = m.jnt_stiffness[m.idx(h)]
        qfrc[:, m.idx(dadr[h])] = -k * (d.qpos[:, hq] - m.qpos_spring[hq])
    # free-joint springs: translation and orientation
    for jid in np.nonzero(jt == M.JNT_FREE)[0]:
        k = m.jnt_stiffness[int(jid)]
        qa, da = int(qadr[jid]), int(dadr[jid])
        qfrc[:, da : da + 3] = -k * (d.qpos[:, qa : qa + 3] - m.qpos_spring[qa : qa + 3])
        dif = _sub_quat(d.qpos[:, qa + 3 : qa + 7], m.qpos_spring[qa + 3 : qa + 7])
        qfrc[:, da + 3 : da + 6] = -k * dif

    # dof dampers
    return qfrc - m.dof_damping * d.qvel


def passive(m: M.Model, d: M.Data) -> M.Data:
    if m.has_fluid:
        M.unported("the inertia-box fluid model", "§A.5")
    return d.replace(qfrc_passive=spring_damper(m, d))
