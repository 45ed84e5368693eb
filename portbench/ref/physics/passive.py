"""Passive forces: joint springs, dof dampers and inertia-box fluid drag,
batch-first.

Counterpart of ``brax_tracking_tpu/physics/passive.py`` (mj_passive
semantics) for free, ball, slide and hinge joints and fixed tendons, and its
inertia-box fluid model (the fly's medium: ``density`` and ``viscosity``
on the option line), batched over envs and bodies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import model as M


def _sub_quat(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """mju_subQuat: 3D velocity-space difference qa - qb."""
    return btm.quat_to_axis_angle(btm.quat_mul(btm.quat_conj(qb), qa))


def spring_damper(m: M.Model, d: M.Data) -> torch.Tensor:
    jt = np.asarray(m.jnt_type)
    qadr = np.asarray(m.jnt_qposadr)
    dadr = np.asarray(m.jnt_dofadr)
    qfrc = torch.zeros_like(d.qvel)

    # hinge and slide springs, all at once
    h = np.nonzero((jt == M.JNT_HINGE) | (jt == M.JNT_SLIDE))[0]
    if h.size:
        hq = m.idx(qadr[h])
        k = m.jnt_stiffness[..., m.idx(h)]
        qfrc[:, m.idx(dadr[h])] = -k * (d.qpos[:, hq] - m.qpos_spring[..., hq])
    # free-joint springs (translation and orientation) and ball springs
    for jid in np.nonzero((jt == M.JNT_FREE) | (jt == M.JNT_BALL))[0]:
        k = m.jnt_stiffness[..., int(jid), None]
        qa, da = int(qadr[jid]), int(dadr[jid])
        if jt[jid] == M.JNT_FREE:
            qfrc[:, da : da + 3] = -k * (d.qpos[:, qa : qa + 3] - m.qpos_spring[..., qa : qa + 3])
            qa, da = qa + 3, da + 3
        dif = _sub_quat(d.qpos[:, qa : qa + 4], m.qpos_spring[..., qa : qa + 4])
        qfrc[:, da : da + 3] = -k * dif

    # dof dampers
    qfrc = qfrc - m.dof_damping * d.qvel

    # tendon springs (with a deadband) and dampers
    if m.ntendon:
        ten_vel = (d.ten_J @ d.qvel[..., None])[..., 0]
        lo, hi = m.tendon_lengthspring[..., 0], m.tendon_lengthspring[..., 1]
        length = d.ten_length
        zero = torch.zeros((), dtype=length.dtype, device=length.device)
        displacement = torch.where(
            length > hi, hi - length, torch.where(length < lo, lo - length, zero)
        )
        frc = m.tendon_stiffness * displacement - m.tendon_damping * ten_vel
        qfrc = qfrc + (d.ten_J.transpose(-1, -2) @ frc[..., None])[..., 0]
    return qfrc


def fluid(m: M.Model, d: M.Data) -> torch.Tensor:
    """Inertia-box fluid model: each body's equivalent box from its inertia,
    viscous (equivalent-sphere) and quadratic drag on its velocity in its
    inertial frame, the wrench projected onto the dofs that move it. The
    JAX package's ``fluid``, its operations in its order, over (B, nbody, 3)
    at once."""
    density, viscosity = m.opt_b("density", 3), m.opt_b("viscosity", 3)
    safe_mass = m.body_mass.clamp(min=M.MINVAL)
    ix, iy, iz = m.body_inertia.unbind(-1)
    # equivalent box half-sizes from the principal inertia (nbody, 3)
    box = torch.stack(
        [
            torch.sqrt((iy + iz - ix).clamp(min=M.MINVAL) / safe_mass * 6.0) / 2,
            torch.sqrt((ix + iz - iy).clamp(min=M.MINVAL) / safe_mass * 6.0) / 2,
            torch.sqrt((ix + iy - iz).clamp(min=M.MINVAL) / safe_mass * 6.0) / 2,
        ],
        dim=-1,
    )

    # the 6D velocity at each body's inertial frame, in that frame
    arm = d.xipos - d.subtree_com[:, m.idx(m.body_rootid)]
    ang_w = d.cvel[:, :3].transpose(1, 2)  # (B, nbody, 3)
    lin_w = d.cvel[:, 3:].transpose(1, 2) + torch.linalg.cross(ang_w, arm, dim=-1)
    iquat = btm.quat_mul(d.xquat, m.body_iquat)
    ang = btm.quat_rotate_inv(iquat, ang_w)
    lin = btm.quat_rotate_inv(iquat, lin_w) - btm.quat_rotate_inv(
        iquat, m.opt.wind[..., None, :].expand_as(ang_w))

    # viscous resistance (the sphere's diameter is the mean full edge), then
    # quadratic drag
    diam = 2.0 * box.mean(-1, keepdim=True)
    lfrc_ang = -(math.pi * diam**3 * viscosity * ang)
    lfrc_lin = -(3.0 * math.pi * diam * viscosity * lin)
    b0, b1, b2 = box[..., 0:1], box[..., 1:2], box[..., 2:3]
    areas = torch.cat([b1 * b2, b0 * b2, b0 * b1], dim=-1)
    lfrc_lin = lfrc_lin - 0.5 * density * areas * lin.abs() * lin
    tmom = torch.cat([b0 * (b1**4 + b2**4), b1 * (b0**4 + b2**4), b2 * (b0**4 + b1**4)], dim=-1)
    lfrc_ang = lfrc_ang - density * tmom * ang.abs() * ang / 64.0

    # to the world frame, shifted to the c-frame origin; the world body's
    # wrench is 0
    force_w = btm.quat_rotate(iquat, lfrc_lin)
    torque_c = btm.quat_rotate(iquat, lfrc_ang) + torch.linalg.cross(arm, force_w, dim=-1)
    fvec = torch.cat([torque_c, force_w], dim=-1)
    fvec[:, 0] = 0.0
    # qfrc[j] = cdof_j . (sum of the wrenches of the bodies dof j moves)
    per_dof = m.const(np.asarray(m.body_dof_mask).T) @ fvec  # (B, nv, 6)
    return torch.einsum("bcv,bvc->bv", d.cdof, per_dof)


def passive(m: M.Model, d: M.Data) -> M.Data:
    qfrc = spring_damper(m, d)
    # fluid forces only where the model declares a medium
    if m.has_fluid:
        qfrc = qfrc + fluid(m, d)
    return d.replace(qfrc_passive=qfrc)
