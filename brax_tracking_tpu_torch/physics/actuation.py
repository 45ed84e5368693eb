"""Actuation: joint transmission, gain and bias force, batch-first.

Counterpart of ``brax_tracking_tpu/physics/actuation.py`` (mj_fwdActuation
semantics) for what the minirat uses: hinge-joint transmission, no
activation dynamics, fixed or affine gain, no or affine bias, and the ctrl
and force clamps. Activation dynamics, muscles and tendon transmission
raise.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch.physics import model as M


def _moment_length_velocity(m: M.Model, d: M.Data):
    """Hinge-joint transmission: lengths, velocities and, per actuator, the
    (static) dof it drives and its gear."""
    trn = np.asarray(m.actuator_trntype)
    if np.any(trn != M.TRN_JOINT):
        M.unported("tendon and site transmissions", "§A.4")
    jid = np.asarray(m.actuator_trnid)[:, 0]
    if np.any(np.asarray(m.jnt_type)[jid] != M.JNT_HINGE):
        M.unported("transmission through a non-hinge joint", "§A.8")
    qadr = m.idx(np.asarray(m.jnt_qposadr)[jid])
    dadr = m.idx(np.asarray(m.jnt_dofadr)[jid])
    gear = m.actuator_gear[:, 0]
    length = d.qpos[:, qadr] * gear
    velocity = d.qvel[:, dadr] * gear
    return dadr, gear, length, velocity


def fwd_actuation(m: M.Model, d: M.Data) -> M.Data:
    B = d.qpos.shape[0]
    if m.nu == 0:
        return d.replace(
            qfrc_actuator=torch.zeros_like(d.qvel),
            actuator_force=d.qpos.new_zeros(B, 0),
            act_dot=d.qpos.new_zeros(B, 0),
        )
    if m.na or np.any(np.asarray(m.actuator_dyntype) != M.DYN_NONE):
        M.unported("actuator activation dynamics", "§A.4")
    gaintype = np.asarray(m.actuator_gaintype)
    biastype = np.asarray(m.actuator_biastype)
    if np.any(gaintype == M.GAIN_MUSCLE) or np.any(biastype == M.BIAS_MUSCLE):
        M.unported("muscle actuators", "§A.8")

    # clamp ctrl
    ctrl = d.ctrl
    lim = m.const(m.actuator_ctrllimited, torch.bool)
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    ctrl = torch.where(lim, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)

    dadr, gear, length, velocity = _moment_length_velocity(m, d)

    gp = m.actuator_gainprm
    gain = gp[:, 0].expand(B, m.nu)
    if np.any(gaintype == M.GAIN_AFFINE):
        gain = torch.where(
            m.const(gaintype == M.GAIN_AFFINE, torch.bool),
            gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity,
            gain,
        )
    bp = m.actuator_biasprm
    bias = torch.zeros_like(length)
    if np.any(biastype == M.BIAS_AFFINE):
        bias = torch.where(
            m.const(biastype == M.BIAS_AFFINE, torch.bool),
            bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity,
            bias,
        )
    force = gain * ctrl + bias

    flim = m.const(m.actuator_forcelimited, torch.bool)
    flo, fhi = m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]
    force = torch.where(flim, torch.minimum(torch.maximum(force, flo), fhi), force)

    # moment^T force: each actuator drives one dof with its gear
    qfrc_actuator = torch.zeros_like(d.qvel).index_add_(1, dadr, gear * force)
    return d.replace(
        qfrc_actuator=qfrc_actuator,
        actuator_force=force,
        act_dot=d.qpos.new_zeros(B, 0),
    )
