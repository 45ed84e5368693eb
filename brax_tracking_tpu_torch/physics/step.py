"""Forward dynamics and integration entry points, batch-first.

Counterpart of ``brax_tracking_tpu/physics/step.py``: ``forward`` runs
mj_forward's stage order over a batch of envs, ``step`` adds semi-implicit
Euler integration. The Euler velocity update (with MuJoCo's implicit
joint-damping treatment) comes out of the solve kernel as ``qvel_next``.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.device import check_device, resolve_device, same_device
from brax_tracking_tpu_torch.physics import actuation as A
from brax_tracking_tpu_torch.physics import collision as C
from brax_tracking_tpu_torch.physics import constraint as Cn
from brax_tracking_tpu_torch.physics import dynamics as D
from brax_tracking_tpu_torch.physics import kinematics as K
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.physics import passive as P
from brax_tracking_tpu_torch.physics import solver as S


def _on_model_device(m: M.Model, device) -> torch.device:
    dev = resolve_device(device)
    if not same_device(m.device, dev):
        raise ValueError(f"the model lives on {m.device}, not {dev}")
    return dev


def make_data(m: M.Model, batch_size: int, device="cuda") -> M.Data:
    """Fresh Data for ``batch_size`` envs at qpos0, zero velocity."""
    _on_model_device(m, device)
    B = int(batch_size)
    zeros = lambda n: torch.zeros(B, n, dtype=m.dtype, device=m.device)
    return M.Data(
        qpos=m.qpos0.expand(B, m.nq).clone(),
        qvel=zeros(m.nv),
        act=zeros(m.na),
        time=torch.zeros(B, dtype=m.dtype, device=m.device),
        ctrl=zeros(m.nu),
    )


def forward_to_constraint(m: M.Model, d: M.Data) -> M.Data:
    """Every stage of ``forward`` before the constraint solve: the state the
    solve kernel reads."""
    if m.nsensor:
        M.unported("sensors", "§A.4")
    d = K.kinematics(m, d)
    d = K.com_pos(m, d)
    d = K.tendon(m, d)
    d = C.collision(m, d)
    d = D.crb(m, d)
    d = K.com_vel(m, d)
    d = P.passive(m, d)
    d = D.rne(m, d)
    d = A.fwd_actuation(m, d)
    # qacc_smooth is produced by the solve, which holds M^-1
    d = d.replace(qfrc_smooth=d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator)
    return Cn.make_constraint(m, d)


def forward(m: M.Model, d: M.Data) -> M.Data:
    """Full forward dynamics at the current state."""
    return S.solve(m, forward_to_constraint(m, d))


def _integrate_pos(m: M.Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """mj_integratePos: hinge dofs in one scatter, free joints (quaternion
    integration) one by one."""
    jt = np.asarray(m.jnt_type)
    qadrs = np.asarray(m.jnt_qposadr)
    dadrs = np.asarray(m.jnt_dofadr)
    out = qpos.clone()
    h = np.nonzero(jt == M.JNT_HINGE)[0]
    if h.size:
        sq = m.idx(qadrs[h])
        out[:, sq] = qpos[:, sq] + dt * qvel[:, m.idx(dadrs[h])]
    for jid in np.nonzero(jt == M.JNT_FREE)[0]:
        qa, da = int(qadrs[jid]), int(dadrs[jid])
        out[:, qa : qa + 3] = qpos[:, qa : qa + 3] + dt * qvel[:, da : da + 3]
        out[:, qa + 3 : qa + 7] = btm.quat_integrate(
            qpos[:, qa + 3 : qa + 7], qvel[:, da + 3 : da + 6], dt
        )
    return out


def step(m: M.Model, d: M.Data, device="cuda") -> M.Data:
    """One physics step for every env: forward dynamics + semi-implicit
    Euler (MuJoCo's integrator, joint damping implicit)."""
    dev = _on_model_device(m, device)
    check_device(dev, qpos=d.qpos, qvel=d.qvel, ctrl=d.ctrl)
    d = forward(m, d)
    dt = m.opt.timestep
    qvel_new = d.qvel_next
    qpos_new = _integrate_pos(m, d.qpos, qvel_new, dt)
    return d.replace(qpos=qpos_new, qvel=qvel_new, time=d.time + dt)
