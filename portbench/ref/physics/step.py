"""Forward dynamics and integration entry points, batch-first.

Counterpart of ``brax_tracking_tpu/physics/step.py``: ``forward`` runs
mj_forward's stage order over a batch of envs, ``step`` adds semi-implicit
Euler integration with MuJoCo's implicit joint damping; ``forward`` ends
with the sensors (physics/sensor.py). The frozen copy keeps CG on the
solve kernel's layout, whose solve produces the Euler velocity update
(``qvel_next``; the damped tail included).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.device import check_device, resolve_device, same_device
from portbench.ref.physics import actuation as A
from portbench.ref.physics import collision as C
from portbench.ref.physics import constraint as Cn
from portbench.ref.physics import dynamics as D
from portbench.ref.physics import kinematics as K
from portbench.ref.physics import model as M
from portbench.ref.physics import passive as P
from portbench.ref.physics import sensor as Sn
from portbench.ref.physics import solver as S


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


def fwd_position_smooth(m: M.Model, d: M.Data) -> M.Data:
    """The position stage before collision: kinematics, com_pos and the
    tendons (the JAX package's ``fwd_position_smooth``; the port keeps no
    rotation-matrix fields, so it has no ``mats`` switch)."""
    return K.tendon(m, K.com_pos(m, K.kinematics(m, d)))


def fwd_velocity_smooth(m: M.Model, d: M.Data) -> M.Data:
    """The velocity stage: cvel and cdof_dot (mj_comVel)."""
    return K.com_vel(m, d)


def forward_to_constraint(m: M.Model, d: M.Data) -> M.Data:
    """Every stage of ``forward`` before the constraint solve: the state the
    solve reads (qacc_smooth comes out of the solve, which holds M^-1)."""
    if not S.quad_kernel_eligible(m):
        raise NotImplementedError("the frozen copy solves CG on the kernel layout only")
    d = C.collision(m, fwd_position_smooth(m, d))
    d = D.crb(m, d, dense=False)
    d = fwd_velocity_smooth(m, d)
    d = P.passive(m, d)
    d = D.rne(m, d)
    d = A.fwd_actuation(m, d)
    d = d.replace(qfrc_smooth=d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator)
    return Cn.make_constraint(m, d)


def forward(m: M.Model, d: M.Data) -> M.Data:
    """Full forward dynamics at the current state, then the sensors. The
    next solve warm starts from this qacc (mj_forward's qacc_warmstart)."""
    d = S.solve(m, forward_to_constraint(m, d))
    return Sn.sensors(m, d.replace(qacc_warmstart=d.qacc))


def _integrate_pos(m: M.Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """mj_integratePos: hinge and slide dofs in one scatter, free and ball
    joints (quaternion integration) one by one."""
    jt = np.asarray(m.jnt_type)
    qadrs = np.asarray(m.jnt_qposadr)
    dadrs = np.asarray(m.jnt_dofadr)
    out = qpos.clone()
    h = np.nonzero((jt == M.JNT_HINGE) | (jt == M.JNT_SLIDE))[0]
    if h.size:
        sq = m.idx(qadrs[h])
        out[:, sq] = qpos[:, sq] + dt * qvel[:, m.idx(dadrs[h])]
    for jid in np.nonzero((jt == M.JNT_FREE) | (jt == M.JNT_BALL))[0]:
        qa, da = int(qadrs[jid]), int(dadrs[jid])
        if jt[jid] == M.JNT_FREE:
            out[:, qa : qa + 3] = qpos[:, qa : qa + 3] + dt * qvel[:, da : da + 3]
            qa, da = qa + 3, da + 3
        out[:, qa : qa + 4] = btm.quat_integrate(qpos[:, qa : qa + 4], qvel[:, da : da + 3], dt)
    return out


def _integrate_act(m: M.Model, d: M.Data, dt) -> torch.Tensor:
    """Activation update: Euler for integrator, filter and muscle
    activations, the exact discretization for filterexact, then the
    actrange clamp (mj_advance / mj_nextActivation)."""
    act = d.act + dt * d.act_dot
    exact = np.nonzero(np.asarray(m.actuator_dyntype) == M.DYN_FILTEREXACT)[0]
    if exact.size:
        aadr = m.idx(A._last_act(m, exact))
        tau = torch.clamp(m.actuator_dynprm[..., m.idx(exact), 0], min=M.MINVAL)
        act[:, aadr] = d.act[:, aadr] + d.act_dot[:, aadr] * tau * (1.0 - torch.exp(-dt / tau))
    return A.clamp_act(m, act)


def step(m: M.Model, d: M.Data, device="cuda") -> M.Data:
    """One physics step for every env: forward dynamics + semi-implicit
    Euler (MuJoCo's integrator, joint damping implicit: the velocity
    update solves (M + h diag(damping)) v' = M v + h f_total)."""
    dev = _on_model_device(m, device)
    check_device(dev, qpos=d.qpos, qvel=d.qvel, ctrl=d.ctrl)
    d = forward(m, d)
    dt = m.opt_b("timestep", 2)  # 0-d, or per env (B, 1) off the kernel layout
    # the solve produced the Euler update
    qvel_new = d.qvel_next
    qpos_new = _integrate_pos(m, d.qpos, qvel_new, dt)
    act_new = _integrate_act(m, d, dt) if m.na else d.act
    return d.replace(qpos=qpos_new, qvel=qvel_new, act=act_new,
                     time=d.time + m.opt_b("timestep", 1))
