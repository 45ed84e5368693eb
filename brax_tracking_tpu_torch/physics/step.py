"""Forward dynamics and integration entry points, batch-first.

Counterpart of ``brax_tracking_tpu/physics/step.py``: ``forward`` runs
mj_forward's stage order over a batch of envs, ``step`` adds semi-implicit
Euler integration with MuJoCo's implicit joint damping; ``forward`` ends
with the sensors (physics/sensor.py). On the kernel path
the Euler velocity update comes out of the solve (the kernel's own tail, or
one ``spd_solve`` after the chunked Newton dispatch on a damped model) as
``qvel_next``; on the XLA-CG path it takes (M + h diag(damping))^-1 from
``invert_m``, on the Newton path one ``spd_solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.device import check_device, resolve_device, same_device
from brax_tracking_tpu_torch.ops import cholesky as ops_chol
from brax_tracking_tpu_torch.physics import actuation as A
from brax_tracking_tpu_torch.physics import collision as C
from brax_tracking_tpu_torch.physics import constraint as Cn
from brax_tracking_tpu_torch.physics import dynamics as D
from brax_tracking_tpu_torch.physics import kinematics as K
from brax_tracking_tpu_torch.physics import model as M
from brax_tracking_tpu_torch.physics import passive as P
from brax_tracking_tpu_torch.physics import sensor as Sn
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
    solve reads. Off the kernel layout this includes the dense qM, on the
    CG path its inverses, and qacc_smooth. On the kernel layout a damped
    Newton model also gets the dense qM: its Euler update solves with
    M + h diag(damping) after the kernel's chunks."""
    kernel = S.quad_kernel_eligible(m)
    newton = m.opt.solver == M.SOLVER_NEWTON
    d = C.collision(m, fwd_position_smooth(m, d))
    d = D.crb(m, d, dense=not kernel or (newton and m.has_damping))
    if not kernel and not newton:
        # the XLA-CG path's preconditioner (and, damped, the Euler
        # update's implicit damping); Newton needs single solves only
        d = D.invert_m(m, d)
    d = fwd_velocity_smooth(m, d)
    d = P.passive(m, d)
    d = D.rne(m, d)
    d = A.fwd_actuation(m, d)
    qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
    if kernel:
        # qacc_smooth is produced by the solve kernel, which holds M^-1
        d = d.replace(qfrc_smooth=qfrc_smooth)
    elif newton:
        qacc_smooth = ops_chol.spd_solve(d.qM, qfrc_smooth, device=m.device)
        d = d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)
    else:
        d = d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=D.solve_m(m, d, qfrc_smooth))
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
    if d.qvel_next is not None:
        # the solve kernel produced the Euler update
        qvel_new = d.qvel_next
    elif m.has_damping:
        # damping is already inside qfrc_smooth, so the implicit update is
        # v' = v + h (M + hB)^-1 (qfrc_smooth + qfrc_constraint)
        qfrc = d.qfrc_smooth + d.qfrc_constraint
        if d.qMhinv is not None:
            qvel_new = d.qvel + dt * (d.qMhinv @ qfrc[..., None])[..., 0]
        else:
            mh = d.qM + torch.diag_embed(m.dof_damping * dt)
            qvel_new = d.qvel + dt * ops_chol.spd_solve(mh, qfrc, device=m.device)
    else:
        qvel_new = d.qvel + dt * d.qacc
    qpos_new = _integrate_pos(m, d.qpos, qvel_new, dt)
    act_new = _integrate_act(m, d, dt) if m.na else d.act
    return d.replace(qpos=qpos_new, qvel=qvel_new, act=act_new,
                     time=d.time + m.opt_b("timestep", 1))
