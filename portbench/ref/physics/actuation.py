"""Actuation: transmission, activation dynamics, gain and bias force,
batch-first.

Counterpart of ``brax_tracking_tpu/physics/actuation.py`` (mj_fwdActuation
semantics): hinge-, slide- and ball-joint and fixed-tendon transmissions; no,
integrator, filter, filterexact and muscle activation dynamics; fixed,
affine and muscle gain; no, affine and muscle bias; the ctrl and force
clamps; and the post-integration activation clamp. Site and slider-crank
transmissions raise.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import model as M


def _transmission(m: M.Model) -> dict:
    """Static transmission tables, built once per model: the actuators of
    each kind (hinge or slide joint, ball joint, fixed tendon) with their addresses
    and gears, in the order ``_moment_length_velocity`` stacks them, and
    the column permutation back to actuator order (None when the stacked
    order already is it)."""
    tr = m.cache.get("transmission")
    if tr is not None:
        return tr
    trn = np.asarray(m.actuator_trntype)
    tid = np.asarray(m.actuator_trnid)[:, 0]
    if np.any((trn != M.TRN_JOINT) & (trn != M.TRN_TENDON)):
        M.unported("site and slider-crank transmissions", "§A.12")
    joint = trn == M.TRN_JOINT
    jtype = np.where(joint, np.asarray(m.jnt_type)[np.where(joint, tid, 0)], -1)
    if np.any(joint & (jtype == M.JNT_FREE)):
        M.unported("transmission through a free joint (the JAX package raises too)", "§A.12")
    qadrs, dadrs = np.asarray(m.jnt_qposadr), np.asarray(m.jnt_dofadr)
    parts = []
    # per-env gears (B, n) when the model is randomized
    hinge = np.nonzero((jtype == M.JNT_HINGE) | (jtype == M.JNT_SLIDE))[0]
    if hinge.size:
        parts.append(("hinge", hinge, dict(
            qadr=m.idx(qadrs[tid[hinge]]), dadr=m.idx(dadrs[tid[hinge]]),
            gear=m.actuator_gear[..., m.idx(hinge), 0],
        )))
    ball = np.nonzero(jtype == M.JNT_BALL)[0]
    if ball.size:
        parts.append(("ball", ball, dict(
            qadr=m.idx(qadrs[tid[ball]][:, None] + np.arange(4)),  # (n, 4)
            dadr=m.idx(dadrs[tid[ball]][:, None] + np.arange(3)),  # (n, 3)
            gear=m.actuator_gear[..., m.idx(ball), :3],  # (n, 3)
        )))
    ten = np.nonzero(trn == M.TRN_TENDON)[0]
    if ten.size:
        parts.append(("tendon", ten, dict(
            tid=m.idx(tid[ten]), gear=m.actuator_gear[..., m.idx(ten), 0],
        )))
    cols = np.concatenate([u for _, u, _ in parts]) if parts else np.zeros(0, int)
    identity = np.array_equal(cols, np.arange(m.nu))
    tr = dict(
        parts=parts,
        sizes=[u.size for _, u, _ in parts],
        cols=None if identity else m.idx(cols),
        perm=None if identity else m.idx(np.argsort(cols)),
    )
    m.cache["transmission"] = tr
    return tr


def _moment_length_velocity(m: M.Model, d: M.Data):
    """Actuator transmission (mj_transmission), grouped by kind:

    - hinge or slide joint: length = gear0 qpos, moment gear0 at the dof;
    - ball joint: length = gear[:3] . quat2vel(qpos4), moment the constant
      gear[:3] over the joint's 3 dofs;
    - fixed tendon: length = gear0 ten_length, moment gear0 ten_J.

    Returns (length, velocity) (B, nu) and a function mapping actuator
    forces (B, nu) to qfrc_actuator = moment^T force (B, nv). A model with
    one kind of transmission in actuator order (the minirat) stacks and
    permutes nothing.
    """
    tr = _transmission(m)
    lengths, velocities, moments = [], [], []
    for kind, _, t in tr["parts"]:
        if kind == "hinge":
            lengths.append(d.qpos[:, t["qadr"]] * t["gear"])
            velocities.append(d.qvel[:, t["dadr"]] * t["gear"])
        elif kind == "ball":
            q = d.qpos[:, t["qadr"]]  # (B, n, 4)
            lengths.append(torch.sum(t["gear"] * btm.quat_to_axis_angle(q), -1))
            velocities.append(torch.sum(t["gear"] * d.qvel[:, t["dadr"]], -1))
        else:
            moment = t["gear"][..., None] * d.ten_J[:, t["tid"]]  # (B, n, nv)
            lengths.append(d.ten_length[:, t["tid"]] * t["gear"])
            velocities.append((moment @ d.qvel[..., None])[..., 0])
            moments.append(moment)

    def stack(parts):
        x = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
        return x if tr["perm"] is None else x[:, tr["perm"]]

    def to_qfrc(force: torch.Tensor) -> torch.Tensor:
        f = force if tr["cols"] is None else force[:, tr["cols"]]
        chunks = f.split(tr["sizes"], 1) if len(tr["sizes"]) > 1 else (f,)
        qfrc = torch.zeros_like(d.qvel)
        moment = iter(moments)
        for (kind, _, t), fk in zip(tr["parts"], chunks):
            if kind == "hinge":
                qfrc.index_add_(1, t["dadr"], t["gear"] * fk)
            elif kind == "ball":
                qfrc.index_add_(1, t["dadr"].reshape(-1), (t["gear"] * fk[..., None]).flatten(1))
            else:
                qfrc = qfrc + (next(moment).transpose(-1, -2) @ fk[..., None])[..., 0]
        return qfrc

    return stack(lengths), stack(velocities), to_qfrc


def _sigmoid(x):
    """mju_sigmoid: quintic smoothstep clamped to [0, 1]."""
    xc = torch.clamp(x, 0.0, 1.0)
    return xc * xc * xc * (xc * (xc * 6.0 - 15.0) + 10.0)


def _muscle_lv(length, vel, lengthrange, prm):
    """Normalized muscle length L and velocity V (mju_muscleGain prologue)."""
    r0, r1 = prm[..., 0], prm[..., 1]
    vmax = prm[..., 6]
    L0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp(r1 - r0, min=M.MINVAL)
    L = r0 + (length - lengthrange[..., 0]) / torch.clamp(L0, min=M.MINVAL)
    V = vel / torch.clamp(L0 * vmax, min=M.MINVAL)
    return L, V


def _muscle_force(force, scale, acc0):
    """A negative force means auto-scale by scale / acc0."""
    return torch.where(force < 0, scale / torch.clamp(acc0, min=M.MINVAL), force)


def muscle_gain(length, vel, lengthrange, acc0, prm):
    """mju_muscleGain: active force-length-velocity gain, negative (a
    muscle pulls). prm = (range0, range1, force, scale, lmin, lmax, vmax,
    fpmax, fvmax)."""
    force = _muscle_force(prm[..., 2], prm[..., 3], acc0)
    lmin, lmax, fvmax = prm[..., 4], prm[..., 5], prm[..., 8]
    L, V = _muscle_lv(length, vel, lengthrange, prm)
    zero = torch.zeros((), dtype=L.dtype, device=L.device)

    a = 0.5 * (lmin + 1.0)
    b = 0.5 * (1.0 + lmax)
    x1 = (L - lmin) / torch.clamp(a - lmin, min=M.MINVAL)
    x2 = (1.0 - L) / torch.clamp(1.0 - a, min=M.MINVAL)
    x3 = (L - 1.0) / torch.clamp(b - 1.0, min=M.MINVAL)
    x4 = (lmax - L) / torch.clamp(lmax - b, min=M.MINVAL)
    FL = torch.where(
        (L >= lmin) & (L <= a),
        0.5 * x1 * x1,
        torch.where(
            (L > a) & (L <= 1.0),
            1.0 - 0.5 * x2 * x2,
            torch.where(
                (L > 1.0) & (L <= b),
                1.0 - 0.5 * x3 * x3,
                torch.where((L > b) & (L <= lmax), 0.5 * x4 * x4, zero),
            ),
        ),
    )
    y = fvmax - 1.0
    FV = torch.where(
        V <= -1.0,
        zero,
        torch.where(
            V <= 0.0,
            (V + 1.0) * (V + 1.0),
            torch.where(
                V <= y, fvmax - (y - V) * (y - V) / torch.clamp(y, min=M.MINVAL), fvmax
            ),
        ),
    )
    return -force * FL * FV


def muscle_bias(length, lengthrange, acc0, prm):
    """mju_muscleBias: passive force, half-quadratic then linear beyond b."""
    force = _muscle_force(prm[..., 2], prm[..., 3], acc0)
    lmax, fpmax = prm[..., 5], prm[..., 7]
    L, _ = _muscle_lv(length, torch.zeros_like(length), lengthrange, prm)
    b = 0.5 * (1.0 + lmax)
    xq = (L - 1.0) / torch.clamp(b - 1.0, min=M.MINVAL)
    xl = (L - b) / torch.clamp(b - 1.0, min=M.MINVAL)
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    return torch.where(
        L <= 1.0,
        zero,
        torch.where(L <= b, -force * fpmax * 0.5 * xq * xq, -force * fpmax * (0.5 + xl)),
    )


def muscle_dynamics(ctrl, act, prm):
    """mju_muscleDynamics: activation-dependent time constants, with
    optional smoothing. prm = (tau_act, tau_deact, smoothing_width)."""
    ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
    actclamp = torch.clamp(act, 0.0, 1.0)
    tau_act = prm[..., 0] * (0.5 + 1.5 * actclamp)
    tau_deact = prm[..., 1] / (0.5 + 1.5 * actclamp)
    width = prm[..., 2]
    dctrl = ctrlclamp - act
    tau_hard = torch.where(dctrl > 0, tau_act, tau_deact)
    tau_smooth = tau_deact + (tau_act - tau_deact) * _sigmoid(
        dctrl / torch.clamp(width, min=M.MINVAL) + 0.5
    )
    tau = torch.where(width < M.MINVAL, tau_hard, tau_smooth)
    return dctrl / torch.clamp(tau, min=M.MINVAL)


def _last_act(m: M.Model, u: np.ndarray) -> np.ndarray:
    """Address of the last activation slot of each actuator in ``u``."""
    return np.asarray(m.actuator_actadr)[u] + np.asarray(m.actuator_actnum)[u] - 1


def fwd_actuation(m: M.Model, d: M.Data) -> M.Data:
    B = d.qpos.shape[0]
    if m.nu == 0:
        return d.replace(
            qfrc_actuator=torch.zeros_like(d.qvel),
            actuator_force=d.qpos.new_zeros(B, 0),
            act_dot=d.qpos.new_zeros(B, 0),
        )
    dyntype = np.asarray(m.actuator_dyntype)
    known = (M.DYN_NONE, M.DYN_INTEGRATOR, M.DYN_FILTER, M.DYN_FILTEREXACT, M.DYN_MUSCLE)
    if not np.all(np.isin(dyntype, known)):
        M.unported("user activation dynamics", "§A.12")

    # clamp ctrl
    ctrl = d.ctrl
    lim = m.const(m.actuator_ctrllimited, torch.bool)
    lo, hi = m.actuator_ctrlrange[..., 0], m.actuator_ctrlrange[..., 1]
    ctrl = torch.where(lim, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)

    length, velocity, to_qfrc = _moment_length_velocity(m, d)

    # activation dynamics and the actuator input (ctrl, or the activation)
    act_dot = d.qpos.new_zeros(B, m.na)
    inp = ctrl
    stateful = np.nonzero(dyntype != M.DYN_NONE)[0]
    if stateful.size:
        inp = ctrl.clone()
        u = m.idx(stateful)
        aadr = m.idx(_last_act(m, stateful))
        act_u = d.act[:, aadr]
        inp[:, u] = act_u
        dyn = dyntype[stateful]
        tau = torch.clamp(m.actuator_dynprm[..., u, 0], min=M.MINVAL)
        filt = (ctrl[:, u] - act_u) / tau
        rate = torch.where(m.const(dyn == M.DYN_INTEGRATOR, torch.bool), ctrl[:, u], filt)
        if np.any(dyn == M.DYN_MUSCLE):
            mus = muscle_dynamics(ctrl[:, u], act_u, m.actuator_dynprm[..., u, :])
            rate = torch.where(m.const(dyn == M.DYN_MUSCLE, torch.bool), mus, rate)
        act_dot[:, aadr] = rate

    lr = m.actuator_lengthrange
    acc0 = m.actuator_acc0

    # gain
    gaintype = np.asarray(m.actuator_gaintype)
    gp = m.actuator_gainprm
    gain = gp[..., 0].expand(B, m.nu)
    if np.any(gaintype == M.GAIN_AFFINE):
        gain = torch.where(
            m.const(gaintype == M.GAIN_AFFINE, torch.bool),
            gp[..., 0] + gp[..., 1] * length + gp[..., 2] * velocity,
            gain,
        )
    if np.any(gaintype == M.GAIN_MUSCLE):
        gain = torch.where(
            m.const(gaintype == M.GAIN_MUSCLE, torch.bool),
            muscle_gain(length, velocity, lr, acc0, gp),
            gain,
        )
    # bias
    biastype = np.asarray(m.actuator_biastype)
    bp = m.actuator_biasprm
    bias = torch.zeros_like(length)
    if np.any(biastype == M.BIAS_AFFINE):
        bias = torch.where(
            m.const(biastype == M.BIAS_AFFINE, torch.bool),
            bp[..., 0] + bp[..., 1] * length + bp[..., 2] * velocity,
            bias,
        )
    if np.any(biastype == M.BIAS_MUSCLE):
        bias = torch.where(
            m.const(biastype == M.BIAS_MUSCLE, torch.bool),
            muscle_bias(length, lr, acc0, bp),
            bias,
        )
    force = gain * inp + bias

    flim = m.const(m.actuator_forcelimited, torch.bool)
    flo, fhi = m.actuator_forcerange[..., 0], m.actuator_forcerange[..., 1]
    force = torch.where(flim, torch.minimum(torch.maximum(force, flo), fhi), force)

    return d.replace(qfrc_actuator=to_qfrc(force), actuator_force=force, act_dot=act_dot)


def clamp_act(m: M.Model, act: torch.Tensor) -> torch.Tensor:
    """Post-integration activation clamp to actrange (actlimited
    actuators, every activation slot of each)."""
    limited = np.nonzero(np.asarray(m.actuator_actlimited))[0]
    if m.na == 0 or not limited.size:
        return act
    adr = np.asarray(m.actuator_actadr)[limited]
    num = np.asarray(m.actuator_actnum)[limited]
    slots = np.concatenate([a + np.arange(n) for a, n in zip(adr, num)])
    owner = np.repeat(limited, num)
    s = m.idx(slots)
    rng = m.actuator_actrange[..., m.idx(owner), :]
    out = act.clone()
    out[:, s] = torch.minimum(torch.maximum(act[:, s], rng[..., 0]), rng[..., 1])
    return out
