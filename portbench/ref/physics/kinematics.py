"""Forward kinematics and CoM-frame quantities, batch-first.

Counterpart of ``brax_tracking_tpu/physics/kinematics.py`` (MuJoCo
mj_kinematics / mj_comPos / mj_tendon for fixed tendons / mj_comVel
semantics) for free, ball, slide and hinge joints. Bodies are never looped
over: each joint slot group is one wide op, world transforms are composed
by pointer jumping over the body tree, and tree sums are products with the
plan's static subtree mask.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.math.spatial import motion_cross_cm, transform_inertia_cm
from portbench.ref.physics import model as M


def _joint_slot_groups(m: M.Model):
    """Static grouping of joints by (within-body slot, type): returns
    (max_slot, groups) with groups[slot][type] an int array of joint ids."""
    jb = np.asarray(m.jnt_bodyid)
    jt = np.asarray(m.jnt_type)
    slot = np.zeros(m.njnt, np.int64)
    seen: dict = {}
    for j in range(m.njnt):
        b = int(jb[j])
        slot[j] = seen.get(b, 0)
        seen[b] = int(slot[j]) + 1
    max_slot = int(slot.max()) + 1 if m.njnt else 0
    groups = [
        {t: np.nonzero((slot == s) & (jt == t))[0] for t in range(4)}
        for s in range(max_slot)
    ]
    return max_slot, groups


def kinematics(m: M.Model, d: M.Data) -> M.Data:
    """mj_kinematics: qpos -> body/joint/geom/site world frames."""
    qpos = d.qpos
    B = qpos.shape[0]
    nb, nj = m.nbody, m.njnt
    rot = btm.quat_rotate
    max_slot, groups = _joint_slot_groups(m)
    jb = np.asarray(m.jnt_bodyid)

    # per-body local (parent-relative) transform, wide over joint slots
    Lq = m.body_quat.expand(B, nb, 4).clone()
    Lp = m.body_pos.expand(B, nb, 3).clone()
    # pre-joint local prefix per joint (for anchors/axes after jumping)
    preq = torch.zeros(B, nj, 4, dtype=qpos.dtype, device=qpos.device)
    preq[..., 0] = 1.0
    prep = torch.zeros(B, nj, 3, dtype=qpos.dtype, device=qpos.device)
    free_jids = np.nonzero(np.asarray(m.jnt_type) == M.JNT_FREE)[0]

    for s in range(max_slot):
        for t in (M.JNT_HINGE, M.JNT_SLIDE, M.JNT_BALL):
            jids = groups[s][t]
            if not jids.size:
                continue
            bodies = m.idx(jb[jids])
            ji = m.idx(jids)
            jpos = m.jnt_pos[..., ji, :]
            q_s, p_s = Lq[:, bodies], Lp[:, bodies]
            preq[:, ji] = q_s
            prep[:, ji] = p_s
            qadr = np.asarray(m.jnt_qposadr)[jids]
            if t == M.JNT_SLIDE:  # a translation along the axis, no rotation
                qa = m.idx(qadr)
                disp = qpos[:, qa] - m.qpos0[..., qa]
                Lp[:, bodies] = p_s + rot(q_s, m.jnt_axis[..., ji, :] * disp[..., None])
                continue
            if t == M.JNT_HINGE:
                qa = m.idx(qadr)
                qloc = btm.axis_angle_to_quat(m.jnt_axis[..., ji, :], qpos[:, qa] - m.qpos0[..., qa])
            else:  # ball: the joint's quaternion straight from qpos
                qloc = btm.quat_normalize(qpos[:, m.idx(qadr[:, None] + np.arange(4))])
            tp = jpos - rot(qloc, jpos)
            Lq[:, bodies] = btm.quat_mul(q_s, qloc)
            Lp[:, bodies] = p_s + rot(q_s, tp)
    if free_jids.size:
        # free-joint bodies take their world pose straight from qpos
        fb = m.idx(jb[free_jids])
        fqadr = np.asarray(m.jnt_qposadr)[free_jids]
        Lp[:, fb] = qpos[:, m.idx(fqadr[:, None] + np.arange(3))]
        Lq[:, fb] = btm.quat_normalize(qpos[:, m.idx(fqadr[:, None] + 3 + np.arange(4))])

    # pointer jumping: compose ceil(log2(depth)) ancestor blocks
    anc = np.asarray(m.body_parentid).copy()
    anc[0] = 0  # world is its own (identity) ancestor
    Lq[:, 0] = m.const([1.0, 0.0, 0.0, 0.0])
    Lp[:, 0] = 0.0
    depth = max(m.plan.depth, 1)
    n_jump = max(int(np.ceil(np.log2(depth))), 1)
    q, p = Lq, Lp
    for _ in range(n_jump):
        a = m.idx(anc)
        q_par, p_par = q[:, a], p[:, a]
        p = p_par + rot(q_par, p)
        q = btm.quat_normalize(btm.quat_mul(q_par, q))
        anc = anc[anc]
    xquat, xpos = q, p

    # joint anchors/axes from the pre-joint world transform
    xanchor = torch.zeros(B, nj, 3, dtype=qpos.dtype, device=qpos.device)
    xaxis = torch.zeros_like(xanchor)
    nf = np.nonzero(np.asarray(m.jnt_type) != M.JNT_FREE)[0]
    if nf.size:
        par = m.idx(np.asarray(m.body_parentid)[jb[nf]])
        nfi = m.idx(nf)
        q_par, p_par = xquat[:, par], xpos[:, par]
        q_s = btm.quat_mul(q_par, preq[:, nfi])
        p_s = p_par + rot(q_par, prep[:, nfi])
        xanchor[:, nfi] = rot(q_s, m.jnt_pos[..., nfi, :]) + p_s
        xaxis[:, nfi] = rot(q_s, m.jnt_axis[..., nfi, :])
    if free_jids.size:
        fqadr = np.asarray(m.jnt_qposadr)[free_jids]
        fi = m.idx(free_jids)
        xanchor[:, fi] = qpos[:, m.idx(fqadr[:, None] + np.arange(3))]
        xaxis[:, fi] = m.jnt_axis[..., fi, :]

    xipos = xpos + rot(xquat, m.body_ipos)
    gb = m.idx(m.geom_bodyid)
    geom_xquat = btm.quat_mul(xquat[:, gb], m.geom_quat)
    geom_xpos = xpos[:, gb] + rot(xquat[:, gb], m.geom_pos)
    if m.nsite:
        sb = m.idx(m.site_bodyid)
        site_xquat = btm.quat_mul(xquat[:, sb], m.site_quat)
        site_xpos = xpos[:, sb] + rot(xquat[:, sb], m.site_pos)
    else:
        site_xquat = qpos.new_zeros(B, 0, 4)
        site_xpos = qpos.new_zeros(B, 0, 3)
    return d.replace(
        xpos=xpos,
        xquat=xquat,
        xipos=xipos,
        xanchor=xanchor,
        xaxis=xaxis,
        geom_xpos=geom_xpos,
        geom_xquat=geom_xquat,
        site_xpos=site_xpos,
        site_xquat=site_xquat,
    )


def subtree_mass(m: M.Model, B: int) -> torch.Tensor:
    """(B, nbody) mass of each body's subtree, built once per model and
    batch size. Each env's row is the JAX package's product SUB @ mass, a
    per-env model's one env at a time on a copy of its own (a row inside
    the batch may sit at an address for which the BLAS library picks
    another kernel), so that a batch of equal masses gives the shared
    model's values bit for bit."""
    key = ("subtree_mass", B)
    if key not in m.cache:
        SUB = m.const(m.plan.body_subtree_mask)
        if "body_mass" in m.env_leaves:
            m.cache[key] = torch.stack([SUB @ mass.clone() for mass in m.body_mass])
        else:
            m.cache[key] = (SUB @ m.body_mass).expand(B, m.nbody)
    return m.cache[key]


def com_pos(m: M.Model, d: M.Data) -> M.Data:
    """mj_comPos: subtree CoM, packed cinert, component-major cdof."""
    B = d.qpos.shape[0]
    plan = m.plan
    mass = m.body_mass
    SUB = m.const(plan.body_subtree_mask)
    acc = torch.einsum("pb,nbk->npk", SUB, mass[..., None] * d.xipos)
    submass = subtree_mass(m, B)
    subtree_com = acc / torch.clamp(submass, min=M.MINVAL)[..., None]

    root_com = subtree_com[:, m.idx(m.body_rootid)]
    iquat = btm.quat_mul(d.xquat, m.body_iquat)
    cinert_s, cinert_h = transform_inertia_cm(
        m.body_inertia, mass, iquat, (d.xipos - root_com).transpose(-1, -2)
    )

    cdof = d.qpos.new_zeros(B, 6, m.nv)
    free_j, hinge_j = plan.jnt_by_type[M.JNT_FREE], plan.jnt_by_type[M.JNT_HINGE]
    jb = np.asarray(m.jnt_bodyid)
    rootid = np.asarray(m.body_rootid)
    dofadr = np.asarray(m.jnt_dofadr)
    if hinge_j.size:
        hj = m.idx(hinge_j)
        axis = d.xaxis[:, hj]
        off = subtree_com[:, m.idx(rootid[jb[hinge_j]])] - d.xanchor[:, hj]
        cdof[:, :, m.idx(dofadr[hinge_j])] = torch.cat(
            [axis, torch.linalg.cross(axis, off, dim=-1)], -1
        ).transpose(-1, -2)
    slide_j = plan.jnt_by_type[M.JNT_SLIDE]
    if slide_j.size:
        # a slide dof moves its subtree along the axis: (0, axis)
        axis = d.xaxis[:, m.idx(slide_j)]
        cdof[:, :, m.idx(dofadr[slide_j])] = torch.cat(
            [torch.zeros_like(axis), axis], -1
        ).transpose(-1, -2)
    ball_j = plan.jnt_by_type[M.JNT_BALL]
    for jgrp, rot_off in ((ball_j, 0), (free_j, 3)):
        if not jgrp.size:
            continue
        # rotational dofs: the body frame's axes, about the joint anchor
        b = jb[jgrp]
        off = subtree_com[:, m.idx(rootid[b])] - d.xanchor[:, m.idx(jgrp)]  # (B, n, 3)
        cols = btm.quat_to_mat(d.xquat[:, m.idx(b)]).transpose(-1, -2)
        lin = torch.linalg.cross(cols, off[:, :, None, :].expand_as(cols), dim=-1)
        rows = torch.cat([cols, lin], -1)  # (B, n, 3, 6)
        dadr = (dofadr[jgrp] + rot_off)[:, None] + np.arange(3)[None, :]
        cdof[:, :, m.idx(dadr.reshape(-1))] = rows.reshape(B, -1, 6).transpose(-1, -2)
    if free_j.size:
        dadr = dofadr[free_j][:, None] + np.arange(3)[None, :]
        eye = np.tile(np.concatenate([np.zeros((3, 3)), np.eye(3)], -1), (free_j.size, 1))
        cdof[:, :, m.idx(dadr.reshape(-1))] = m.const(eye.T)
    return d.replace(
        subtree_com=subtree_com, cinert_s=cinert_s, cinert_h=cinert_h, cdof=cdof
    )


def tendon(m: M.Model, d: M.Data) -> M.Data:
    """Fixed-tendon lengths and jacobians: each tendon is a static
    combination of joint positions, so its jacobian is a constant scatter
    of the wrap coefficients."""
    if not m.ntendon:
        return d
    B = d.qpos.shape[0]
    # wrap w belongs to tendon t(w)
    t_of_w = np.repeat(np.arange(m.ntendon), np.asarray(m.tendon_num))
    jids = np.asarray(m.wrap_objid)
    qadr = m.idx(np.asarray(m.jnt_qposadr)[jids])
    dadr = np.asarray(m.jnt_dofadr)[jids]
    coef = m.wrap_prm  # (nwrap,), per env (B, nwrap)
    # a product with the static wrap -> tendon one-hot matrix, not a
    # scatter-add: its order is fixed on the card too, so equal inputs give
    # equal bits (a CUDA index_add_ adds in the order its atomics land)
    length = (coef * d.qpos[:, qadr]) @ m.const(np.eye(m.ntendon)[t_of_w])
    lead = coef.shape[:-1]
    J = coef.new_zeros(*lead, m.ntendon * m.nv).index_add_(
        -1, m.idx(t_of_w * m.nv + dadr), coef
    ).reshape(*lead, m.ntendon, m.nv)
    return d.replace(ten_length=length, ten_J=J.expand(B, m.ntendon, m.nv))


def com_vel(m: M.Model, d: M.Data) -> M.Data:
    """mj_comVel: component-major cvel and cdof time-derivatives."""
    plan = m.plan
    contrib = d.cdof * d.qvel[:, None, :]  # (B, 6, nv)
    # dof -> body accumulation and root-to-body prefix sum as products
    D2B = m.const(np.eye(m.nbody)[np.asarray(m.dof_bodyid)])  # (nv, nbody)
    own = contrib @ D2B  # (B, 6, nbody)
    cvel = own @ m.const(plan.body_subtree_mask)

    # velocity "before" each dof's joint sub-group, for cdof_dot
    S = m.const(plan.dof_suffix_mask)
    vbefore = cvel[:, :, m.idx(m.dof_bodyid)] - contrib @ S.T
    cdof_dot = motion_cross_cm(vbefore, d.cdof)
    cdof_dot = torch.where(
        m.const(plan.free_trans_dof, torch.bool), 0.0, cdof_dot
    )
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)
