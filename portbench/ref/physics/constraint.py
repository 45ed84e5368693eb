"""Constraint row assembly: scalar and ball joint limits, pyramidal and
elliptic (condim 3) contacts.

Counterpart of ``brax_tracking_tpu/physics/constraint.py`` with the same
static row layout: every candidate constraint always owns its rows, and
activation is run-time masking. Rows are scalar limits first, then ball
limits, then contacts; an elliptic contact owns a normal and two friction
rows [n, t1, t2]. Condim > 3 raises.

On the kernel layout the dense contact jacobian is not materialized: the
solve kernel assembles it from the per-contact operators ``con_A`` (J =
(P A) cdof * md, see ``_contact_jac``), and the row velocities aref needs
come from the same factors without it. The frozen copy
solves on that layout only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import model as M

# efc row types
ROW_LIMIT, ROW_CON_NORMAL, ROW_CON_FRICTION, ROW_CON_PYRAMID = 0, 1, 2, 3


@dataclass(frozen=True)
class EfcLayout:
    """Static efc row metadata (built once per model)."""

    nefc: int
    row_type: np.ndarray  # (nefc,)
    row_con: np.ndarray  # (nefc,) contact slot id or -1
    row_fdim: np.ndarray  # (nefc,) friction dim index (elliptic) / pyramid idx
    limit_jnt: np.ndarray  # limited scalar (hinge/slide) joint ids, row order
    limit_rows: np.ndarray  # row index of each scalar limit row
    limit_ball_jnt: np.ndarray  # limited BALL joint ids
    limit_ball_rows: np.ndarray  # row index of each ball limit row
    con_rows: np.ndarray  # (ncon,) first row of each contact slot
    con_dim: np.ndarray  # (ncon,) condim per slot
    con_pair: np.ndarray  # (ncon,) pair index per slot
    con_geom1: np.ndarray
    con_geom2: np.ndarray


def efc_layout(m: M.Model) -> EfcLayout:
    """The static row layout, computed once per model."""
    layout = m.cache.get("efc_layout")
    if layout is None:
        layout = _efc_layout(m)
        m.cache["efc_layout"] = layout
    return layout


def _efc_layout(m: M.Model) -> EfcLayout:
    limited = np.nonzero(np.asarray(m.jnt_limited))[0]
    for j in limited:
        if m.jnt_type[j] == M.JNT_FREE:
            # matches MuJoCo: free joints cannot be limited
            raise NotImplementedError("free joint limits")
    # scalar (hinge/slide) limits in joint order, then ball limits, then
    # contacts
    scalar = [j for j in limited if m.jnt_type[j] in (M.JNT_HINGE, M.JNT_SLIDE)]
    balls = [j for j in limited if m.jnt_type[j] == M.JNT_BALL]
    rows_type, rows_con, rows_fdim = [], [], []
    limit_rows, limit_ball_rows = [], []
    for j in scalar:
        limit_rows.append(len(rows_type))
        rows_type.append(ROW_LIMIT)
        rows_con.append(-1)
        rows_fdim.append(0)
    for j in balls:
        limit_ball_rows.append(len(rows_type))
        rows_type.append(ROW_LIMIT)
        rows_con.append(-1)
        rows_fdim.append(0)

    pairs = m.pairs
    ncon = m.ncon
    con_rows = np.full(ncon, -1, np.int32)
    con_dim = np.zeros(ncon, np.int32)
    con_pair = np.zeros(ncon, np.int32)
    con_g1 = np.zeros(ncon, np.int32)
    con_g2 = np.zeros(ncon, np.int32)
    slot = 0
    elliptic = m.opt.cone == M.CONE_ELLIPTIC
    for p in range(len(pairs.geom1)):
        dim = int(pairs.condim[p])
        for _ in range(int(pairs.npoint[p])):
            con_rows[slot] = len(rows_type)
            con_dim[slot] = dim
            con_pair[slot] = p
            con_g1[slot] = pairs.geom1[p]
            con_g2[slot] = pairs.geom2[p]
            if dim == 1:
                rows_type.append(ROW_CON_NORMAL)
                rows_con.append(slot)
                rows_fdim.append(0)
            elif elliptic:
                for k in range(dim):
                    rows_type.append(ROW_CON_NORMAL if k == 0 else ROW_CON_FRICTION)
                    rows_con.append(slot)
                    rows_fdim.append(k)
            else:
                for k in range(2 * (dim - 1)):
                    rows_type.append(ROW_CON_PYRAMID)
                    rows_con.append(slot)
                    rows_fdim.append(k)
            slot += 1

    return EfcLayout(
        nefc=len(rows_type),
        row_type=np.array(rows_type, np.int32),
        row_con=np.array(rows_con, np.int32),
        row_fdim=np.array(rows_fdim, np.int32),
        limit_jnt=np.array(scalar, np.int32),
        limit_rows=np.array(limit_rows, np.int32),
        limit_ball_jnt=np.array(balls, np.int32),
        limit_ball_rows=np.array(limit_ball_rows, np.int32),
        con_rows=con_rows,
        con_dim=con_dim,
        con_pair=con_pair,
        con_geom1=con_g1,
        con_geom2=con_g2,
    )


def _kbi(m: M.Model, solref, solimp, pos):
    """solref/solimp -> (stiffness, damping, impedance) per row; pos is the
    violation r = efc_pos - margin (<= 0 when active)."""
    timeconst = solref[..., 0]
    dampratio = solref[..., 1]
    dmin, dmax = solimp[..., 0], solimp[..., 1]
    width = torch.clamp(solimp[..., 2], min=M.MINVAL)
    mid = torch.clamp(solimp[..., 3], 0.0001, 0.9999)
    power = torch.clamp(solimp[..., 4], min=1.0)

    # impedance sigmoid
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1)
    b = 1.0 / torch.pow(1 - mid, power - 1)
    y = torch.where(x <= mid, a * torch.pow(x, power), 1 - b * torch.pow(1 - x, power))
    imp = dmin + y * (dmax - dmin)
    imp = torch.minimum(torch.maximum(imp, dmin), dmax)
    imp = torch.clamp(imp, M.MINVAL, 1 - M.MINVAL)

    # stiffness / damping
    dt = m.opt_b("timestep", 2)
    tc = torch.maximum(timeconst, 2 * dt)
    k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * dampratio * dampratio, min=M.MINVAL)
    b_std = 2.0 / torch.clamp(dmax * tc, min=M.MINVAL)
    direct = solref[..., 0] <= 0
    k = torch.where(direct, -solref[..., 0] / torch.clamp(dmax * dmax, min=M.MINVAL), k_std)
    b = torch.where(direct, -solref[..., 1] / torch.clamp(dmax, min=M.MINVAL), b_std)
    return k, b, imp


def _contact_jac(m: M.Model, d: M.Data, layout: EfcLayout, dense: bool = False):
    """Per-root contact-point operators and the contact-frame velocities.

    With off = p_c - com(root), frame_row . (lin_v + ang_v x off) =
    [off x frame_row | frame_row] . cdof_v, so per kinematic root the
    translational jacobian of slot c is A[c] @ cdof (A: (3, 6)), masked by
    the static support mask md[c] (body2's dofs minus body1's). Returns
    (con_A (B, nroots, ncon, 3, 6), jvel (B, ncon, 3) = J qvel, jac), jac
    the dense (B, ncon, 3, nv) jacobian with ``dense`` (the JAX package's
    ``_contact_jac``; jvel is then jac qvel), else None.
    """
    b1 = np.asarray(m.geom_bodyid)[layout.con_geom1]
    b2 = np.asarray(m.geom_bodyid)[layout.con_geom2]
    bdm = np.asarray(m.body_dof_mask, np.float64)
    md = bdm[b2] - bdm[b1]  # (ncon, nv): normal points g1 -> g2
    p = d.contact_pos  # (B, ncon, 3)
    F = d.contact_frame  # (B, ncon, 3, 3)

    dof_root = np.asarray(m.body_rootid)[np.asarray(m.dof_bodyid)]
    roots = np.unique(dof_root)
    A_stack, jvel, jac = [], 0.0, None
    for r in roots:
        off = p - d.subtree_com[:, int(r)][:, None, :]
        ofx = torch.linalg.cross(off[:, :, None, :].expand_as(F), F, dim=-1)
        A = torch.cat([ofx, F], dim=-1)  # (B, ncon, 3, 6)
        A_stack.append(A)
        if dense:
            Jr = torch.einsum("bcnk,bkv->bcnv", A, d.cdof)
            if roots.size > 1:
                Jr = Jr * m.const(dof_root == r)
            jac = Jr if jac is None else jac + Jr
            continue
        # J qvel = A (cdof (md_r * qvel)) per slot, without J itself
        md_r = m.const(md * (dof_root == r)[None, :])
        w = torch.einsum("bkv,cv,bv->bck", d.cdof, md_r, d.qvel)
        jvel = jvel + torch.einsum("bcnk,bck->bcn", A, w)
    if dense:
        jac = jac * m.const(md)[:, None, :]
        jvel = torch.einsum("bcnv,bv->bcn", jac, d.qvel)
    return torch.stack(A_stack, dim=1), jvel, jac


def make_constraint(m: M.Model, d: M.Data, dense: bool = None) -> M.Data:
    """efc_jsign / efc_D / efc_aref / efc_pos / efc_margin and con_A; off
    the kernel layout (or with ``dense``) also the dense block efc_Jc. A
    per-env parameter leaf (B, ...) is read past its env axis
    (``[..., idx]``)."""
    from portbench.ref.physics import solver as S

    B = d.qpos.shape[0]
    layout = efc_layout(m)
    nefc = layout.nefc
    if m.ncon and int(np.max(layout.con_dim)) > 3:
        M.unported("torsional and rolling friction (condim > 3)", "§A.12")
    if dense is None:
        dense = not S.quad_kernel_eligible(m)

    zeros = lambda *s: d.qpos.new_zeros(B, *s)
    efc_jsign = zeros(layout.limit_rows.size)
    efc_D, efc_aref, efc_pos, efc_margin = zeros(nefc), zeros(nefc), zeros(nefc), zeros(nefc)
    con_A = efc_Jc = None

    # ---------------- scalar joint limits ----------------
    if layout.limit_jnt.size:
        jids = m.idx(layout.limit_jnt)
        qadr = m.idx(np.asarray(m.jnt_qposadr)[layout.limit_jnt])
        dadr = m.idx(np.asarray(m.jnt_dofadr)[layout.limit_jnt])
        lo, hi = m.jnt_range[..., jids, 0], m.jnt_range[..., jids, 1]
        qp = d.qpos[:, qadr]
        dist_lo = qp - lo
        dist_hi = hi - qp
        use_lo = dist_lo <= dist_hi
        dist = torch.where(use_lo, dist_lo, dist_hi)
        sign = torch.where(use_lo, 1.0, -1.0).to(qp.dtype)
        margin = m.jnt_margin[..., jids]
        k, b, imp = _kbi(m, m.jnt_solref[..., jids, :], m.jnt_solimp[..., jids, :], dist - margin)
        jvel = sign * d.qvel[:, dadr]
        aref = -b * jvel - k * imp * (dist - margin)
        r = torch.clamp((1 - imp) / imp * m.dof_invweight0[..., dadr], min=M.MINVAL)
        rows = m.idx(layout.limit_rows)
        efc_jsign = sign
        efc_D[:, rows] = 1.0 / r
        efc_aref[:, rows] = aref
        efc_pos[:, rows] = dist
        efc_margin[:, rows] = margin.expand(B, -1)

    # ---------------- ball-joint limits (dense rows) ----------------
    # mj_instantiateLimit, mjJNT_BALL branch: a limit on the total rotation
    # angle; dist = max(range) - |angle|, jacobian = -axis over the 3 dofs
    n_ball = int(layout.limit_ball_jnt.size)
    ball_J = None
    if n_ball:
        jids = layout.limit_ball_jnt
        ji = m.idx(jids)
        qadr = np.asarray(m.jnt_qposadr)[jids]
        dadr = np.asarray(m.jnt_dofadr)[jids]
        aa = btm.quat_to_axis_angle(d.qpos[:, m.idx(qadr[:, None] + np.arange(4))])
        angle = torch.linalg.norm(aa, dim=-1)  # (B, n_ball)
        axis = aa / torch.clamp(angle, min=M.MINVAL)[..., None]
        axis = torch.where(
            (angle > M.MINVAL)[..., None], axis, m.const([1.0, 0.0, 0.0]).expand_as(axis)
        )
        dist = torch.maximum(m.jnt_range[..., ji, 0], m.jnt_range[..., ji, 1]) - angle
        margin = m.jnt_margin[..., ji]
        k, b, imp = _kbi(m, m.jnt_solref[..., ji, :], m.jnt_solimp[..., ji, :], dist - margin)
        dofs = m.idx(dadr[:, None] + np.arange(3))  # (n_ball, 3)
        jvel = torch.sum(-axis * d.qvel[:, dofs], dim=-1)
        aref = -b * jvel - k * imp * (dist - margin)
        r = torch.clamp((1 - imp) / imp * m.dof_invweight0[..., m.idx(dadr)], min=M.MINVAL)
        ball_J = d.qpos.new_zeros(B, n_ball, m.nv)
        ball_J[:, m.idx(np.repeat(np.arange(n_ball), 3)), dofs.reshape(-1)] = -axis.reshape(B, -1)
        rows = m.idx(layout.limit_ball_rows)
        efc_D[:, rows] = 1.0 / r
        efc_aref[:, rows] = aref
        efc_pos[:, rows] = dist
        efc_margin[:, rows] = margin.expand(B, -1)
    efc_Jc = ball_J

    # ---------------- contacts ----------------
    if m.ncon:
        pairs = m.pairs
        cp = m.idx(layout.con_pair)
        con_A, jvel, jac = _contact_jac(m, d, layout, dense)  # jvel rows: n, t1, t2
        friction = pairs.friction[..., cp, :]  # (ncon, 5)
        margin = pairs.margin[..., cp]  # oracle (mujoco 3.10): gap does not subtract
        dist = d.contact_dist
        pos_r = dist - margin
        k, b, imp = _kbi(m, pairs.solref[..., cp, :], pairs.solimp[..., cp, :], pos_r)
        b1 = m.idx(np.asarray(m.geom_bodyid)[layout.con_geom1])
        b2 = m.idx(np.asarray(m.geom_bodyid)[layout.con_geom2])
        invweight = m.body_invweight0[..., b1, 0] + m.body_invweight0[..., b2, 0]
        impratio = m.opt_b("impratio", 2)

        # vectorized row assembly over the static layout
        c_rows = np.nonzero(layout.row_con >= 0)[0]
        row0 = int(c_rows[0])
        assert np.array_equal(c_rows, np.arange(row0, row0 + c_rows.size))
        kdim = layout.row_fdim[c_rows]
        rtype = layout.row_type[c_rows]
        slot = m.idx(layout.row_con[c_rows])
        is_pyr = m.const(rtype == ROW_CON_PYRAMID, torch.bool)
        # pyramid decomposition of the fdim index: pairs (+t_i, -t_i)
        i_pyr = kdim // 2
        sgn = m.const(1.0 - 2.0 * (kdim % 2))
        k_ell = m.idx(np.where(rtype == ROW_CON_PYRAMID, 0, kdim))
        i_tan = m.idx(np.where(rtype == ROW_CON_PYRAMID, i_pyr + 1, 0))

        mu_i = friction[..., slot, m.idx(i_pyr)]
        vel = torch.where(
            is_pyr,
            jvel[:, slot, 0] + sgn * mu_i * jvel[:, slot, i_tan],
            jvel[:, slot, k_ell],
        )
        pos_term = k[..., slot] * imp[:, slot] * pos_r[:, slot]
        if np.any(rtype == ROW_CON_FRICTION):
            # elliptic friction rows have no position term
            has_pos = m.const(rtype != ROW_CON_FRICTION, torch.bool)
            pos_term = torch.where(has_pos, pos_term, torch.zeros_like(pos_term))
        aref = -b[..., slot] * vel - pos_term
        invw_pyr = 2.0 * mu_i * mu_i * (1.0 + mu_i * mu_i) * invweight[..., slot]
        invw_ell = torch.where(
            m.const(kdim == 0, torch.bool), invweight[..., slot], invweight[..., slot] / impratio
        )
        invw = torch.where(is_pyr, invw_pyr, invw_ell)
        r_reg = torch.clamp((1 - imp[:, slot]) / imp[:, slot] * invw, min=M.MINVAL)
        n = c_rows.size
        efc_D[:, row0 : row0 + n] = 1.0 / r_reg
        efc_aref[:, row0 : row0 + n] = aref
        efc_pos[:, row0 : row0 + n] = dist[:, slot]
        efc_margin[:, row0 : row0 + n] = margin[..., slot].expand(B, -1)
        if dense:
            # the dense block = [ball-limit rows; contact rows]
            jrow = torch.where(
                is_pyr[:, None],
                jac[:, slot, 0] + (sgn * mu_i)[..., None] * jac[:, slot, i_tan],
                jac[:, slot, k_ell],
            )
            efc_Jc = torch.cat([ball_J, jrow], 1) if n_ball else jrow

    return d.replace(
        con_A=con_A,
        efc_Jc=efc_Jc,
        efc_jsign=efc_jsign,
        efc_D=efc_D,
        efc_aref=efc_aref,
        efc_pos=efc_pos,
        efc_margin=efc_margin,
    )


def limit_dofs(m: M.Model) -> np.ndarray:
    """Static dof address of each scalar limit row."""
    return np.asarray(m.jnt_dofadr)[np.asarray(efc_layout(m).limit_jnt)]


