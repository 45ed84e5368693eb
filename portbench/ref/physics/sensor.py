"""Sensors after the constraint solve, batch-first.

Counterpart of ``brax_tracking_tpu/physics/sensor.py``, the rodent's
sensor types: accelerometer, velocimeter and gyro in their site's frame,
touch and the subtree's linear velocity. They run after the solve, so the
accelerometer reads the solved ``qacc`` and touch the solved
``efc_force``. As in the JAX package, touch sums the normal force of every
contact on the site's body (MuJoCo sums only contacts inside the site's
volume), and the accelerometer adds the convective term w x v to the
site's spatial acceleration. Static tables (each sensor's site, body, root
and columns, touch's slot membership) are numpy; each sensor type is one
batched pass over its sensors.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import constraint as Cn
from portbench.ref.physics import kinematics as K
from portbench.ref.physics import model as M
from portbench.ref.physics import support

_SITE_TYPES = (M.SENS_ACCELEROMETER, M.SENS_VELOCIMETER, M.SENS_GYRO)
_TYPES = _SITE_TYPES + (M.SENS_TOUCH, M.SENS_SUBTREELINVEL)


def _tables(m: M.Model):
    """Per-model sensor tables, built once: for each type its sensors'
    object ids and first columns; touch's (nsensor_touch, ncon) membership
    of the contact slots on the site's body."""
    t = m.cache.get("sensor_tables")
    if t is not None:
        return t
    stype = np.asarray(m.sensor_type)
    for s, ty in enumerate(stype.tolist()):
        if ty not in _TYPES:
            M.unported(f"sensor {s} of type {ty}", "§A.12")
    t = {ty: (np.asarray(m.sensor_objid)[stype == ty], np.asarray(m.sensor_adr)[stype == ty])
         for ty in _TYPES}
    objid, _ = t[M.SENS_TOUCH]
    member = np.zeros((objid.size, m.ncon))
    if objid.size and m.ncon:
        layout = Cn.efc_layout(m)
        gb = np.asarray(m.geom_bodyid)
        b1, b2 = gb[layout.con_geom1], gb[layout.con_geom2]
        body = np.asarray(m.site_bodyid)[objid]
        member = ((b1[None] == body[:, None]) | (b2[None] == body[:, None])).astype(np.float64)
    t["touch_member"] = member
    m.cache["sensor_tables"] = t
    return t


def _cols(adr: np.ndarray, dim: int) -> np.ndarray:
    return adr[:, None] + np.arange(dim)


def sensors(m: M.Model, d: M.Data) -> M.Data:
    """``sensordata`` (B, nsensordata) at the solved state."""
    B = d.qpos.shape[0]
    out = d.qpos.new_zeros(B, m.nsensordata)
    if m.nsensor == 0:
        return d.replace(sensordata=out)
    t = _tables(m)
    cvel_t = d.cvel.transpose(1, 2)  # (B, nbody, 6)

    objid = np.concatenate([t[ty][0] for ty in _SITE_TYPES])
    if objid.size:
        body = np.asarray(m.site_bodyid)[objid]
        root = np.asarray(m.body_rootid)[body]
        site, bi = m.idx(objid), m.idx(body)
        com = d.subtree_com[:, m.idx(root)]
        ang = cvel_t[:, bi, :3]
        lin = cvel_t[:, bi, 3:] + torch.linalg.cross(ang, d.site_xpos[:, site] - com, dim=-1)
        xquat = d.site_xquat[:, site]
        n_acc = t[M.SENS_ACCELEROMETER][0].size
        n_vel = t[M.SENS_VELOCIMETER][0].size
        if n_acc:
            # body spatial accelerations at the c-frame origin from qacc:
            # cacc[b] = (0, -gravity) + sum over the dofs above b of
            # cdof_dot qvel + cdof qacc
            gravity = m.opt.gravity
            cacc0 = torch.cat([torch.zeros_like(gravity), -gravity], -1)
            dof_contrib = d.cdof_dot * d.qvel[:, None, :] + d.cdof * d.qacc[:, None, :]
            d2b = m.const(np.eye(m.nbody)[np.asarray(m.dof_bodyid)])
            cacc = cacc0[..., None] + (dof_contrib @ d2b) @ m.const(m.plan.body_subtree_mask)
            a = slice(0, n_acc)
            cacc_b = cacc.transpose(1, 2)[:, bi[a]]
            off = d.site_xpos[:, site[a]] - com[:, a]
            acc_lin = cacc_b[..., 3:] + torch.linalg.cross(cacc_b[..., :3], off, dim=-1)
            acc_lin = acc_lin + torch.linalg.cross(ang[:, a], lin[:, a], dim=-1)
            out[:, m.idx(_cols(t[M.SENS_ACCELEROMETER][1], 3))] = btm.quat_rotate_inv(
                xquat[:, a], acc_lin)
        v = slice(n_acc, n_acc + n_vel)
        g = slice(n_acc + n_vel, objid.size)
        if n_vel:
            out[:, m.idx(_cols(t[M.SENS_VELOCIMETER][1], 3))] = btm.quat_rotate_inv(
                xquat[:, v], lin[:, v])
        if t[M.SENS_GYRO][0].size:
            out[:, m.idx(_cols(t[M.SENS_GYRO][1], 3))] = btm.quat_rotate_inv(xquat[:, g], ang[:, g])

    objid, adr = t[M.SENS_SUBTREELINVEL]
    if objid.size:
        # the subtree's momentum over its mass
        mass = m.body_mass
        rel = d.xipos - d.subtree_com[:, m.idx(m.body_rootid)]
        mom = mass[..., None] * (cvel_t[..., 3:] + torch.linalg.cross(cvel_t[..., :3], rel, dim=-1))
        sub = m.const(m.plan.body_subtree_mask[objid])  # (n, nbody)
        total = torch.clamp(K.subtree_mass(m, B)[:, m.idx(objid)], min=M.MINVAL)
        out[:, m.idx(_cols(adr, 3))] = (sub @ mom) / total[..., None]

    objid, adr = t[M.SENS_TOUCH]
    if objid.size:
        normal = torch.clamp(support.contact_force(m, d)[..., 0], min=0.0)
        out[:, m.idx(adr)] = normal @ m.const(t["touch_member"]).T
    return d.replace(sensordata=out)
