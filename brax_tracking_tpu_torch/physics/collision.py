"""Narrowphase collision over the static pair table, batch-first.

Counterpart of ``brax_tracking_tpu/physics/collision.py`` for the pair
types the minirat declares: plane-capsule (one contact per end sphere) and
capsule-capsule (closest segment points). There is no broadphase: every
candidate pair owns fixed contact slots, and a slot's activation is the
constraint stage's dist < margin test. Other pair types raise.

Conventions match MuJoCo: the normal points from geom1 into geom2, dist is
the signed surface separation, pos is the midpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch.physics import model as M

_PORTED = {(M.GEOM_PLANE, M.GEOM_CAPSULE), (M.GEOM_CAPSULE, M.GEOM_CAPSULE)}


def make_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) frame [normal; tangent1; tangent2] from normals, with
    mju_makeFrame's helper-axis choice."""
    n = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    near_z = torch.abs(n[..., 2:3]) > 0.5
    ey = n.new_tensor([0.0, 1.0, 0.0]).expand_as(n)
    ez = n.new_tensor([0.0, 0.0, 1.0]).expand_as(n)
    helper = torch.where(near_z, ey, ez)
    t1 = helper - n * torch.sum(n * helper, dim=-1, keepdim=True)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=M.MINVAL)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return torch.stack([n, t1, t2], dim=-2)


def _plane_sphere_point(pn, pp, center, radius):
    """dist & pos of a sphere (center, radius) against a plane (pn, pp)."""
    cdist = torch.sum(pn * (center - pp), dim=-1)
    dist = cdist - radius
    pos = center - pn * (radius + 0.5 * dist)[..., None]
    return dist, pos


def _gz(d: M.Data, g: torch.Tensor) -> torch.Tensor:
    """World z-axis of the selected geom frames, from their quaternions."""
    q = d.geom_xquat[:, g]
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)], -1
    )


def _seg_closest(p, a_c, a_axis, a_half):
    """Closest point to p on the segment centred at a_c along a_axis."""
    tproj = torch.sum((p - a_c) * a_axis, dim=-1)
    tproj = torch.maximum(torch.minimum(tproj, a_half), -a_half)
    return a_c + a_axis * tproj[..., None]


def collision(m: M.Model, d: M.Data) -> M.Data:
    B = d.qpos.shape[0]
    dtype, device = d.qpos.dtype, d.qpos.device
    ncon = m.ncon
    if ncon == 0:
        return d.replace(
            contact_dist=d.qpos.new_zeros(B, 0),
            contact_pos=d.qpos.new_zeros(B, 0, 3),
            contact_frame=d.qpos.new_zeros(B, 0, 3, 3),
        )
    pairs = m.pairs
    g1, g2 = pairs.geom1, pairs.geom2
    t1, t2 = np.asarray(m.geom_type)[g1], np.asarray(m.geom_type)[g2]
    for key in set(zip(t1.tolist(), t2.tolist())) - _PORTED:
        M.unported(f"collision pair of geom types {key}", "§A.12")

    dist = torch.full((B, ncon), 1e10, dtype=dtype, device=device)
    pos = d.qpos.new_zeros(B, ncon, 3)
    frame = torch.eye(3, dtype=dtype, device=device).repeat(B, ncon, 1, 1)
    slot0 = np.concatenate([[0], np.cumsum(pairs.npoint)[:-1]]).astype(np.int64)
    size = m.geom_size

    # ---- plane-capsule: one contact per end sphere ----
    pc = np.nonzero((t1 == M.GEOM_PLANE) & (t2 == M.GEOM_CAPSULE))[0]
    if pc.size:
        gp, gc = m.idx(g1[pc]), m.idx(g2[pc])
        pn = _gz(d, gp)
        pp = d.geom_xpos[:, gp]
        c = d.geom_xpos[:, gc]
        axis = _gz(d, gc)
        r = size[gc, 0]
        half = size[gc, 1]
        # MuJoCo aligns tangent1 with the capsule axis projected onto the
        # plane (helper frame when the axis is perpendicular to it)
        proj = axis - pn * torch.sum(pn * axis, dim=-1, keepdim=True)
        pnorm = torch.linalg.norm(proj, dim=-1, keepdim=True)
        tan1 = proj / torch.clamp(pnorm, min=M.MINVAL)
        tan2 = torch.linalg.cross(pn, tan1, dim=-1)
        fr_axis = torch.stack([pn, tan1, tan2], dim=-2)
        fr = torch.where((pnorm > 1e-10)[..., None], fr_axis, make_frame(pn))
        for endi, sign in enumerate((1.0, -1.0)):
            end = c + sign * axis * half[:, None]
            di, po = _plane_sphere_point(pn, pp, end, r)
            slots = m.idx(slot0[pc] + endi)
            dist[:, slots] = di
            pos[:, slots] = po
            frame[:, slots] = fr

    # ---- capsule-capsule: closest-segment-point spheres ----
    cc = np.nonzero((t1 == M.GEOM_CAPSULE) & (t2 == M.GEOM_CAPSULE))[0]
    if cc.size:
        ga, gb = m.idx(g1[cc]), m.idx(g2[cc])
        c1, ax1 = d.geom_xpos[:, ga], _gz(d, ga)
        r1, h1 = size[ga, 0], size[ga, 1]
        c2, ax2 = d.geom_xpos[:, gb], _gz(d, gb)
        r2, h2 = size[gb, 0], size[gb, 1]
        # closest points between segments (clamped alternating projection)
        p1 = c1
        for _ in range(4):
            p2 = _seg_closest(p1, c2, ax2, h2)
            p1 = _seg_closest(p2, c1, ax1, h1)
        delta = p2 - p1
        length = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
        n = delta / length[..., None]
        di = length - (r1 + r2)
        slots = m.idx(slot0[cc])
        dist[:, slots] = di
        pos[:, slots] = p1 + n * (r1 + 0.5 * di)[..., None]
        frame[:, slots] = make_frame(n)
        # the second slot of a capsule-capsule pair stays inactive (1e10)

    return d.replace(contact_dist=dist, contact_pos=pos, contact_frame=frame)
