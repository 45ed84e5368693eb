"""Narrowphase collision over the static pair table, batch-first.

Counterpart of ``brax_tracking_tpu/physics/collision.py`` for the pairs of
spheres, capsules and ellipsoids with each other and with a plane:
plane-sphere, plane-capsule (one contact per end sphere), plane-ellipsoid
(the support point), sphere-sphere, sphere-capsule and capsule-capsule
(closest segment points), sphere-ellipsoid (a Newton projection onto the
ellipsoid), capsule-ellipsoid (the deepest segment point by a grid and a
ternary search) and ellipsoid-ellipsoid (a fixed-trip ascent of the
support-function gap), with the JAX package's trip counts and order of
operations. There is no broadphase: every candidate pair owns fixed
contact slots, and a slot's activation is the constraint stage's dist <
margin test. Box, cylinder, mesh and height-field pairs raise (ROADMAP
§A.12).

Conventions match MuJoCo: the normal points from geom1 into geom2, dist is
the signed surface separation, pos is the midpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from brax_tracking_tpu_torch import math as btm
from brax_tracking_tpu_torch.physics import model as M

_PORTED = {
    (M.GEOM_PLANE, M.GEOM_SPHERE), (M.GEOM_PLANE, M.GEOM_CAPSULE),
    (M.GEOM_PLANE, M.GEOM_ELLIPSOID), (M.GEOM_SPHERE, M.GEOM_SPHERE),
    (M.GEOM_SPHERE, M.GEOM_CAPSULE), (M.GEOM_SPHERE, M.GEOM_ELLIPSOID),
    (M.GEOM_CAPSULE, M.GEOM_CAPSULE), (M.GEOM_CAPSULE, M.GEOM_ELLIPSOID),
    (M.GEOM_ELLIPSOID, M.GEOM_ELLIPSOID),
}
# capsule-ellipsoid's search along the segment: grid points, ternary steps
_SEG_GRID, _SEG_TERNARY = 17, 14
# Newton steps of the ellipsoid projection; ellipsoid-ellipsoid ascent steps
_PROJECT_STEPS, _ASCENT_STEPS = 12, 40


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


def _gmat(d: M.Data, g: torch.Tensor) -> torch.Tensor:
    """Full 3x3 world frames of the selected geoms, from their quaternions."""
    return btm.quat_to_mat(d.geom_xquat[:, g])


def _rt(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v over matching leading dims (v may carry more in front)."""
    return torch.einsum("...ij,...i->...j", R, v)


def _r(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v over matching leading dims."""
    return torch.einsum("...ij,...j->...i", R, v)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=M.MINVAL)


def _seg_closest(p, a_c, a_axis, a_half):
    """Closest point to p on the segment centred at a_c along a_axis."""
    tproj = torch.sum((p - a_c) * a_axis, dim=-1)
    tproj = torch.maximum(torch.minimum(tproj, a_half), -a_half)
    return a_c + a_axis * tproj[..., None]


def _seg_argmin(f, shape, dtype, device) -> torch.Tensor:
    """argmin over t in [-1, 1] of ``f`` (t of ``shape`` -> the same shape),
    unimodal along the segment: the least of a 17-point grid, then a
    fixed-trip ternary search between its neighbours (the JAX package's
    _seg_argmin)."""
    ts = torch.linspace(-1.0, 1.0, _SEG_GRID, dtype=dtype, device=device)
    vals = f(ts.reshape((-1,) + (1,) * len(shape)).expand((_SEG_GRID,) + tuple(shape)))
    k = torch.argmin(vals, dim=0)
    lo = ts[torch.clamp(k - 1, min=0)]
    hi = ts[torch.clamp(k + 1, max=_SEG_GRID - 1)]
    for _ in range(_SEG_TERNARY):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        go_lo = f(m1) < f(m2)
        lo, hi = torch.where(go_lo, lo, m1), torch.where(go_lo, m2, hi)
    return 0.5 * (lo + hi)


def _ellipsoid_project(p, s):
    """Closest surface point to p on the ellipsoid diag(s), its own frame,
    and whether p lies inside: Newton on the Lagrange parameter for an
    outside point, radial scaling for an inside one."""
    s2 = s * s
    phi = torch.sum(p * p / torch.clamp(s2, min=M.MINVAL), dim=-1)
    inside = phi < 1.0
    t = torch.zeros_like(phi)
    for _ in range(_PROJECT_STEPS):
        denom = t[..., None] + s2
        f = torch.sum(s2 * p * p / torch.clamp(denom * denom, min=M.MINVAL), -1) - 1.0
        fp = -2.0 * torch.sum(s2 * p * p / torch.clamp(denom * denom * denom, min=M.MINVAL), -1)
        t = t - f / torch.where(torch.abs(fp) > M.MINVAL, fp, -torch.ones_like(fp))
        t = torch.clamp(t, min=0.0)  # outside points have t* >= 0
    x_out = s2 * p / torch.clamp(t[..., None] + s2, min=M.MINVAL)
    x_in = p / torch.sqrt(torch.clamp(phi, min=M.MINVAL))[..., None]
    return torch.where(inside[..., None], x_in, x_out), inside


def _sphere_ellipsoid(cs, r, ce, Re, se):
    """dist, pos and normal (from the sphere into the ellipsoid) of spheres
    (cs, r) against ellipsoids (ce, frame Re, sizes se)."""
    p = _rt(Re, cs - ce)
    x, inside = _ellipsoid_project(p, se)
    delta = p - x
    dn = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
    grad = x / torch.clamp(se * se, min=M.MINVAL)
    gradn = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=M.MINVAL)
    out_l = torch.where(inside[..., None], gradn, delta / dn[..., None])
    di = torch.where(inside, -(dn + r), dn - r)
    outward = _r(Re, out_l)
    po = ce + _r(Re, x) + 0.5 * di[..., None] * outward
    return di, po, -outward


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

    def put(sel, di, po, fr, offset=0):
        slots = m.idx(slot0[sel] + offset)
        dist[:, slots] = di
        pos[:, slots] = po
        frame[:, slots] = fr

    # ---- plane-sphere ----
    ps = np.nonzero((t1 == M.GEOM_PLANE) & (t2 == M.GEOM_SPHERE))[0]
    if ps.size:
        gp, gs = m.idx(g1[ps]), m.idx(g2[ps])
        pn = _gz(d, gp)
        di, po = _plane_sphere_point(pn, d.geom_xpos[:, gp], d.geom_xpos[:, gs], size[gs, 0])
        put(ps, di, po, make_frame(pn))

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
            put(pc, di, po, fr, endi)

    # ---- plane-ellipsoid: the support point along -normal ----
    pe = np.nonzero((t1 == M.GEOM_PLANE) & (t2 == M.GEOM_ELLIPSOID))[0]
    if pe.size:
        gp, ge = m.idx(g1[pe]), m.idx(g2[pe])
        pn = _gz(d, gp)
        pp = d.geom_xpos[:, gp]
        E = _gmat(d, ge)
        s_ = size[ge]
        sn = s_ * _rt(E, pn)
        denom = torch.clamp(torch.linalg.norm(sn, dim=-1, keepdim=True), min=M.MINVAL)
        v = d.geom_xpos[:, ge] + _r(E, -s_ * sn / denom)
        di = torch.sum(pn * (v - pp), dim=-1)
        put(pe, di, v - 0.5 * di[..., None] * pn, make_frame(pn))

    # ---- sphere-sphere ----
    ss = np.nonzero((t1 == M.GEOM_SPHERE) & (t2 == M.GEOM_SPHERE))[0]
    if ss.size:
        ga, gb = m.idx(g1[ss]), m.idx(g2[ss])
        c1, c2 = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
        r1, r2 = size[ga, 0], size[gb, 0]
        delta = c2 - c1
        length = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
        n = delta / length[..., None]
        di = length - (r1 + r2)
        put(ss, di, c1 + n * (r1 + 0.5 * di)[..., None], make_frame(n))

    # ---- sphere-capsule: the closest segment point's sphere ----
    sc = np.nonzero((t1 == M.GEOM_SPHERE) & (t2 == M.GEOM_CAPSULE))[0]
    if sc.size:
        ga, gb = m.idx(g1[sc]), m.idx(g2[sc])
        c1, r1 = d.geom_xpos[:, ga], size[ga, 0]
        r2, h2 = size[gb, 0], size[gb, 1]
        p2 = _seg_closest(c1, d.geom_xpos[:, gb], _gz(d, gb), h2)
        delta = p2 - c1
        length = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
        n = delta / length[..., None]
        di = length - (r1 + r2)
        put(sc, di, c1 + n * (r1 + 0.5 * di)[..., None], make_frame(n))

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
        put(cc, di, p1 + n * (r1 + 0.5 * di)[..., None], make_frame(n))
        # the second slot of a capsule-capsule pair stays inactive (1e10)

    # ---- sphere-ellipsoid: projection onto the ellipsoid ----
    se = np.nonzero((t1 == M.GEOM_SPHERE) & (t2 == M.GEOM_ELLIPSOID))[0]
    if se.size:
        ga, gb = m.idx(g1[se]), m.idx(g2[se])
        di, po, n = _sphere_ellipsoid(d.geom_xpos[:, ga], size[ga, 0], d.geom_xpos[:, gb],
                                      _gmat(d, gb), size[gb])
        put(se, di, po, make_frame(n))

    # ---- capsule-ellipsoid: the deepest (or closest) segment point ----
    ce = np.nonzero((t1 == M.GEOM_CAPSULE) & (t2 == M.GEOM_ELLIPSOID))[0]
    if ce.size:
        ga, gb = m.idx(g1[ce]), m.idx(g2[ce])
        cc_, axc = d.geom_xpos[:, ga], _gz(d, ga)
        r, hc = size[ga, 0], size[ga, 1]
        ce2, Re, se2 = d.geom_xpos[:, gb], _gmat(d, gb), size[gb]

        def sdist_at(t):
            """Signed point-to-surface distance at segment parameter t: convex,
            so unimodal along the axis, overlapping or not."""
            pl = _rt(Re, cc_ + (t * hc)[..., None] * axc - ce2)
            x, inside = _ellipsoid_project(pl, se2)
            dn = torch.linalg.norm(pl - x, dim=-1)
            return torch.where(inside, -dn, dn)

        t_best = _seg_argmin(sdist_at, cc_.shape[:-1], dtype, device)
        p = cc_ + (t_best * hc)[..., None] * axc
        di, po, n = _sphere_ellipsoid(p, r, ce2, Re, se2)
        put(ce, di, po, make_frame(n))

    # ---- ellipsoid-ellipsoid: ascent of the support-function gap ----
    ee = np.nonzero((t1 == M.GEOM_ELLIPSOID) & (t2 == M.GEOM_ELLIPSOID))[0]
    if ee.size:
        # over unit directions u the gap g(u) = u.(c2 - c1) - sqrt(u^T A1 u)
        # - sqrt(u^T A2 u), A_i = R_i diag(s_i^2) R_i^T, is concave and its
        # maximum is the signed separation at the contact normal:
        # normalized-gradient steps along the sphere, decaying by 0.9
        ga, gb = m.idx(g1[ee]), m.idx(g2[ee])
        c1, c2 = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
        R1, R2 = _gmat(d, ga), _gmat(d, gb)
        s1, s2 = size[ga], size[gb]
        dc = c2 - c1

        def au(R, s_, u):
            return _r(R, s_ * s_ * _rt(R, u))

        def gap_terms(u):
            a1u, a2u = au(R1, s1, u), au(R2, s2, u)
            q1 = torch.sqrt(torch.clamp(torch.sum(u * a1u, -1), min=M.MINVAL))
            q2 = torch.sqrt(torch.clamp(torch.sum(u * a2u, -1), min=M.MINVAL))
            return a1u, a2u, q1, q2

        u, step = _norm(dc), 0.5
        for _ in range(_ASCENT_STEPS):
            a1u, a2u, q1, q2 = gap_terms(u)
            grad = dc - a1u / q1[..., None] - a2u / q2[..., None]
            grad = grad - u * torch.sum(u * grad, -1, keepdim=True)
            u, step = _norm(u + step * _norm(grad)), step * 0.9
        a1u, a2u, q1, q2 = gap_terms(u)
        di = torch.sum(u * dc, -1) - q1 - q2
        x1 = c1 + a1u / q1[..., None]  # support of E1 along +u
        x2 = c2 - a2u / q2[..., None]  # support of E2 along -u
        put(ee, di, 0.5 * (x1 + x2), make_frame(u))

    return d.replace(contact_dist=dist, contact_pos=pos, contact_frame=frame)
