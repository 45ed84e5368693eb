"""Narrowphase collision over the static pair table, batch-first.

Counterpart of ``brax_tracking_tpu/physics/collision.py``: all 29 pair
types of ``spec._PAIR_POINTS``, in the JAX file's order and with its trip
counts, thresholds and slot order:

- a plane against a sphere, a capsule (one contact per end sphere), an
  ellipsoid (its support point), a box or a convex mesh (the four deepest
  corners or hull vertices, a stable sort) and a cylinder (four rim
  points);
- a height field against a sphere or a capsule (three probes along its
  axis): the deepest of the 2 (K - 1)^2 triangles of the K x K elevation
  patch under each probe;
- spheres, capsules and ellipsoids with each other (closest segment
  points, a Newton projection onto the ellipsoid, a grid and ternary
  search along a capsule, an ascent of the support-function gap);
- a sphere or a capsule against a box (a point-box projection, two
  capsule-end candidates) or a cylinder (a point-cylinder projection, the
  deepest segment point and both ends);
- ten convex pairs with an ellipsoid, cylinder, box or mesh through one
  60-step ascent of the support-function gap;
- box-box: the separating axis test, an 8-point face manifold or one edge
  contact.

There is no broadphase: every candidate pair owns fixed contact slots, and
a slot's activation is the constraint stage's dist < margin test. Each
pair type is one batched group over its pairs and the envs.

Conventions match MuJoCo: the normal points from geom1 into geom2, dist is
the signed surface separation, pos is the midpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import math as btm
from portbench.ref.physics import model as M
from portbench.ref.physics import spec

# the deepest segment point's search (capsule-ellipsoid, capsule-cylinder):
# grid points, ternary steps
_SEG_GRID, _SEG_TERNARY = 17, 14
# Newton steps of the ellipsoid projection; ellipsoid-ellipsoid ascent steps
_PROJECT_STEPS, _ASCENT_STEPS = 12, 40
# the convex pairs' ascent: steps and the step's decay
_CONVEX_STEPS, _CONVEX_DECAY = 60, 0.93
# the box-box face manifold's alternating clamps per incident corner, and
# capsule-box's alternating projections per capsule end
_BOX_CLAMPS, _CAPSULE_BOX_STEPS = 6, 6
# a box's corners in plane-box's order
_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
_SIN60 = 0.8660254037844386
# the convex pairs in the JAX package's order
_CONVEX_PAIRS = (
    (M.GEOM_ELLIPSOID, M.GEOM_CYLINDER), (M.GEOM_ELLIPSOID, M.GEOM_BOX),
    (M.GEOM_CYLINDER, M.GEOM_CYLINDER), (M.GEOM_CYLINDER, M.GEOM_BOX),
    (M.GEOM_SPHERE, M.GEOM_MESH), (M.GEOM_CAPSULE, M.GEOM_MESH),
    (M.GEOM_ELLIPSOID, M.GEOM_MESH), (M.GEOM_CYLINDER, M.GEOM_MESH),
    (M.GEOM_BOX, M.GEOM_MESH), (M.GEOM_MESH, M.GEOM_MESH),
)


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


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def _guard(x, eps=M.MINVAL):
    """x where |x| > eps, else 1: a guarded divisor."""
    return torch.where(torch.abs(x) > eps, x, torch.ones_like(x))


def _sgn(x: torch.Tensor) -> torch.Tensor:
    """sign() that never returns 0 (degenerate centred poses)."""
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def _one_hot(i: torch.Tensor, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(i, 3).to(dtype)


def _clip(x, lo, hi):
    """jnp.clip: the maximum with lo, then the minimum with hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _point_tri_closest(p, a, b, c):
    """Closest point on triangles (a, b, c) to points p, all (..., 3):
    Ericson's Real-Time Collision Detection 5.1.5 as a cascade of selects,
    every region's candidate computed with a guarded divide."""
    eps = M.MINVAL
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    v_ab = d1 / _guard(d1 - d3, eps)
    q_ab = a + v_ab[..., None] * ab
    w_ac = d2 / _guard(d2 - d6, eps)
    q_ac = a + w_ac[..., None] * ac
    den_bc = (d4 - d3) + (d5 - d6)
    w_bc = (d4 - d3) / _guard(den_bc, eps)
    q_bc = b + w_bc[..., None] * (c - b)
    den_f = va + vb + vc
    inv_f = 1.0 / _guard(den_f, eps)
    q_face = a + (vb * inv_f)[..., None] * ab + (vc * inv_f)[..., None] * ac
    # region selection, the highest priority last (vertex > edge > face)
    q = q_face
    q = torch.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None], q_bc, q)
    q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], q_ac, q)
    q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], q_ab, q)
    q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, q)
    q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, q)
    q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, q)
    return q


def _box_box(c1, R1, s1, c2, R2, s2):
    """Box-box over any leading dims: the separating axis test (6 face and 9
    edge-cross axes), then an 8-point face manifold or one edge contact.

    Face case: the incident face's 4 corners clamped into the reference
    face (alternating between the reference rectangle and the incident
    face), plus the reference rectangle's 4 corners where they project
    inside the incident face, duplicates switched off; each candidate's
    depth is the incident face plane's gap at its face coordinates. Edge
    case (a cross axis wins by more than 1e-6): one contact at the closest
    points of the two witness edges, the other seven off.

    Returns dist (..., 8), pos (..., 8, 3) and the normal (..., 8, 3), from
    geom1 into geom2.
    """
    dtype = c1.dtype
    Rt = torch.einsum("...ki,...kj->...ij", R1, R2)  # box2's axes in box1's frame
    p = torch.einsum("...ki,...k->...i", R1, c2 - c1)  # box2's centre in box1's frame
    AbsR = torch.abs(Rt) + 1e-9  # parallel edges: the usual epsilon
    sep_a = torch.abs(p) - (s1 + torch.einsum("...ij,...j->...i", AbsR, s2))
    pB = torch.einsum("...ij,...i->...j", Rt, p)  # p in box2's axes
    sep_b = torch.abs(pB) - (s2 + torch.einsum("...ij,...i->...j", AbsR, s1))
    seps_c = []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            rA = s1[..., i1] * AbsR[..., i2, j] + s1[..., i2] * AbsR[..., i1, j]
            rB = s2[..., j1] * AbsR[..., i, j2] + s2[..., j2] * AbsR[..., i, j1]
            dd = torch.abs(p[..., i2] * Rt[..., i1, j] - p[..., i1] * Rt[..., i2, j])
            ln2 = Rt[..., i1, j] ** 2 + Rt[..., i2, j] ** 2  # |e_i x b_j|^2
            sep = (dd - (rA + rB)) / torch.sqrt(torch.clamp(ln2, min=1e-12))
            # near-parallel edges: a degenerate axis, never the winner
            seps_c.append(torch.where(ln2 < 1e-8, torch.full_like(sep, -float("inf")), sep))
    sep_c = torch.stack(seps_c, dim=-1)  # (..., 9)
    sep_f = torch.cat([sep_a, sep_b], dim=-1)  # (..., 6)
    fmax = torch.amax(sep_f, dim=-1)
    cmax = torch.amax(sep_c, dim=-1)
    # a bias toward face manifolds (no jitter between near-equal axes)
    is_edge = cmax > fmax + 1e-6

    # ---------------- face manifold (A = the winning face's box) ----------------
    face_idx = torch.argmax(sep_f, dim=-1)
    is_b = face_idx >= 3
    fi = face_idx % 3
    wb = is_b[..., None, None]
    Mab = torch.where(wb, Rt.transpose(-1, -2), Rt)  # B's axes in A's frame
    cB = torch.where(is_b[..., None], -pB, p)  # B's centre in A's frame
    sA = torch.where(is_b[..., None], s2, s1)
    sB = torch.where(is_b[..., None], s1, s2)
    h_f = _one_hot(fi, dtype)
    h_u = _one_hot((fi + 1) % 3, dtype)
    h_v = _one_hot((fi + 2) % 3, dtype)
    sigma = _sgn(_dot(h_f, cB))  # the face of A toward B
    sAf, sAu, sAv = _dot(h_f, sA), _dot(h_u, sA), _dot(h_v, sA)

    # the incident face on B: the axis most anti-parallel to the normal
    mf = torch.einsum("...f,...fj->...j", h_f, Mab)  # row f of Mab
    jn = torch.argmax(torch.abs(mf), dim=-1)
    h_j = _one_hot(jn, dtype)
    w = _sgn(_dot(h_j, mf) * sigma)
    bj = torch.einsum("...fj,...j->...f", Mab, h_j)
    fc = cB - (w * _dot(h_j, sB))[..., None] * bj  # the incident face's centre
    h_a = _one_hot((jn + 1) % 3, dtype)
    h_b = _one_hot((jn + 2) % 3, dtype)
    ea = torch.einsum("...fj,...j->...f", Mab, h_a) * _dot(h_a, sB)[..., None]
    eb = torch.einsum("...fj,...j->...f", Mab, h_b) * _dot(h_b, sB)[..., None]
    # the incident face as the affine map x(a, b) = fc + a ea + b eb in face
    # coordinates
    fc_u, fc_v = _dot(h_u, fc), _dot(h_v, fc)
    ea_u, ea_v = _dot(h_u, ea), _dot(h_v, ea)
    eb_u, eb_v = _dot(h_u, eb), _dot(h_v, eb)
    fc_h = sigma * _dot(h_f, fc) - sAf  # the normal gap at the face's centre
    ea_h, eb_h = sigma * _dot(h_f, ea), sigma * _dot(h_f, eb)
    det = ea_u * eb_v - eb_u * ea_v
    det_ok = torch.abs(det) > 1e-9
    det_s = torch.where(det_ok, det, torch.ones_like(det))

    def uv_to_ab(u, v):
        du, dv = u - fc_u, v - fc_v
        return (eb_v * du - eb_u * dv) / det_s, (-ea_v * du + ea_u * dv) / det_s

    corners = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))
    f_u, f_v, f_h = [], [], []
    big = torch.full_like(fc_h, 1e10)
    for a, b in corners:
        # the incident corner clamped alternately into the reference
        # rectangle (u, v) and the incident face ((a, b)): both convex, so
        # it converges into their intersection, the contact patch
        uu = fc_u + a * ea_u + b * eb_u
        vv = fc_v + a * ea_v + b * eb_v
        a2 = torch.full_like(uu, a)
        b2 = torch.full_like(vv, b)
        for _ in range(_BOX_CLAMPS):
            uu = _clip(uu, -sAu, sAu)
            vv = _clip(vv, -sAv, sAv)
            na, nb = uv_to_ab(uu, vv)
            a2 = torch.where(det_ok, torch.clamp(na, -1.0, 1.0), a2)
            b2 = torch.where(det_ok, torch.clamp(nb, -1.0, 1.0), b2)
            uu = torch.where(det_ok, fc_u + a2 * ea_u + b2 * eb_u, uu)
            vv = torch.where(det_ok, fc_v + a2 * ea_v + b2 * eb_v, vv)
        # an empty intersection (the corner sticks out past the rectangle)
        ok = ((torch.abs(uu) <= sAu + 1e-7) & (torch.abs(vv) <= sAv + 1e-7)) | ~det_ok
        uu = _clip(uu, -sAu, sAu)
        vv = _clip(vv, -sAv, sAv)
        f_u.append(uu)
        f_v.append(vv)
        f_h.append(torch.where(ok, fc_h + a2 * ea_h + b2 * eb_h, big))
    for a, b in corners:
        uu = a * sAu
        vv = b * sAv
        a2, b2 = uv_to_ab(uu, vv)
        inside = det_ok & (torch.abs(a2) <= 1.0 + 1e-6) & (torch.abs(b2) <= 1.0 + 1e-6)
        for k in range(4):  # duplicates of the clamped incident corners
            inside = inside & (torch.abs(uu - f_u[k]) + torch.abs(vv - f_v[k]) > 1e-9)
        f_u.append(uu)
        f_v.append(vv)
        f_h.append(torch.where(inside, fc_h + a2 * ea_h + b2 * eb_h, big))

    R_A = torch.where(wb, R2, R1)
    c_A = torch.where(is_b[..., None], c2, c1)
    n_loc = sigma[..., None] * h_f
    # the normal from geom1 into geom2, in the world
    fn = _r(R_A, n_loc) * torch.where(is_b, -torch.ones_like(sigma), torch.ones_like(sigma))[..., None]

    # ---------------- edge-edge contact ----------------
    eidx = torch.argmax(sep_c, dim=-1)
    h_i = _one_hot(eidx // 3, dtype)
    h_j2 = _one_hot(eidx % 3, dtype)
    d1 = h_i  # e_i in box1's frame
    d2 = _r(Rt, h_j2)  # b_j in box1's frame
    axis = _norm(torch.linalg.cross(d1, d2, dim=-1))
    u_dir = axis * _sgn(_dot(axis, p))[..., None]  # box1 -> box2
    o1 = (1.0 - h_i) * s1 * _sgn(u_dir)
    ub = torch.einsum("...ij,...i->...j", Rt, u_dir)  # u in box2's axes
    o2 = p + _r(Rt, (1.0 - h_j2) * s2 * (-_sgn(ub)))
    w0 = o1 - o2
    b_ = _dot(d1, d2)
    d_ = _dot(d1, w0)
    e_ = _dot(d2, w0)
    denom = torch.clamp(1.0 - b_ * b_, min=1e-12)
    li, lj = _dot(h_i, s1), _dot(h_j2, s2)
    t1 = _clip((b_ * e_ - d_) / denom, -li, li)
    t2 = _clip((e_ - b_ * d_) / denom, -lj, lj)
    p1 = o1 + t1[..., None] * d1
    p2 = o2 + t2[..., None] * d2
    edist = _dot(p2 - p1, u_dir)
    epos = c1 + _r(R1, 0.5 * (p1 + p2))
    en = _r(R1, u_dir)

    # ---------------- merge ----------------
    dists, poss, nrms = [], [], []
    for k in range(8):
        x_loc = (h_u * f_u[k][..., None] + h_v * f_v[k][..., None]
                 + h_f * (sigma * (sAf + 0.5 * torch.clamp(f_h[k], max=1e9)))[..., None])
        fpos = c_A + _r(R_A, x_loc)
        if k == 0:
            dists.append(torch.where(is_edge, edist, f_h[k]))
            poss.append(torch.where(is_edge[..., None], epos, fpos))
            nrms.append(torch.where(is_edge[..., None], en, fn))
        else:
            dists.append(torch.where(is_edge, big, f_h[k]))
            poss.append(fpos)
            nrms.append(fn)
    return torch.stack(dists, -1), torch.stack(poss, -2), torch.stack(nrms, -2)


def _point_box(local, s):
    """The outward unit direction, the signed distance of the point to the
    surface (positive outside) and the surface point, for points against
    boxes of half-sizes s, in the box frame. A point inside leaves through
    the nearest face."""
    clamped = _clip(local, -s, s)
    delta = local - clamped
    dn = torch.linalg.norm(delta, dim=-1)
    outside = dn > 1e-12
    out_dir = delta / torch.clamp(dn, min=M.MINVAL)[..., None]
    gaps = s - torch.abs(local)
    kmin = torch.argmin(gaps, dim=-1)
    in_dir = _one_hot(kmin, local.dtype) * torch.sign(
        torch.where(torch.abs(local) > 1e-12, local, torch.ones_like(local)))
    in_gap = torch.gather(gaps, -1, kmin[..., None])[..., 0]
    q_in = local + in_dir * in_gap[..., None]
    outward = torch.where(outside[..., None], out_dir, in_dir)
    cdist = torch.where(outside, dn, -in_gap)
    q = torch.where(outside[..., None], clamped, q_in)
    return outward, cdist, q


def _point_cylinder(pl, r, h):
    """The signed distance, closest surface point and outward normal of
    points against cylinders (radius r, half-height h), in the cylinder
    frame: the rim where both gaps are positive, else the side or a cap,
    and inside the nearer of the two (the larger signed gap)."""
    x, y, z = pl.unbind(-1)
    rho = torch.sqrt(torch.clamp(x * x + y * y, min=M.MINVAL * M.MINVAL))
    zero = torch.zeros_like(rho)
    er = torch.stack([x / rho, y / rho, zero], -1)
    zhat = torch.stack([zero, zero, torch.ones_like(rho)], -1)
    dr = rho - r
    dz = torch.abs(z) - h
    sz = _sgn(z)
    corner = (dr > 0) & (dz > 0)
    d_c = torch.sqrt(torch.clamp(dr * dr + dz * dz, min=M.MINVAL * M.MINVAL))
    q_c = er * r[..., None] + zhat * (sz * h)[..., None]
    n_c = (er * dr[..., None] + zhat * (sz * dz)[..., None]) / d_c[..., None]
    side = dr > dz
    q_s = er * r[..., None] + zhat * z[..., None]
    q_cap = pl * pl.new_tensor([1.0, 1.0, 0.0]) + zhat * (sz * h)[..., None]
    d_sc = torch.where(side, dr, dz)
    q_sc = torch.where(side[..., None], q_s, q_cap)
    n_sc = torch.where(side[..., None], er, zhat * sz[..., None])
    return (torch.where(corner, d_c, d_sc), torch.where(corner[..., None], q_c, q_sc),
            torch.where(corner[..., None], n_c, n_sc))


def _sphere_cylinder(cs, rs, cc2, Rc, rcy, hcy):
    """dist, pos and normal (from the sphere into the cylinder)."""
    d0, q, nl = _point_cylinder(_rt(Rc, cs - cc2), rcy, hcy)
    di = d0 - rs
    outward = _r(Rc, nl)  # cylinder -> sphere
    return di, cc2 + _r(Rc, q) + 0.5 * di[..., None] * outward, -outward


def _support(gtype, Rw, size, u, verts=None):
    """(h(u), witness(u)) of centred geoms of one type along world
    directions u: the support function and its maximiser."""
    ul = _rt(Rw, u)
    if gtype == M.GEOM_BOX:
        w_l = size * _sgn(ul)
        h = torch.sum(size * torch.abs(ul), -1)
    elif gtype == M.GEOM_CYLINDER:
        perp = ul * ul.new_tensor([1.0, 1.0, 0.0])
        pn = torch.clamp(torch.linalg.norm(perp, dim=-1, keepdim=True), min=M.MINVAL)
        w_l = size[..., 0:1] * perp / pn + torch.cat(
            [torch.zeros_like(perp[..., :2]), (size[..., 1] * _sgn(ul[..., 2]))[..., None]], -1)
        h = torch.sum(w_l * ul, -1)
    elif gtype == M.GEOM_ELLIPSOID:
        su = size * ul
        h = torch.clamp(torch.linalg.norm(su, dim=-1), min=M.MINVAL)
        w_l = size * su / h[..., None]
    elif gtype == M.GEOM_SPHERE:
        h = size[..., 0].expand(ul.shape[:-1])
        w_l = size[..., 0:1] * ul
    elif gtype == M.GEOM_CAPSULE:
        h = size[..., 0] + size[..., 1] * torch.abs(ul[..., 2])
        w_l = size[..., 0:1] * ul + torch.cat(
            [torch.zeros_like(ul[..., :2]), (size[..., 1] * _sgn(ul[..., 2]))[..., None]], -1)
    elif gtype == M.GEOM_MESH:
        # the hull's support: the maximum over its vertices (the padding
        # repeats vertex 0, which never changes a maximum)
        dots = torch.einsum("...kj,...j->...k", verts, ul)
        h = torch.amax(dots, dim=-1)
        k = torch.argmax(dots, dim=-1)
        vk = verts.expand(*k.shape, *verts.shape[-2:])  # per env or shared
        w_l = torch.gather(vk, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    else:  # pragma: no cover
        raise NotImplementedError(gtype)
    return h, _r(Rw, w_l)



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
    for key in set(zip(t1.tolist(), t2.tolist())) - set(spec._PAIR_POINTS):
        M.unported(f"collision pair of geom types {key} (the JAX package has none)", "§A.12")

    dist = torch.full((B, ncon), 1e10, dtype=dtype, device=device)
    pos = d.qpos.new_zeros(B, ncon, 3)
    frame = torch.eye(3, dtype=dtype, device=device).repeat(B, ncon, 1, 1)
    slot0 = np.concatenate([[0], np.cumsum(pairs.npoint)[:-1]]).astype(np.int64)
    size = m.geom_size

    def sel(ta, tb):
        return np.nonzero((t1 == ta) & (t2 == tb))[0]

    def put(sel_, di, po, fr, offset=0):
        slots = m.idx(slot0[sel_] + offset)
        dist[:, slots] = di
        pos[:, slots] = po
        frame[:, slots] = fr

    # ---- plane-sphere ----
    ps = sel(M.GEOM_PLANE, M.GEOM_SPHERE)
    if ps.size:
        gp, gs = m.idx(g1[ps]), m.idx(g2[ps])
        pn = _gz(d, gp)
        di, po = _plane_sphere_point(pn, d.geom_xpos[:, gp], d.geom_xpos[:, gs], size[..., gs, 0])
        put(ps, di, po, make_frame(pn))

    # ---- plane-capsule: one contact per end sphere ----
    pc = sel(M.GEOM_PLANE, M.GEOM_CAPSULE)
    if pc.size:
        gp, gc = m.idx(g1[pc]), m.idx(g2[pc])
        pn = _gz(d, gp)
        pp = d.geom_xpos[:, gp]
        c = d.geom_xpos[:, gc]
        axis = _gz(d, gc)
        r = size[..., gc, 0]
        half = size[..., gc, 1]
        # MuJoCo aligns tangent1 with the capsule axis projected onto the
        # plane (helper frame when the axis is perpendicular to it)
        proj = axis - pn * torch.sum(pn * axis, dim=-1, keepdim=True)
        pnorm = torch.linalg.norm(proj, dim=-1, keepdim=True)
        tan1 = proj / torch.clamp(pnorm, min=M.MINVAL)
        tan2 = torch.linalg.cross(pn, tan1, dim=-1)
        fr_axis = torch.stack([pn, tan1, tan2], dim=-2)
        fr = torch.where((pnorm > 1e-10)[..., None], fr_axis, make_frame(pn))
        for endi, sign in enumerate((1.0, -1.0)):
            end = c + sign * axis * half[..., None]
            di, po = _plane_sphere_point(pn, pp, end, r)
            put(pc, di, po, fr, endi)

    # ---- plane-ellipsoid: the support point along -normal ----
    pe = sel(M.GEOM_PLANE, M.GEOM_ELLIPSOID)
    if pe.size:
        gp, ge = m.idx(g1[pe]), m.idx(g2[pe])
        pn = _gz(d, gp)
        pp = d.geom_xpos[:, gp]
        E = _gmat(d, ge)
        s_ = size[..., ge, :]
        sn = s_ * _rt(E, pn)
        denom = torch.clamp(torch.linalg.norm(sn, dim=-1, keepdim=True), min=M.MINVAL)
        v = d.geom_xpos[:, ge] + _r(E, -s_ * sn / denom)
        di = torch.sum(pn * (v - pp), dim=-1)
        put(pe, di, v - 0.5 * di[..., None] * pn, make_frame(pn))

    # ---- plane-box and plane-mesh: the four deepest corners or hull
    # vertices (a stable sort: a face resting flat gives four exact ties) ----
    def four_deepest(sel_, pts, valid=None):
        gp = m.idx(g1[sel_])
        pn = _gz(d, gp)
        di_all = torch.sum(pn[..., None, :] * (pts - d.geom_xpos[:, gp][..., None, :]), dim=-1)
        if valid is not None:
            # the padding repeats vertex 0: push it past every real vertex
            di_all = torch.where(m.const(valid, torch.bool), di_all, torch.full_like(di_all, 1e10))
        idx = torch.sort(di_all, dim=-1, stable=True)[1][..., :4]
        di = torch.gather(di_all, -1, idx)
        po = torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 3))
        po = po - 0.5 * di[..., None] * pn[..., None, :]
        fr = make_frame(pn)
        for k in range(4):
            put(sel_, di[..., k], po[..., k, :], fr, k)

    pb = sel(M.GEOM_PLANE, M.GEOM_BOX)
    if pb.size:
        gb = m.idx(g2[pb])
        corners = m.const(_BOX_CORNERS)[None] * size[..., gb, :][..., None, :]  # (n, 8, 3)
        pts = d.geom_xpos[:, gb][..., None, :] + torch.einsum("...ij,...kj->...ki",
                                                               _gmat(d, gb), corners)
        four_deepest(pb, pts)

    pm = sel(M.GEOM_PLANE, M.GEOM_MESH)
    if pm.size:
        gm = m.idx(g2[pm])
        mi = np.asarray(m.geom_meshidx)[g2[pm]]
        verts = m.mesh_vert[..., m.idx(mi), :, :]  # (n, maxv, 3) in the geom frame
        pts = d.geom_xpos[:, gm][..., None, :] + torch.einsum("...ij,...kj->...ki",
                                                               _gmat(d, gm), verts)
        valid = np.arange(verts.shape[-2])[None, :] < np.asarray(m.mesh_vertnum)[mi][:, None]
        four_deepest(pm, pts, valid)

    # ---- height fields: the deepest triangle of a K x K patch per probe ----
    def hfield_probe(sel_, centers_w, radius):
        """One sphere probe per pair row against its height field: the K x
        K elevation patch under the probe (a gather, its corner clipped
        per probe into the grid), all 2 (K - 1)^2 surface triangles (the
        prism triangulation of mjc_ConvexHField) with an exact closest
        point, and the deepest one's (dist, world pos, world frame)."""
        K = m.hfield_patch
        gh = np.asarray(m.geom_hfieldidx)[g1[sel_]]
        nr = np.asarray(m.hfield_nrowcol)[gh, 0]
        nc = np.asarray(m.hfield_nrowcol)[gh, 1]
        gp = m.idx(g1[sel_])
        Rh = _gmat(d, gp)
        ph = d.geom_xpos[:, gp]
        c = _rt(Rh, centers_w - ph)  # in the height field's frame
        sz = m.hfield_size[..., m.idx(gh), :]  # (n, 4), per env (B, n, 4)
        dx = 2.0 * sz[..., 0] / m.const(np.maximum(nc - 1, 1))
        dy = 2.0 * sz[..., 1] / m.const(np.maximum(nr - 1, 1))
        zero = torch.zeros((), dtype=torch.long, device=device)
        j0 = _clip(torch.floor((c[..., 0] + sz[..., 0]) / dx).long() - (K - 1) // 2, zero,
                   m.idx(nc - K))
        i0 = _clip(torch.floor((c[..., 1] + sz[..., 1]) / dy).long() - (K - 1) // 2, zero,
                   m.idx(nr - K))
        ar = torch.arange(K, device=device)
        rows = (i0[..., None] + ar)[..., :, None]  # (B, n, K, 1)
        cols = (j0[..., None] + ar)[..., None, :]  # (B, n, 1, K)
        if "hfield_elev" in m.env_leaves:
            env = torch.arange(B, device=device)[:, None, None, None]
            patch = m.hfield_elev[env, m.idx(gh)[:, None, None], rows, cols]
        else:
            patch = m.hfield_elev[m.idx(gh)[:, None, None], rows, cols]  # (B, n, K, K): z at [y, x]
        ar = ar.to(dtype)
        xs = (j0[..., None].to(dtype) + ar) * dx[..., None] - sz[..., 0:1]
        ys = (i0[..., None].to(dtype) + ar) * dy[..., None] - sz[..., 1:2]
        V = torch.stack([xs[..., None, :].expand(patch.shape), ys[..., :, None].expand(patch.shape),
                         patch], dim=-1)  # (B, n, K, K, 3)

        def flat(W):
            return W.reshape(*W.shape[:-3], -1, 3)

        A = torch.cat([flat(V[..., :-1, :-1, :]), flat(V[..., :-1, :-1, :])], -2)
        Bv = torch.cat([flat(V[..., :-1, 1:, :]), flat(V[..., 1:, 1:, :])], -2)
        C = torch.cat([flat(V[..., 1:, 1:, :]), flat(V[..., 1:, :-1, :])], -2)
        q = _point_tri_closest(c[..., None, :], A, Bv, C)  # (B, n, T, 3)
        dvec = c[..., None, :] - q
        k = torch.argmin(torch.sum(dvec * dvec, dim=-1), dim=-1)

        def take(W):
            return torch.gather(W, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]

        qs, As, Bs, Cs = take(q), take(A), take(Bv), take(C)
        ntri = _norm(torch.linalg.cross(Bs - As, Cs - As, dim=-1))  # z up by the winding
        dv = c - qs
        L = torch.linalg.norm(dv, dim=-1)
        above = torch.sum(dv * ntri, dim=-1) >= 0
        di = torch.where(above, torch.ones_like(L), -torch.ones_like(L)) * L - radius
        n_l = torch.where((above & (L > M.MINVAL))[..., None],
                          dv / torch.clamp(L, min=M.MINVAL)[..., None], ntri)
        pos_l = 0.5 * (qs + c - n_l * radius[..., None])
        return di, ph + _r(Rh, pos_l), make_frame(_r(Rh, n_l))

    hs = sel(M.GEOM_HFIELD, M.GEOM_SPHERE)
    if hs.size:
        gs = m.idx(g2[hs])
        put(hs, *hfield_probe(hs, d.geom_xpos[:, gs], size[..., gs, 0]))

    hc = sel(M.GEOM_HFIELD, M.GEOM_CAPSULE)
    if hc.size:
        gc = m.idx(g2[hc])
        cw = d.geom_xpos[:, gc]
        axis = _gz(d, gc)
        r, half = size[..., gc, 0], size[..., gc, 1]
        for k, t in enumerate((-1.0, 0.0, 1.0)):
            put(hc, *hfield_probe(hc, cw + t * axis * half[..., None], r), k)

    # ---- sphere-sphere ----
    ss = sel(M.GEOM_SPHERE, M.GEOM_SPHERE)
    if ss.size:
        ga, gb = m.idx(g1[ss]), m.idx(g2[ss])
        c1, c2 = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
        r1, r2 = size[..., ga, 0], size[..., gb, 0]
        delta = c2 - c1
        length = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
        n = delta / length[..., None]
        di = length - (r1 + r2)
        put(ss, di, c1 + n * (r1 + 0.5 * di)[..., None], make_frame(n))

    # ---- sphere-capsule: the closest segment point's sphere ----
    sc = sel(M.GEOM_SPHERE, M.GEOM_CAPSULE)
    if sc.size:
        ga, gb = m.idx(g1[sc]), m.idx(g2[sc])
        c1, r1 = d.geom_xpos[:, ga], size[..., ga, 0]
        r2, h2 = size[..., gb, 0], size[..., gb, 1]
        p2 = _seg_closest(c1, d.geom_xpos[:, gb], _gz(d, gb), h2)
        delta = p2 - c1
        length = torch.clamp(torch.linalg.norm(delta, dim=-1), min=M.MINVAL)
        n = delta / length[..., None]
        di = length - (r1 + r2)
        put(sc, di, c1 + n * (r1 + 0.5 * di)[..., None], make_frame(n))

    # ---- capsule-capsule: closest-segment-point spheres ----
    cc = sel(M.GEOM_CAPSULE, M.GEOM_CAPSULE)
    if cc.size:
        ga, gb = m.idx(g1[cc]), m.idx(g2[cc])
        c1, ax1 = d.geom_xpos[:, ga], _gz(d, ga)
        r1, h1 = size[..., ga, 0], size[..., ga, 1]
        c2, ax2 = d.geom_xpos[:, gb], _gz(d, gb)
        r2, h2 = size[..., gb, 0], size[..., gb, 1]
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

    # ---- plane-cylinder: four rim points ----
    # the deepest rim point of the near disk, the same rim direction on the
    # far disk (a cylinder lying on its side) and the near disk's rim at
    # +-120 degrees (standing on a face): mjc_PlaneCylinder's 1, 2 or 3
    # contacts come out of dist < margin on these four
    pcy = sel(M.GEOM_PLANE, M.GEOM_CYLINDER)
    if pcy.size:
        gp, gc = m.idx(g1[pcy]), m.idx(g2[pcy])
        pn = _gz(d, gp)
        pp = d.geom_xpos[:, gp]
        c = d.geom_xpos[:, gc]
        axis = _gz(d, gc)
        r, h = size[..., gc, 0], size[..., gc, 1]
        ca = torch.sum(pn * axis, dim=-1)  # cos(axis, normal)
        sgn = torch.where(ca >= 0, torch.ones_like(ca), -torch.ones_like(ca))
        # the in-disk direction toward the plane
        d1 = ca[..., None] * axis - pn
        d1n = torch.linalg.norm(d1, dim=-1, keepdim=True)
        # the axis along the normal: any perpendicular (the geom's x axis)
        gx = _gmat(d, gc)[..., :, 0]
        d1 = torch.where(d1n > 1e-10, d1 / torch.clamp(d1n, min=M.MINVAL), gx)
        d2 = torch.linalg.cross(axis, d1, dim=-1)  # completes the disk's basis
        lo = c - axis * (h * sgn)[..., None]  # the near (deepest) disk's centre
        hi = c + axis * (h * sgn)[..., None]
        rr = r[..., None]
        cand = [lo + rr * d1, hi + rr * d1, lo + rr * (-0.5 * d1 + _SIN60 * d2),
                lo + rr * (-0.5 * d1 - _SIN60 * d2)]
        fr = make_frame(pn)
        for k, p in enumerate(cand):
            di = torch.sum(pn * (p - pp), dim=-1)
            put(pcy, di, p - 0.5 * di[..., None] * pn, fr, k)

    # ---- sphere-box ----
    sb = sel(M.GEOM_SPHERE, M.GEOM_BOX)
    if sb.size:
        ga, gb = m.idx(g1[sb]), m.idx(g2[sb])
        cb, Rb = d.geom_xpos[:, gb], _gmat(d, gb)
        outward_l, cdist, q_l = _point_box(_rt(Rb, d.geom_xpos[:, ga] - cb), size[..., gb, :])
        di = cdist - size[..., ga, 0]
        outward = _r(Rb, outward_l)
        put(sb, di, cb + _r(Rb, q_l) + 0.5 * di[..., None] * outward, make_frame(-outward))

    # ---- capsule-box: one candidate per capsule end (alternating
    # projection between the segment and the box); a second candidate at the
    # same closest point (a tip contact) or on the far side is switched off ----
    cbx = sel(M.GEOM_CAPSULE, M.GEOM_BOX)
    if cbx.size:
        ga, gb = m.idx(g1[cbx]), m.idx(g2[cbx])
        cc_, axc = d.geom_xpos[:, ga], _gz(d, ga)
        r, hc_ = size[..., ga, 0], size[..., ga, 1]
        cb2, Rb, s = d.geom_xpos[:, gb], _gmat(d, gb), size[..., gb, :]
        prev_p = prev_out = None
        for endi, esign in enumerate((1.0, -1.0)):
            p = cc_ + esign * axc * hc_[..., None]
            for _ in range(_CAPSULE_BOX_STEPS):
                qw = cb2 + _r(Rb, _clip(_rt(Rb, p - cb2), -s, s))
                p = _seg_closest(qw, cc_, axc, hc_)
            outward_l, cdist, q_l = _point_box(_rt(Rb, p - cb2), s)
            di = cdist - r
            outward = _r(Rb, outward_l)
            po = cb2 + _r(Rb, q_l) + 0.5 * di[..., None] * outward
            if endi == 1:
                # the second candidate only where it is a distinct contact
                # on the same side of the box (a capsule through the box
                # would otherwise give an opposing phantom contact)
                dup = torch.linalg.norm(p - prev_p, dim=-1) < 1e-9
                hemi = torch.sum(outward * prev_out, dim=-1) > 0.0
                di = torch.where(hemi & ~dup, di, torch.full_like(di, 1e10))
            prev_p, prev_out = p, outward
            put(cbx, di, po, make_frame(-outward), endi)

    # ---- sphere-ellipsoid: projection onto the ellipsoid ----
    se = sel(M.GEOM_SPHERE, M.GEOM_ELLIPSOID)
    if se.size:
        ga, gb = m.idx(g1[se]), m.idx(g2[se])
        di, po, n = _sphere_ellipsoid(d.geom_xpos[:, ga], size[..., ga, 0], d.geom_xpos[:, gb],
                                      _gmat(d, gb), size[..., gb, :])
        put(se, di, po, make_frame(n))

    # ---- capsule-ellipsoid: the deepest (or closest) segment point ----
    ce = sel(M.GEOM_CAPSULE, M.GEOM_ELLIPSOID)
    if ce.size:
        ga, gb = m.idx(g1[ce]), m.idx(g2[ce])
        cc_, axc = d.geom_xpos[:, ga], _gz(d, ga)
        r, hc_ = size[..., ga, 0], size[..., ga, 1]
        ce2, Re, se2 = d.geom_xpos[:, gb], _gmat(d, gb), size[..., gb, :]

        def sdist_at(t):
            """Signed point-to-surface distance at segment parameter t: convex,
            so unimodal along the axis, overlapping or not."""
            pl = _rt(Re, cc_ + (t * hc_)[..., None] * axc - ce2)
            x, inside = _ellipsoid_project(pl, se2)
            dn = torch.linalg.norm(pl - x, dim=-1)
            return torch.where(inside, -dn, dn)

        t_best = _seg_argmin(sdist_at, cc_.shape[:-1], dtype, device)
        p = cc_ + (t_best * hc_)[..., None] * axc
        di, po, n = _sphere_ellipsoid(p, r, ce2, Re, se2)
        put(ce, di, po, make_frame(n))

    # ---- sphere-cylinder ----
    scy = sel(M.GEOM_SPHERE, M.GEOM_CYLINDER)
    if scy.size:
        ga, gb = m.idx(g1[scy]), m.idx(g2[scy])
        di, po, n = _sphere_cylinder(d.geom_xpos[:, ga], size[..., ga, 0], d.geom_xpos[:, gb],
                                     _gmat(d, gb), size[..., gb, 0], size[..., gb, 1])
        put(scy, di, po, make_frame(n))

    # ---- capsule-cylinder: the deepest segment point and both ends ----
    ccy = sel(M.GEOM_CAPSULE, M.GEOM_CYLINDER)
    if ccy.size:
        ga, gb = m.idx(g1[ccy]), m.idx(g2[ccy])
        cc_, axc = d.geom_xpos[:, ga], _gz(d, ga)
        r, hc_ = size[..., ga, 0], size[..., ga, 1]
        cc2, Rc = d.geom_xpos[:, gb], _gmat(d, gb)
        rcy, hcy = size[..., gb, 0], size[..., gb, 1]

        def sdist_cyl(t):
            """The signed point-cylinder distance at segment parameter t
            (convex, so unimodal along the axis)."""
            return _point_cylinder(_rt(Rc, cc_ + (t * hc_)[..., None] * axc - cc2), rcy, hcy)[0]

        t_best = _seg_argmin(sdist_cyl, cc_.shape[:-1], dtype, device)
        # a capsule lying along the side or across a cap touches on a line:
        # the end candidates activate there, and drop out where the deepest
        # point is an end
        for ci, t in enumerate((t_best, torch.ones_like(t_best), -torch.ones_like(t_best))):
            p = cc_ + (t * hc_)[..., None] * axc
            di, po, n = _sphere_cylinder(p, r, cc2, Rc, rcy, hcy)
            if ci > 0:
                di = torch.where(torch.abs(t - t_best) < 1e-4, torch.full_like(di, 1e10), di)
            put(ccy, di, po, make_frame(n), ci)

    # ---- convex pairs: ascent of the support-function gap ----
    # over unit u, g(u) = u.(c2 - c1) - h1(u) - h2(-u) is the signed
    # separation at its maximum (a penetration's exact translation vector),
    # and its gradient needs only the support witnesses; normalized steps
    # along the sphere, decaying by 0.93. MuJoCo's mjc_Convex (MPR) also
    # gives one contact for these pairs.
    for ta, tb in _CONVEX_PAIRS:
        cv = sel(ta, tb)
        if not cv.size:
            continue
        ga, gb = m.idx(g1[cv]), m.idx(g2[cv])
        c1w, c2w = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
        R1w, R2w = _gmat(d, ga), _gmat(d, gb)
        s1w, s2w = size[..., ga, :], size[..., gb, :]
        mv = lambda g: m.mesh_vert[..., m.idx(np.asarray(m.geom_meshidx)[g[cv]]), :, :]
        v1 = mv(g1) if ta == M.GEOM_MESH else None
        v2 = mv(g2) if tb == M.GEOM_MESH else None
        dc = c2w - c1w
        u, step = _norm(dc), 0.5
        for _ in range(_CONVEX_STEPS):
            _, w1 = _support(ta, R1w, s1w, u, v1)
            _, w2 = _support(tb, R2w, s2w, -u, v2)
            grad = dc - w1 + w2  # h2 along -u: the witness is -w2(-u)
            grad = grad - u * torch.sum(u * grad, -1, keepdim=True)
            u, step = _norm(u + step * _norm(grad)), step * _CONVEX_DECAY
        h1, w1 = _support(ta, R1w, s1w, u, v1)
        h2, w2 = _support(tb, R2w, s2w, -u, v2)
        di = torch.sum(u * dc, -1) - h1 - h2
        put(cv, di, 0.5 * ((c1w + w1) + (c2w + w2)), make_frame(u))

    # ---- box-box: the separating axis test, a face manifold or an edge ----
    bb = sel(M.GEOM_BOX, M.GEOM_BOX)
    if bb.size:
        ga, gb = m.idx(g1[bb]), m.idx(g2[bb])
        di, po, nr = _box_box(d.geom_xpos[:, ga], _gmat(d, ga), size[..., ga, :].expand(B, -1, -1),
                              d.geom_xpos[:, gb], _gmat(d, gb), size[..., gb, :].expand(B, -1, -1))
        slots = m.idx((slot0[bb][:, None] + np.arange(8)[None, :]).ravel())
        dist[:, slots] = di.reshape(B, -1)
        pos[:, slots] = po.reshape(B, -1, 3)
        frame[:, slots] = make_frame(nr.reshape(B, -1, 3))

    # ---- ellipsoid-ellipsoid: ascent of the support-function gap ----
    ee = sel(M.GEOM_ELLIPSOID, M.GEOM_ELLIPSOID)
    if ee.size:
        # over unit directions u the gap g(u) = u.(c2 - c1) - sqrt(u^T A1 u)
        # - sqrt(u^T A2 u), A_i = R_i diag(s_i^2) R_i^T, is concave and its
        # maximum is the signed separation at the contact normal:
        # normalized-gradient steps along the sphere, decaying by 0.9
        ga, gb = m.idx(g1[ee]), m.idx(g2[ee])
        c1, c2 = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
        R1, R2 = _gmat(d, ga), _gmat(d, gb)
        s1, s2 = size[..., ga, :], size[..., gb, :]
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
