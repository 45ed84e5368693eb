"""Spatial (6D) vector algebra in MuJoCo's convention.

Counterpart of ``brax_tracking_tpu/math/spatial.py``. A motion or force
vector is ``[angular(3), linear(3)]``. The component-major ("cm") variants
take ``(..., components, entities)`` tensors, the layout the engine keeps
its c-frame quantities in (``cdof`` is ``(B, 6, nv)``); the symmetric 3x3
inertia is packed as six rows ``[xx, yy, zz, xy, xz, yz]``. The
entity-major ``SpatialInertia`` triple ``(I, h, m)`` of the JAX package,
with its ``inert_mul`` and ``transform_inertia``, is here too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpatialInertia(NamedTuple):
    """A spatial inertia as ``(I, h, m)``: I (..., 3, 3) the rotational
    inertia about the frame origin, h (..., 3) m (com - origin), m (...,)
    the mass; MuJoCo's 10-float ``cinert`` rows."""

    i: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor

    def __add__(self, other: "SpatialInertia") -> "SpatialInertia":
        return SpatialInertia(self.i + other.i, self.h + other.h, self.m + other.m)


def _cross_mat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x of (..., 3) vectors."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def inert_mul(inert: SpatialInertia, v: torch.Tensor) -> torch.Tensor:
    """Spatial inertia times a (..., 6) motion vector, a force vector:
    f = [I w + h x vlin, m vlin - h x w] (mju_mulInertVec)."""
    w, vlin = v[..., :3], v[..., 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    ang = torch.einsum("...ij,...j->...i", inert.i, w) + cross(inert.h, vlin)
    lin = inert.m[..., None] * vlin - cross(inert.h, w)
    return torch.cat([ang, lin], dim=-1)


def transform_inertia(
    body_inertia_diag: torch.Tensor,
    mass: torch.Tensor,
    rot: torch.Tensor,
    offset: torch.Tensor,
) -> SpatialInertia:
    """A principal-axis body inertia about a common frame's origin
    (parallel-axis theorem): body_inertia_diag (..., 3), mass (...,), rot
    (..., 3, 3) the inertial frame in the common frame (MuJoCo's ximat),
    offset (..., 3) the CoM minus the origin. I = R diag(d) R^T + m [c]x
    [c]x^T, MuJoCo's cinert."""
    i_body = rot * body_inertia_diag[..., None, :] @ rot.transpose(-1, -2)
    cx = _cross_mat(offset)
    i_origin = i_body + mass[..., None, None] * (cx @ cx.transpose(-1, -2))
    return SpatialInertia(i_origin, mass[..., None] * offset, mass)


def motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """mju_crossMotion(v, u) = v x u on (..., 6) motion vectors."""
    vang, vlin = v[..., :3], v[..., 3:]
    uang, ulin = u[..., :3], u[..., 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    ang = cross(vang, uang)
    lin = cross(vang, ulin) + cross(vlin, uang)
    return torch.cat([ang, lin], dim=-1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """mju_crossForce(v, f) = v x* f on (..., 6) vectors."""
    vang, vlin = v[..., :3], v[..., 3:]
    fang, flin = f[..., :3], f[..., 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    ang = cross(vang, fang) + cross(vlin, flin)
    lin = cross(vang, flin)
    return torch.cat([ang, lin], dim=-1)


def cross_cm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along dim -2: a, b (..., 3, n) -> (..., 3, n)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2
    )


def motion_cross_cm(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Motion-cross-motion on (..., 6, n) tensors."""
    vang, vlin = v[..., :3, :], v[..., 3:, :]
    uang, ulin = u[..., :3, :], u[..., 3:, :]
    ang = cross_cm(vang, uang)
    lin = cross_cm(vang, ulin) + cross_cm(vlin, uang)
    return torch.cat([ang, lin], dim=-2)


def motion_cross_force_cm(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Motion-cross-force on (..., 6, n) tensors."""
    vang, vlin = v[..., :3, :], v[..., 3:, :]
    fang, flin = f[..., :3, :], f[..., 3:, :]
    ang = cross_cm(vang, fang) + cross_cm(vlin, flin)
    lin = cross_cm(vang, flin)
    return torch.cat([ang, lin], dim=-2)


def inert_mul_cm(
    i6: torch.Tensor, h: torch.Tensor, mass: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Packed spatial inertia times motion:
    (..., 6, n), (..., 3, n), (..., n), (..., 6, n) -> (..., 6, n).

    f = [I w + h x vlin, m vlin - h x w]  (mju_mulInertVec).
    """
    w, vlin = v[..., :3, :], v[..., 3:, :]
    w0, w1, w2 = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    i = [i6[..., k, :] for k in range(6)]
    iw = torch.stack(
        [
            i[0] * w0 + i[3] * w1 + i[4] * w2,
            i[3] * w0 + i[1] * w1 + i[5] * w2,
            i[4] * w0 + i[5] * w1 + i[2] * w2,
        ],
        dim=-2,
    )
    ang = iw + cross_cm(h, vlin)
    lin = mass[..., None, :] * vlin - cross_cm(h, w)
    return torch.cat([ang, lin], dim=-2)


def transform_inertia_cm(
    body_inertia_diag: torch.Tensor,
    mass: torch.Tensor,
    iquat: torch.Tensor,
    offset: torch.Tensor,
):
    """Principal-axis body inertia shifted into a common frame.

    body_inertia_diag: (n, 3) principal moments; mass: (n,);
    iquat: (..., n, 4) world inertial-frame quaternion;
    offset: (..., 3, n) CoM minus common-frame origin.
    Returns (i6 (..., 6, n), h (..., 3, n)).
    """
    w, x, y, z = iquat.unbind(-1)
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    d0, d1, d2 = body_inertia_diag.unbind(-1)

    def entry(a, b):
        # I_ab = sum_k d_k R[a][k] R[b][k]
        return d0 * r[a][0] * r[b][0] + d1 * r[a][1] * r[b][1] + d2 * r[a][2] * r[b][2]

    o0, o1, o2 = offset[..., 0, :], offset[..., 1, :], offset[..., 2, :]
    c2 = o0 * o0 + o1 * o1 + o2 * o2
    i6 = torch.stack(
        [
            entry(0, 0) + mass * (c2 - o0 * o0),
            entry(1, 1) + mass * (c2 - o1 * o1),
            entry(2, 2) + mass * (c2 - o2 * o2),
            entry(0, 1) - mass * o0 * o1,
            entry(0, 2) - mass * o0 * o2,
            entry(1, 2) - mass * o1 * o2,
        ],
        dim=-2,
    )
    h = mass[..., None, :] * offset
    return i6, h
