"""Quaternion algebra, MuJoCo [w, x, y, z] convention, batched on leading dims.

Counterpart of ``brax_tracking_tpu/math/quaternion.py``: same functions,
same semantics, on torch tensors. Every function broadcasts over arbitrary
leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

# Tolerance of the axis-angle pole guard (as in the JAX package).
_TOL = 1e-10


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v."""
    w1, x1, y1, z1 = u.unbind(-1)
    w2, x2, y2, z2 = v.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate [w, -x, -y, -z]."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


# For unit quaternions the conjugate is the inverse.
quat_inv = quat_conj


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_diff(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Rotation from source to target: conj(source) * target."""
    return quat_mul(quat_conj(source), target)


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotates vec by quat (q v q*), brax.math.rotate semantics."""
    s, u = quat[..., :1], quat[..., 1:]
    r = 2.0 * (torch.sum(u * vec, dim=-1, keepdim=True) * u) + (
        s * s - torch.sum(u * u, dim=-1, keepdim=True)
    ) * vec
    u, vec = torch.broadcast_tensors(u, vec)
    return r + 2.0 * s * torch.linalg.cross(u, vec, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotates v from the frame described by q into the parent frame."""
    return rotate(v, q)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotates v from the parent frame into the frame described by q."""
    return rotate(v, quat_conj(q))


def relative_quat(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Relative quaternion from q1 to q2 (brax.math semantics)."""
    return quat_mul(q2, quat_inv(q1))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (branch-free Shepperd method)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qw = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    case = torch.argmax(qw, dim=-1, keepdim=True)
    s = 2.0 * torch.sqrt(
        torch.clamp(torch.gather(qw, -1, case)[..., 0], min=1e-12)
    )
    d21 = m[..., 2, 1] - m[..., 1, 2]
    d02 = m[..., 0, 2] - m[..., 2, 0]
    d10 = m[..., 1, 0] - m[..., 0, 1]
    s01 = m[..., 0, 1] + m[..., 1, 0]
    s02 = m[..., 0, 2] + m[..., 2, 0]
    s12 = m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack(
        [
            torch.stack([s / 4, d21 / s, d02 / s, d10 / s], -1),
            torch.stack([d21 / s, s / 4, s01 / s, s02 / s], -1),
            torch.stack([d02 / s, s01 / s, s / 4, s12 / s], -1),
            torch.stack([d10 / s, s02 / s, s12 / s, s / 4], -1),
        ],
        dim=-2,
    )
    idx = case[..., None].expand(case.shape[:-1] + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    # canonical sign (w >= 0), normalized
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> quaternion."""
    half = angle * 0.5
    return torch.cat(
        [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1
    )


def quat_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle 3-vector (angle encoded as length), angle
    wrapped to (-pi, pi], zero vector near the identity pole."""
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    sin_half = torch.sin(angle / 2)
    wrapped = torch.remainder(angle + math.pi, 2 * math.pi) - math.pi
    safe_sin = torch.where(
        torch.abs(sin_half) < _TOL, torch.ones_like(sin_half), sin_half
    )
    out = quat[..., 1:4] / safe_sin[..., None] * wrapped[..., None]
    return torch.where(angle[..., None] < _TOL, torch.zeros_like(out), out)


def quat_integrate(
    q: torch.Tensor, omega_local: torch.Tensor, dt
) -> torch.Tensor:
    """mju_quatIntegrate: q <- q * exp(omega_local * dt / 2), renormalized."""
    sq = torch.sum(omega_local * omega_local, dim=-1, keepdim=True)
    small = sq < 1e-18
    one = torch.ones_like(sq)
    theta = torch.sqrt(torch.where(small, one, sq)) * dt
    theta = torch.where(small, torch.zeros_like(sq), theta)
    safe = torch.where(small, one, theta)
    k = torch.where(small, 0.5 * dt * one, torch.sin(safe / 2) / safe * dt)
    dq = torch.cat([torch.cos(theta / 2), omega_local * k], dim=-1)
    return quat_normalize(quat_mul(q, dq))


def bounded_quat_dist(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Quaternion distance bounded to [0, pi/2], trailing singleton axis."""
    source = source / torch.linalg.norm(source, dim=-1, keepdim=True)
    target = target / torch.linalg.norm(target, dim=-1, keepdim=True)
    dist = 2 * torch.sum(source * target, dim=-1) ** 2 - 1
    dist = torch.clamp(dist, max=1.0)
    return 0.5 * torch.arccos(dist)[..., None]
