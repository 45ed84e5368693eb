"""The port's quaternion and spatial functions against the JAX package's,
on the same seeded inputs in float64 (mirrors tests/test_math.py).

Tolerance: atol 1e-12 (1e-9 for mat_to_quat's square roots). The two
implementations evaluate the same formulas; they differ by rounding only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tracking_tpu import math as jm
from brax_tracking_tpu.math import spatial as js
from brax_tracking_tpu_torch import math as tm
from brax_tracking_tpu_torch.math import spatial as ts

ATOL = 1e-12


def random_quats(n, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


@pytest.mark.parametrize(
    "name", ["quat_mul", "quat_diff", "relative_quat"]
)
def test_quat_binary(name):
    qa, qb = random_quats(32, 1), random_quats(32, 2)
    _close(getattr(tm, name)(T(qa), T(qb)), getattr(jm, name)(jnp.array(qa), jnp.array(qb)))


@pytest.mark.parametrize(
    "name", ["quat_conj", "quat_normalize", "quat_to_mat", "quat_to_axis_angle"]
)
def test_quat_unary(name):
    q = random_quats(32, 3) * 1.7
    if name != "quat_normalize":
        q = random_quats(32, 3)
    _close(getattr(tm, name)(T(q)), getattr(jm, name)(jnp.array(q)))


def test_rotate_and_inverse():
    q = random_quats(32, 4)
    v = np.random.RandomState(5).randn(32, 3)
    _close(tm.rotate(T(v), T(q)), jm.rotate(jnp.array(v), jnp.array(q)))
    _close(tm.quat_rotate(T(q), T(v)), jm.quat_rotate(jnp.array(q), jnp.array(v)))
    _close(tm.quat_rotate_inv(T(q), T(v)), jm.quat_rotate_inv(jnp.array(q), jnp.array(v)))
    # broadcast: one quaternion per row, several vectors (the env's obs)
    vv = np.random.RandomState(6).randn(32, 5, 3)
    want = np.stack([np.asarray(jm.rotate(jnp.array(vv[:, k]), jnp.array(q))) for k in range(5)], 1)
    _close(tm.rotate(T(vv), T(q)[:, None]), want)


def test_mat_to_quat_roundtrip():
    q = random_quats(64, 7)
    m = jm.quat_to_mat(jnp.array(q))
    _close(tm.mat_to_quat(T(m)), jm.mat_to_quat(m), atol=1e-9)


def test_axis_angle_and_integrate():
    rng = np.random.RandomState(8)
    axis = rng.randn(32, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-3, 3, 32)
    _close(tm.axis_angle_to_quat(T(axis), T(angle)), jm.axis_angle_to_quat(jnp.array(axis), jnp.array(angle)))
    q = random_quats(16, 9)
    w = rng.randn(16, 3) * 3.0
    w[0] = 0.0  # the small-angle branch
    _close(tm.quat_integrate(T(q), T(w), 0.002), jm.quat_integrate(jnp.array(q), jnp.array(w), 0.002))
    # the identity pole of quat_to_axis_angle
    np.testing.assert_array_equal(tm.quat_to_axis_angle(T([1.0, 0, 0, 0])).numpy(), np.zeros(3))


def test_bounded_quat_dist():
    qa, qb = random_quats(64, 10), random_quats(64, 11)
    _close(tm.bounded_quat_dist(T(qa), T(qb)), jm.bounded_quat_dist(jnp.array(qa), jnp.array(qb)))


def test_motion_cross():
    rng = np.random.RandomState(12)
    v, u = rng.randn(8, 6), rng.randn(8, 6)
    _close(tm.motion_cross(T(v), T(u)), jm.motion_cross(jnp.array(v), jnp.array(u)))
    _close(tm.motion_cross_force(T(v), T(u)), jm.motion_cross_force(jnp.array(v), jnp.array(u)))


def test_component_major_spatial():
    """The (..., components, n) variants against the JAX (components, n)
    ones, per env of a batch of 4."""
    rng = np.random.RandomState(13)
    n = 7
    v, u = rng.randn(4, 6, n), rng.randn(4, 6, n)
    i6, h, mass = rng.randn(4, 6, n), rng.randn(4, 3, n), rng.rand(n)
    diag, iquat, off = rng.rand(n, 3), random_quats(4 * n, 14).reshape(4, n, 4), rng.randn(4, 3, n)
    for b in range(4):
        _close(ts.motion_cross_cm(T(v), T(u))[b], js.motion_cross_cm(jnp.array(v[b]), jnp.array(u[b])))
        _close(ts.motion_cross_force_cm(T(v), T(u))[b], js.motion_cross_force_cm(jnp.array(v[b]), jnp.array(u[b])))
        _close(ts.inert_mul_cm(T(i6), T(h), T(mass), T(v))[b],
               js.inert_mul_cm(jnp.array(i6[b]), jnp.array(h[b]), jnp.array(mass), jnp.array(v[b])))
        ti6, th = ts.transform_inertia_cm(T(diag), T(mass), T(iquat), T(off))
        ji6, jh = js.transform_inertia_cm(jnp.array(diag), jnp.array(mass), jnp.array(iquat[b]), jnp.array(off[b]))
        _close(ti6[b], ji6)
        _close(th[b], jh)
