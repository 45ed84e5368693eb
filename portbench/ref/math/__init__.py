"""Quaternion and spatial-vector algebra on torch tensors, batched on
leading dims (counterpart of ``brax_tracking_tpu/math``)."""

from portbench.ref.math.quaternion import (
    axis_angle_to_quat,
    bounded_quat_dist,
    mat_to_quat,
    quat_conj,
    quat_diff,
    quat_integrate,
    quat_inv,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_axis_angle,
    quat_to_mat,
    relative_quat,
    rotate,
)
from portbench.ref.math.spatial import motion_cross, motion_cross_force

__all__ = [
    "axis_angle_to_quat",
    "bounded_quat_dist",
    "mat_to_quat",
    "quat_conj",
    "quat_diff",
    "quat_integrate",
    "quat_inv",
    "quat_mul",
    "quat_normalize",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_to_axis_angle",
    "quat_to_mat",
    "relative_quat",
    "rotate",
    "motion_cross",
    "motion_cross_force",
]
