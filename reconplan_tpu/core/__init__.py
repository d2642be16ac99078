"""Core SE3/quaternion math and workspace sampling grids.

JAX replacement for the reference's ``Expansion-GRR/grr/utils.py``
(numba-JIT metrics, scipy Rotation conversions, sklearn BallTree grid
connectivity). Everything device-side is pure ``jax.numpy`` and freely
``vmap``/``jit``-able; grid *construction* helpers are host-side numpy since
they produce static roadmap data once per problem.
"""

from reconplan_tpu.core.maths import (
    quat_identity,
    quat_normalize,
    quat_mul,
    quat_conj,
    quat_rotate,
    quat_to_matrix,
    matrix_to_quat,
    quat_to_euler,
    euler_to_quat,
    euler_to_matrix,
    rotvec_to_quat,
    quat_to_rotvec,
    quaternion_angle,
    quaternion_close,
    interpolate_quat,
    slerp,
    se3_distance,
    se3_metric,
    wrap_to_pi,
    interpolate_angle,
    circular_mean,
    sample_quat,
    pose_to_matrix,
    matrix_to_pose,
    transform_points,
    look_at_quat,
)
from reconplan_tpu.core.grids import (
    get_staggered_grid,
    get_so3_grid,
    super_fibonacci_so3,
)

__all__ = [
    "quat_identity",
    "quat_normalize",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_to_euler",
    "euler_to_quat",
    "euler_to_matrix",
    "rotvec_to_quat",
    "quat_to_rotvec",
    "quaternion_angle",
    "quaternion_close",
    "interpolate_quat",
    "slerp",
    "se3_distance",
    "se3_metric",
    "wrap_to_pi",
    "interpolate_angle",
    "circular_mean",
    "sample_quat",
    "pose_to_matrix",
    "matrix_to_pose",
    "transform_points",
    "look_at_quat",
    "get_staggered_grid",
    "get_so3_grid",
    "super_fibonacci_so3",
]
