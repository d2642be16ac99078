"""SE3 / quaternion math as pure jax.numpy functions.

Functional parity targets (reference, /root/reference):
  - ``Expansion-GRR/grr/utils.py:10-146`` (se3 metric, quaternion angle,
    SLERP, euler/quat/matrix/rotvec conversions, angle wrapping)
  - ``Expansion-GRR/grr/robot.py:203-223`` (weighted circular mean)

Conventions
-----------
* Quaternions are ``[x, y, z, w]`` (scipy order) and unit-norm unless noted.
* Euler sequences follow scipy: uppercase = intrinsic (rotating axes),
  lowercase = extrinsic (fixed axes). Supported: zyx/ZYX/xyz/XYZ.
* All functions broadcast over leading batch dimensions and are jit/vmap
  friendly (no data-dependent Python control flow).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# --------------------------------------------------------------------------
# Quaternion primitives
# --------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32):
    """The identity rotation ``[0, 0, 0, 1]``."""
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_normalize(q, eps=1e-12):
    """Normalize to unit length (safe at zero)."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def quat_mul(q1, q2):
    """Hamilton product; composition ``q1 * q2`` applies q2 first, then q1,
    matching ``quat_to_matrix(q1) @ quat_to_matrix(q2)``."""
    x1, y1, z1, w1 = jnp.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conj(q):
    """Conjugate (inverse for unit quaternions)."""
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q`` (..., 4).

    Uses the 2-cross-product form (cheaper than building the matrix).
    """
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), xyzw.

    Branch-free Shepperd's method: build all four scaled candidates and pick
    the numerically best one with ``where`` (vmap/jit safe).
    """
    m = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = jnp.moveaxis(m, -1, 0)

    # Four candidate 4-vectors (unnormalized), each proportional to the quat.
    # Candidate k is most accurate when the corresponding pivot is largest.
    qw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1 + m00 + m11 + m22], -1)
    qx = jnp.stack([1 + m00 - m11 - m22, m10 + m01, m02 + m20, m21 - m12], -1)
    qy = jnp.stack([m10 + m01, 1 - m00 + m11 - m22, m21 + m12, m02 - m20], -1)
    qz = jnp.stack([m02 + m20, m21 + m12, 1 - m00 - m11 + m22, m10 - m01], -1)

    tw = 1 + m00 + m11 + m22
    tx = 1 + m00 - m11 - m22
    ty = 1 - m00 + m11 - m22
    tz = 1 - m00 - m11 + m22
    pivots = jnp.stack([tx, ty, tz, tw], axis=-1)
    best = jnp.argmax(pivots, axis=-1)

    cands = jnp.stack([qx, qy, qz, qw], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    # candidates qx..qz are ordered (x, y, z, w) already by construction above
    return quat_normalize(q)


_AXES = {"x": 0, "y": 1, "z": 2}

# Euler convention for PROBLEM-BOUNDARY data (problem-JSON
# ``fixed_rotation`` and the ``rot_domain`` axis indexing).
#
# The reference is internally inconsistent here: its conversion helpers
# default to ``seq="zyx"`` (``grr/utils.py:96,108,123``) while
# ``get_so3_grid``'s contract says "fixed_rotation: defined in euler
# angle form (x, y, z)" (``grr/utils.py:270-273``) and the problem JSONs
# comment the same intent. Every roadmap artifact the reference ships
# realizes the (x, y, z) reading: ur10/kinova ``rot_fixed`` configs put
# tool-z straight DOWN (R = Rz(pi/2) @ Rx(-pi) = [[0,1,0],[1,0,0],
# [0,0,-1]]), and planar_5 ``rot_variable`` varies the rotation about the
# +z plane normal. Under the "zyx" reading the same JSONs would point the
# ur10 tool horizontally and spin planar_5 out of its plane (only
# 487/8104 nodes IK-reachable vs the artifact's 3932). We therefore
# interpret problem-boundary euler as extrinsic (x, y, z), matching the
# shipped artifacts and the documented intent.
PROBLEM_EULER_SEQ = "xyz"


def _axis_angle_quat(axis_index, angle):
    half = 0.5 * angle
    s = jnp.sin(half)
    c = jnp.cos(half)
    zeros = jnp.zeros_like(angle)
    comps = [zeros, zeros, zeros]
    comps[axis_index] = s
    return jnp.stack(comps + [c], axis=-1)


def euler_to_quat(euler, seq="zyx", degrees=False):
    """Euler angles (..., len(seq)) -> quaternion, scipy-compatible.

    Intrinsic (uppercase): R = R_s1(a1) @ R_s2(a2) @ R_s3(a3).
    Extrinsic (lowercase): R = R_s3(a3) @ R_s2(a2) @ R_s1(a1).
    Mirrors ``grr/utils.py:123-125`` (which delegates to scipy).
    """
    euler = jnp.asarray(euler)
    if degrees:
        euler = jnp.deg2rad(euler)
    intrinsic = seq.isupper()
    axes = [_AXES[c] for c in seq.lower()]
    quats = [_axis_angle_quat(ax, euler[..., i]) for i, ax in enumerate(axes)]
    if intrinsic:
        q = quats[0]
        for qq in quats[1:]:
            q = quat_mul(q, qq)
    else:
        q = quats[0]
        for qq in quats[1:]:
            q = quat_mul(qq, q)
    return q


def euler_to_matrix(euler, seq="zyx", degrees=False):
    """Euler angles -> rotation matrix (``grr/utils.py:96-98``)."""
    return quat_to_matrix(euler_to_quat(euler, seq, degrees))


def quat_to_euler(q, seq="zyx", degrees=False):
    """Quaternion -> euler angles for seq in {zyx, ZYX, xyz, XYZ}.

    Mirrors ``grr/utils.py:108-110``. Gimbal-lock poles resolve the free
    angle to match atan2 of the clamped matrix entries (same as scipy up to
    the usual pole ambiguity).
    """
    m = quat_to_matrix(q)
    intrinsic = seq.isupper()
    # extrinsic abc == intrinsic CBA with reversed angle order
    key = seq.upper() if intrinsic else seq[::-1].upper()
    if key == "ZYX":
        # intrinsic Z-Y-X (yaw, pitch, roll)
        a1 = jnp.arctan2(m[..., 1, 0], m[..., 0, 0])
        a2 = jnp.arcsin(jnp.clip(-m[..., 2, 0], -1.0, 1.0))
        a3 = jnp.arctan2(m[..., 2, 1], m[..., 2, 2])
    elif key == "XYZ":
        a1 = jnp.arctan2(-m[..., 1, 2], m[..., 2, 2])
        a2 = jnp.arcsin(jnp.clip(m[..., 0, 2], -1.0, 1.0))
        a3 = jnp.arctan2(-m[..., 0, 1], m[..., 0, 0])
    else:  # pragma: no cover - guarded by supported seqs
        raise NotImplementedError(f"euler seq {seq!r} not supported")
    if not intrinsic:
        a1, a3 = a3, a1
    angles = jnp.stack([a1, a2, a3], axis=-1)
    if degrees:
        angles = jnp.rad2deg(angles)
    return angles


def rotvec_to_quat(rotvec):
    """Rotation vector (axis*angle) -> quaternion (``grr/utils.py:113-115``)."""
    rotvec = jnp.asarray(rotvec)
    angle = jnp.linalg.norm(rotvec, axis=-1, keepdims=True)
    half = 0.5 * angle
    # sinc-style safe division: sin(a/2)/a -> 1/2 as a -> 0
    small = angle < 1e-8
    scale = jnp.where(
        small, 0.5 + angle**2 / 48.0, jnp.sin(half) / jnp.maximum(angle, 1e-30)
    )
    xyz = rotvec * scale
    w = jnp.cos(half)
    return jnp.concatenate([xyz, w], axis=-1)


def quat_to_rotvec(q):
    """Quaternion -> rotation vector (``grr/utils.py:118-120``)."""
    q = quat_normalize(q)
    # force w >= 0 for the short rotation
    q = q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)
    sin_half = jnp.linalg.norm(q[..., :3], axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(sin_half[..., 0], q[..., 3])[..., None]
    small = sin_half < 1e-8
    scale = jnp.where(
        small, 2.0 + angle**2 / 12.0, angle / jnp.maximum(sin_half, 1e-30)
    )
    return q[..., :3] * scale


def quaternion_angle(q1, q2):
    """Arc-length distance between two rotations (``grr/utils.py:63-70``)."""
    d = jnp.abs(jnp.sum(q1 * q2, axis=-1))
    return 2.0 * jnp.arccos(jnp.minimum(d, 1.0))


def quaternion_close(q1, q2, eps=1e-3):
    """Whether two quaternions encode nearly the same rotation
    (``grr/utils.py:73-75``)."""
    return quaternion_angle(q1, q2) < eps


def slerp(q1, q2, u):
    """Spherical linear interpolation along the shortest arc.

    ``u`` broadcasts; u=0 -> q1, u=1 -> q2 (up to sign).
    """
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    dot = jnp.sum(q1 * q2, axis=-1, keepdims=True)
    q2 = jnp.where(dot < 0, -q2, q2)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    u = jnp.asarray(u)[..., None] if jnp.ndim(u) == q1.ndim - 1 else jnp.asarray(u)
    # fall back to lerp when the arc is tiny
    small = sin_theta < 1e-6
    w1 = jnp.where(small, 1.0 - u, jnp.sin((1.0 - u) * theta) / jnp.where(small, 1.0, sin_theta))
    w2 = jnp.where(small, u, jnp.sin(u * theta) / jnp.where(small, 1.0, sin_theta))
    return quat_normalize(w1 * q1 + w2 * q2)


def interpolate_quat(q1, q2, u):
    """SLERP matching the reference helper (``grr/utils.py:78-88``)."""
    return slerp(q1, q2, u)


# --------------------------------------------------------------------------
# SE3 metric (the NN metric of the whole GRR stack)
# --------------------------------------------------------------------------


def se3_distance(point1, point2, position_weight=1.0, rotation_weight=0.3):
    """Distance between workspace points, R^3 or SE3.

    ``1.0 * ||p1 - p2|| + 0.3 * (1 - |q1 . q2|)`` exactly as the reference's
    numba kernel (``grr/utils.py:35-60``). Points with trailing dim <= 3 are
    treated as position-only. Broadcasts over batch dims.
    """
    point1 = jnp.asarray(point1)
    point2 = jnp.asarray(point2)
    d_pos = jnp.linalg.norm(point1[..., :3] - point2[..., :3], axis=-1)
    # either side position-only (mixed 3D targets vs posed points):
    # compare positions
    if point1.shape[-1] <= 3 or point2.shape[-1] <= 3:
        return d_pos
    d_rot = 1.0 - jnp.abs(
        jnp.sum(point1[..., 3:7] * point2[..., 3:7], axis=-1)
    )
    return position_weight * d_pos + rotation_weight * d_rot


se3_metric = se3_distance  # alias, matching ``grr/utils.py:10-24``


# --------------------------------------------------------------------------
# Angles
# --------------------------------------------------------------------------


def wrap_to_pi(angle):
    """Wrap to [-pi, pi) (``grr/utils.py:128-131``)."""
    return jnp.mod(angle + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def interpolate_angle(a1, a2, u):
    """Shortest-path angle interpolation (``grr/utils.py:134-141``)."""
    delta = wrap_to_pi(a2 - a1)
    return wrap_to_pi(a1 + u * delta)


def circular_mean(angles, weights, axis=0):
    """Weighted circular mean, the cyclic-joint branch of
    ``Robot.average`` (``grr/robot.py:216-221``)."""
    x = jnp.sum(weights * jnp.cos(angles), axis=axis)
    y = jnp.sum(weights * jnp.sin(angles), axis=axis)
    return jnp.arctan2(y, x)


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------


def sample_quat(key, shape=()):
    """Uniform random unit quaternion(s) (``grr/utils.py:144-146``),
    via the standard 4D-Gaussian normalization (Marsaglia)."""
    g = jax.random.normal(key, shape + (4,))
    return quat_normalize(g)


# --------------------------------------------------------------------------
# Rigid transforms
# --------------------------------------------------------------------------


def pose_to_matrix(pos, quat):
    """(pos (...,3), quat (...,4)) -> homogeneous transform (..., 4, 4)."""
    rot = quat_to_matrix(quat)
    top = jnp.concatenate([rot, pos[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def matrix_to_pose(T):
    """Homogeneous transform (..., 4, 4) -> (pos, quat)."""
    return T[..., :3, 3], matrix_to_quat(T[..., :3, :3])


def transform_points(T, points):
    """Apply (..., 4, 4) transform(s) to (..., N, 3) points.

    Uses HIGHEST matmul precision: a default-precision f32 product may run
    in TF32 on the GPU's tensor cores (~1e-3 relative error), far above the
    sub-mm accuracy this framework targets for registration/fusion.
    """
    rotated = jnp.matmul(
        points,
        T[..., :3, :3].swapaxes(-1, -2),
        precision=jax.lax.Precision.HIGHEST,
    )
    return rotated + T[..., None, :3, 3]


def look_at_quat(eye, target):
    """Camera look-at orientation used by the reference arc builder.

    Z axis points from ``eye`` toward ``target``; the remaining axes are
    built from an arbitrary reference vector exactly as ``main.py:107-127``
    / ``workspace.py:237-252``: x = normalize(cross([1,0,0] or [0,1,0], z)),
    y = cross(z, x), and the resulting matrix is *transposed* before use
    (reference quirk, kept for roadmap parity). Returns the quaternion of
    euler ZYX (0, pitch, roll) of that transposed frame — i.e. with the yaw
    component zeroed — matching ``main.py:126-127``.
    """
    eye = jnp.asarray(eye, dtype=jnp.float32)
    target = jnp.asarray(target, dtype=jnp.float32)
    z_axis = target - eye
    z_axis = z_axis / jnp.linalg.norm(z_axis, axis=-1, keepdims=True)
    ex = jnp.array([1.0, 0.0, 0.0], dtype=z_axis.dtype)
    ey = jnp.array([0.0, 1.0, 0.0], dtype=z_axis.dtype)
    near_x = jnp.linalg.norm(z_axis - ex, axis=-1, keepdims=True) < 1e-6
    arbit = jnp.where(near_x, ey, ex)
    x_axis = jnp.cross(arbit, z_axis)
    x_axis = x_axis / jnp.linalg.norm(x_axis, axis=-1, keepdims=True)
    y_axis = jnp.cross(z_axis, x_axis)
    rot = jnp.stack([x_axis, y_axis, z_axis], axis=-2)  # == column_stack(...).T
    euler = quat_to_euler(matrix_to_quat(rot), seq="ZYX")
    zeroed = jnp.stack(
        [jnp.zeros_like(euler[..., 0]), euler[..., 1], euler[..., 2]], axis=-1
    )
    return euler_to_quat(zeroed, seq="ZYX")
