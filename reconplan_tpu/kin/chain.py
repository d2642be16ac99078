"""Pure-JAX kinematic chains: FK and geometric Jacobians.

Replaces Klampt's C++ FK (``grr/robot.py:225-243``) and PyBullet's link-state
queries (``bullet_api/robot.py``). The chain is static (parents/axes/offsets
fixed at trace time) so FK unrolls into a short chain of 3x3 matmuls that XLA
fuses; ``vmap`` batches it over configurations.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from reconplan_tpu.kin.rob_parser import RobModel


class KinematicModel(NamedTuple):
    """Device-side chain description.

    Registered as a pytree whose ``parents``/``prismatic`` tuples live in
    the treedef (static, so FK can unroll over them at trace time) while the
    geometry arrays are traced leaves. The model can therefore be passed
    directly through ``jit``/``vmap`` boundaries.
    """

    parents: tuple  # (L,) int, -1 root
    prismatic: tuple  # (L,) bool
    axes: jnp.ndarray  # (L, 3)
    R_parent: jnp.ndarray  # (L, 3, 3)
    t_parent: jnp.ndarray  # (L, 3)
    qmin: jnp.ndarray  # (L,)
    qmax: jnp.ndarray  # (L,)


def _model_flatten(m: "KinematicModel"):
    return (m.axes, m.R_parent, m.t_parent, m.qmin, m.qmax), (m.parents, m.prismatic)


def _model_unflatten(aux, children):
    parents, prismatic = aux
    return KinematicModel(parents, prismatic, *children)


jax.tree_util.register_pytree_node(KinematicModel, _model_flatten, _model_unflatten)


def model_from_rob(rob: RobModel) -> KinematicModel:
    return KinematicModel(
        parents=tuple(int(p) for p in rob.parents),
        prismatic=tuple(t == "p" for t in rob.joint_types),
        axes=jnp.asarray(rob.axes, dtype=jnp.float32),
        R_parent=jnp.asarray(rob.R_parent, dtype=jnp.float32),
        t_parent=jnp.asarray(rob.t_parent, dtype=jnp.float32),
        qmin=jnp.asarray(np.nan_to_num(rob.qmin, neginf=-1e9), dtype=jnp.float32),
        qmax=jnp.asarray(np.nan_to_num(rob.qmax, posinf=1e9), dtype=jnp.float32),
    )


def _axis_rotation(axis, angle):
    """Rodrigues rotation about a unit axis (3,) by ``angle`` (scalar)."""
    x, y, z = axis[0], axis[1], axis[2]
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    C = 1.0 - c
    return jnp.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def fk_all(model: KinematicModel, q: jnp.ndarray):
    """Forward kinematics of every link.

    Args:
        model: chain description.
        q: (L,) full joint vector (inactive joints at their fixed value).

    Returns:
        (R (L, 3, 3), t (L, 3)): world rotation and origin of each link
        frame, matching Klampt's ``link.getTransform()``.
    """
    L = len(model.parents)
    Rs = []
    ts = []
    for i in range(L):
        if model.prismatic[i]:
            R_joint = jnp.eye(3, dtype=q.dtype)
            t_joint = model.axes[i] * q[i]
        else:
            R_joint = _axis_rotation(model.axes[i], q[i])
            t_joint = jnp.zeros(3, dtype=q.dtype)
        # HIGHEST precision: a reduced-precision (TF32) product would cost
        # ~mm of FK accuracy over the 13-link chain (golden wtraj.txt).
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        R_local = mm(model.R_parent[i], R_joint)
        t_local = mm(model.R_parent[i], t_joint) + model.t_parent[i]
        p = model.parents[i]
        if p < 0:
            Rs.append(R_local)
            ts.append(t_local)
        else:
            Rs.append(mm(Rs[p], R_local))
            ts.append(mm(Rs[p], t_local) + ts[p])
    return jnp.stack(Rs), jnp.stack(ts)


def fk_link(model: KinematicModel, q: jnp.ndarray, link: int):
    """World transform of a single link (computed via full FK; XLA DCEs the
    unused branches of the unrolled chain)."""
    R, t = fk_all(model, q)
    return R[link], t[link]


def geometric_jacobian(model: KinematicModel, q: jnp.ndarray, link: int, active: tuple):
    """Geometric Jacobian of ``link``'s frame w.r.t. the ``active`` joints.

    Returns (J (6, A)): rows = [linear velocity; angular velocity], columns
    in ``active`` order. Joints not on the path from root to ``link``
    contribute zero columns automatically (their axis never moves the link —
    detected statically via the parent chain).
    """
    R, t = fk_all(model, q)
    # static ancestor set of `link`
    ancestors = set()
    node = link
    while node >= 0:
        ancestors.add(node)
        node = model.parents[node]

    p_ee = t[link]
    cols = []
    for j in active:
        if j not in ancestors:
            cols.append(jnp.zeros(6, dtype=q.dtype))
            continue
        z = jnp.matmul(R[j], model.axes[j], precision=jax.lax.Precision.HIGHEST)
        if model.prismatic[j]:
            cols.append(jnp.concatenate([z, jnp.zeros(3, dtype=q.dtype)]))
        else:
            cols.append(jnp.concatenate([jnp.cross(z, p_ee - t[j]), z]))
    return jnp.stack(cols, axis=-1)
