"""The robot protocol: sampling, metrics, FK/IK, collision.

API-parity target: the duck-typed robot protocol consumed by all reference
planning code (``grr/robot.py:93-312`` and its PyBullet twin
``bullet_api/robot.py:118-343``):

    workspace_sample, workspace_distance, workspace_interpolate,
    sample, distance, interpolate, average,
    solve_fk, solve_ik, check_self_collision

One JAX implementation replaces both C++ backends. On top of the reference
surface, every kernel has a batched twin (``solve_ik_batch``,
``solve_fk_batch``, ``distance_batch``) — the roadmap builder and online
solver run thousands of these per device dispatch instead of one FFI call
each.

Behavioral notes (divergences from the reference are deliberate and listed):
  * ``rotation`` is force-set to "variable" at construction just like
    ``grr/robot.py:61`` (the reference hard-overrides whatever the problem
    JSON said); pass ``rotation=`` explicitly to override.
  * The reference's UR10 floor check dereferences ``q`` *before* checking
    IK success (``grr/robot.py:455-463`` — a latent crash). Here failure is
    checked first.
  * IK failure is a value, never an exception (``none_on_fail`` threading),
    matching the reference's failure-detection idiom (SURVEY §5).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from reconplan_tpu.core import maths
from reconplan_tpu.kin import collision as coll
from reconplan_tpu.kin.chain import fk_all, model_from_rob
from reconplan_tpu.kin.ik import dls_ik_batch
from reconplan_tpu.kin.rob_parser import load_off_vertices, parse_rob

_DEFAULT_DATA_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data", "robots"),
    "/root/reference/Expansion-GRR/data/robots",
)


def _find_rob_file(name: str) -> str:
    for d in _DEFAULT_DATA_DIRS:
        p = os.path.join(d, name + ".rob")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"robot file {name}.rob not found in {_DEFAULT_DATA_DIRS}")


class Robot:
    """A kinematic-chain robot with workspace/config-space operations.

    Args mirror ``grr/robot.py:20-36``: ``name`` (.rob basename), ``domain``
    ([min,max] per position axis), ``rot_domain`` ([0/1] per euler axis),
    ``fixed_rotation`` (euler xyz, radians).
    """

    # subclasses override
    ACTIVE_JOINTS: list[int] | None = None
    EE_LINK_NAME: str | None = None
    SELF_GEOMETRY_LINKS: list = ()
    EE_GEOMETRY_LINKS: list = ()
    FLOOR_CHECK = False

    def __init__(self, name, domain, rot_domain, fixed_rotation=None, rotation=None):
        self.name = name
        self.rob = parse_rob(_find_rob_file(name), name=name)
        self.model = model_from_rob(self.rob)

        self.domain = [tuple(map(float, d)) for d in domain]
        self.rot_domain = list(rot_domain)
        self.fixed_rotation = (
            np.asarray(
                maths.euler_to_quat(
                    jnp.asarray(fixed_rotation, dtype=jnp.float32),
                    seq=maths.PROBLEM_EULER_SEQ,
                )
            )
            if fixed_rotation is not None
            else None
        )
        if rotation is not None:
            self.rotation = rotation
        else:
            # The reference's ORIGINAL mode logic (grr/robot.py:46-58).
            # Upstream later forced "variable" unconditionally
            # (grr/robot.py:60) for the UR10 scan flow — but that hack
            # breaks every fixed-rotation build: uniform workspace
            # sampling then attaches random quaternions that a
            # fixed-orientation problem (kinova rot_fixed, planar_5) can
            # never reach, so no IK converges. The UR10 arc flow is
            # unaffected (its 7D look-at arc points drive IK regardless
            # of mode).
            if self.fixed_rotation is not None:
                self.rotation = (
                    "fixed" if float(np.sum(rot_domain)) == 0 else "variable"
                )
            else:
                self.rotation = "free"

        limits = np.stack([self.rob.qmin, self.rob.qmax], axis=-1)
        if self.ACTIVE_JOINTS is not None:
            self.active_joints = list(self.ACTIVE_JOINTS)
        else:
            self.active_joints = [
                i for i, (lo, hi) in enumerate(limits) if lo != hi
            ]
        self.joint_limits = limits[self.active_joints]
        self.num_joints = len(self.active_joints)
        self.cyclic_joints = np.array(
            [
                i
                for i, (lo, hi) in enumerate(self.joint_limits)
                if np.isinf(lo) or np.isinf(hi)
            ],
            dtype=np.int64,
        )
        self._cyclic_mask = jnp.zeros(self.num_joints, dtype=bool).at[
            jnp.asarray(self.cyclic_joints, dtype=jnp.int32)
        ].set(True) if len(self.cyclic_joints) else jnp.zeros(self.num_joints, dtype=bool)

        ee_name = self.EE_LINK_NAME or self.rob.link_names[-1]
        try:
            self.ee_link = self.rob.link_index(ee_name)
        except ValueError:
            self.ee_link = self.rob.num_links - 1
        # link list exposed by solve_fk: active links + ee (grr/robot.py:234)
        self.fk_links = list(self.active_joints) + [self.ee_link]

        self._active_tuple = tuple(self.active_joints)
        self._active_idx = jnp.asarray(self.active_joints, dtype=jnp.int32)
        self._q_rest = jnp.zeros(self.rob.num_links, dtype=jnp.float32)

        self._spheres = self._load_spheres()
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------
    # geometry setup
    # ------------------------------------------------------------------
    def _load_spheres(self, n_spheres: int = 32):
        """Fit covering sphere clouds for the reference's self/ee geometry
        groups. Returns None when the robot declares no collision groups.

        Replaces the round-2 single-capsule fit: capsules over-approximated
        long links so coarsely that wrist-folded camera poses with ~6 cm of
        true mesh clearance were rejected (measured on the ur10 scan-arc
        workload), which is what forced 147/498 waypoints onto the IK
        fallback. A 32-sphere k-means cloud per link covers every mesh
        vertex (no false negatives) with ~1 cm local slack.
        """
        if not self.SELF_GEOMETRY_LINKS or not self.EE_GEOMETRY_LINKS:
            return None

        def group(links):
            idx, cs, rs = [], [], []
            for ln in links:
                li = ln if isinstance(ln, int) else self.rob.link_index(ln)
                geom = self.rob.geometry[li]
                if not geom or not geom.endswith(".off"):
                    continue
                path = os.path.join(self.rob.source_dir, geom)
                if not os.path.exists(path):
                    continue
                c, r = coll.fit_spheres_off(
                    load_off_vertices(path), n_spheres=n_spheres
                )
                # pad to the common S so groups stack into one array
                pad = n_spheres - len(r)
                if pad:
                    c = np.concatenate([c, np.zeros((pad, 3), np.float32)])
                    r = np.concatenate(
                        [r, np.full(pad, coll.PAD_RADIUS, np.float32)]
                    )
                idx.append(li)
                cs.append(c)
                rs.append(r)
            if not idx:
                return None
            return (
                jnp.asarray(idx, dtype=jnp.int32),
                jnp.asarray(np.stack(cs)),
                jnp.asarray(np.stack(rs)),
            )

        g_self = group(self.SELF_GEOMETRY_LINKS)
        g_ee = group(self.EE_GEOMETRY_LINKS)
        if g_self is None or g_ee is None:
            return None
        sph = {"self": g_self, "ee": g_ee}
        sph["thresholds"] = self._calibrate_collision_thresholds(sph)
        return sph

    def _calibrate_collision_thresholds(self, sph):
        """Per-link-pair clearance thresholds, calibrated at home.

        A pair collides when its sphere-cloud signed clearance drops below
        its threshold. The default is 0 (actual cloud overlap); pairs that
        are already adjacent at the home configuration (wrist <-> gripper
        base, which stay close in every configuration) get a
        slightly-below-home threshold instead — the sphere analogue of
        MoveIt's allowed-collision matrix, computed automatically instead
        of hand-listed like the reference's `noselfcollision` .rob
        entries (ur10.rob)."""
        gs, ge = sph["self"], sph["ee"]
        q_home = jnp.zeros(self.rob.num_links, dtype=jnp.float32)
        R, t = fk_all(self.model, q_home)
        ca = coll.transform_spheres(R[gs[0]], t[gs[0]], gs[1])
        cb = coll.transform_spheres(R[ge[0]], t[ge[0]], ge[1])
        clr_home = coll.sphere_group_clearance(ca, gs[2], cb, ge[2])
        return jnp.minimum(0.0, clr_home - 0.005)

    # ------------------------------------------------------------------
    # workspace ops (grr/robot.py:93-163)
    # ------------------------------------------------------------------
    def workspace_sample(self, key=None, rng=None):
        """Sample a workspace point ([x,y,z] or [x,y,z,qx,qy,qz,qw]).

        ``rng``: optional caller-local numpy Generator (see
        :meth:`sample`)."""
        gen = self._rng if rng is None else rng
        point = [gen.uniform(a, b) for (a, b) in self.domain]
        if self.rotation == "variable":
            if int(np.sum(self.rot_domain)) == 1:
                angle = gen.uniform(-np.pi, np.pi)
                # np.array (copy): np.asarray of a JAX array is read-only
                euler = np.array(
                    maths.quat_to_euler(
                        jnp.asarray(self.fixed_rotation),
                        seq=maths.PROBLEM_EULER_SEQ,
                    )
                )
                euler[self.rot_domain.index(1)] = angle
                quat = np.asarray(
                    maths.euler_to_quat(
                        jnp.asarray(euler), seq=maths.PROBLEM_EULER_SEQ
                    )
                )
            else:
                g = gen.normal(size=4)
                quat = g / np.linalg.norm(g)
            point = np.concatenate([point, quat])
        return np.asarray(point)

    def workspace_distance(self, p1, p2):
        return float(maths.se3_distance(jnp.asarray(p1), jnp.asarray(p2)))

    def workspace_interpolate(self, p1, p2, u):
        """Mixed 3D/7D endpoints are allowed (rot_free teleop targets are
        position-only while roadmap nodes carry poses): the single
        available quaternion rides along unchanged."""
        p1 = jnp.asarray(p1, dtype=jnp.float32)
        p2 = jnp.asarray(p2, dtype=jnp.float32)
        pos = p1[:3] + u * (p2[:3] - p1[:3])
        if p1.shape[0] > 3 and p2.shape[0] > 3:
            quat = maths.slerp(p1[3:7], p2[3:7], u)
            return np.asarray(jnp.concatenate([pos, quat]))
        if p1.shape[0] > 3 or p2.shape[0] > 3:
            quat = p1[3:7] if p1.shape[0] > 3 else p2[3:7]
            return np.asarray(jnp.concatenate([pos, quat]))
        return np.asarray(pos)

    # ------------------------------------------------------------------
    # config-space ops (grr/robot.py:165-223)
    # ------------------------------------------------------------------
    def sample(self, n=None, rng=None):
        """Random configuration(s); cyclic joints sample [-pi, pi).

        ``rng`` (optional numpy Generator) draws from a caller-local
        stream instead of the robot's shared ``_rng`` — use it when a
        deterministic draw must not perturb other users of the robot."""
        shape = (self.num_joints,) if n is None else (n, self.num_joints)
        lo = np.where(np.isinf(self.joint_limits[:, 0]), -np.pi, self.joint_limits[:, 0])
        hi = np.where(np.isinf(self.joint_limits[:, 1]), np.pi, self.joint_limits[:, 1])
        gen = self._rng if rng is None else rng
        return gen.uniform(lo, hi, size=shape).astype(np.float32)

    def _config_diff(self, q1, q2):
        diff = jnp.asarray(q1) - jnp.asarray(q2)
        return jnp.where(self._cyclic_mask, maths.wrap_to_pi(diff), diff)

    def distance(self, q1, q2):
        """Config distance with cyclic wrap (grr/robot.py:180-190)."""
        return float(jnp.linalg.norm(self._config_diff(q1, q2)))

    def distance_batch(self, q1, q2):
        """(..., A) vs (..., A) -> (...,) distances on device."""
        diff = jnp.asarray(q1) - jnp.asarray(q2)
        diff = jnp.where(self._cyclic_mask, maths.wrap_to_pi(diff), diff)
        return jnp.linalg.norm(diff, axis=-1)

    def interpolate(self, q1, q2, u):
        """Shortest-path config interpolation (grr/robot.py:192-201)."""
        q1 = jnp.asarray(q1, dtype=jnp.float32)
        q2 = jnp.asarray(q2, dtype=jnp.float32)
        lin = q1 + u * (q2 - q1)
        cyc = maths.wrap_to_pi(q1 + u * maths.wrap_to_pi(q2 - q1))
        return np.asarray(jnp.where(self._cyclic_mask, cyc, lin))

    def average(self, configs, weights=None):
        """Weighted average; circular mean on cyclic joints
        (grr/robot.py:203-223)."""
        configs = jnp.asarray(configs, dtype=jnp.float32)
        if weights is None or float(np.sum(weights)) == 0.0:
            weights = jnp.ones(configs.shape[0]) / configs.shape[0]
        else:
            weights = jnp.asarray(weights, dtype=jnp.float32)
            weights = weights / jnp.sum(weights)
        lin = jnp.sum(configs * weights[:, None], axis=0)
        circ = maths.circular_mean(configs, weights[:, None], axis=0)
        return np.asarray(jnp.where(self._cyclic_mask, circ, lin))

    # ------------------------------------------------------------------
    # FK (grr/robot.py:225-243)
    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def _fk_device(self, config):
        q = self._q_rest.at[self._active_idx].set(config)
        R, t = fk_all(self.model, q)
        links = jnp.asarray(self.fk_links)
        return t[links], maths.matrix_to_quat(R[links])

    def solve_fk(self, config, index=None):
        """Positions and rotations (quats) of active links + ee.

        ``index`` selects into that list, -1 being the end effector —
        exactly the reference semantics (``grr/robot.py:225-243``)."""
        pos, rot = self._fk_device(jnp.asarray(config, dtype=jnp.float32))
        pos, rot = np.asarray(pos), np.asarray(rot)
        if index is not None:
            pos, rot = pos[index], rot[index]
        return pos, rot

    def solve_fk_batch(self, configs):
        """(B, A) -> (B, len(fk_links), 3), (B, len(fk_links), 4) on device."""
        return jax.vmap(self._fk_device)(jnp.asarray(configs, dtype=jnp.float32))

    def fk_point_batch(self, configs):
        """(B, A) -> (B, 7) end-effector workspace points [pos, quat]."""
        pos, rot = self.solve_fk_batch(configs)
        return jnp.concatenate([pos[:, -1], rot[:, -1]], axis=-1)

    # ------------------------------------------------------------------
    # IK (grr/robot.py:245-312)
    # ------------------------------------------------------------------
    def _ik_targets(self, points):
        """points (B, 3|7) -> (pos (B,3), rotm (B,3,3), use_rotation)."""
        points = jnp.asarray(points, dtype=jnp.float32)
        if points.ndim == 1:
            points = points[None]
        pos = points[:, :3]
        if self.rotation in ("variable", "free") and points.shape[1] >= 7:
            quat = maths.quat_normalize(points[:, 3:7])
            return pos, maths.quat_to_matrix(quat), True
        if self.rotation == "fixed" and self.fixed_rotation is not None:
            quat = jnp.broadcast_to(
                jnp.asarray(self.fixed_rotation, dtype=jnp.float32), (pos.shape[0], 4)
            )
            return pos, maths.quat_to_matrix(quat), True
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (pos.shape[0], 3, 3))
        return pos, eye, False

    def solve_ik_batch(
        self, points, init_configs=None, max_iters=100, tolerance=1e-3
    ):
        """Batched IK: (B, 3|7) points -> (configs (B, A), success (B,)).

        success folds in Klampt-style convergence AND the robot's validity
        checks (floor, self-collision) like ``UR10.solve_ik``
        (``grr/robot.py:432-466``)."""
        pos, rotm, use_rot = self._ik_targets(points)
        B = pos.shape[0]
        if init_configs is None:
            init_configs = self.sample(B)
        init = jnp.asarray(init_configs, dtype=jnp.float32)
        if init.ndim == 1:
            init = jnp.broadcast_to(init, (B, self.num_joints))
        res = dls_ik_batch(
            self.model,
            self._active_tuple,
            self.ee_link,
            pos,
            rotm,
            init,
            self._q_rest,
            max_iters=max_iters,
            tolerance=tolerance,
            use_rotation=use_rot,
        )
        q = jnp.where(self._cyclic_mask, maths.wrap_to_pi(res.config), res.config)
        valid = self._validate_batch(q)
        return q, jnp.logical_and(res.success, valid)

    def solve_ik(
        self, point, init_config=None, max_iters=100, tolerance=1e-3, none_on_fail=True
    ):
        """Single-solve API mirroring ``grr/robot.py:245-312``.

        Returns the config ndarray, or None on failure when
        ``none_on_fail`` (failure = no convergence OR floor/self-collision,
        matching the UR10/Kinova overrides)."""
        if init_config is None:
            init_config = self.sample()
        q, ok = self.solve_ik_batch(
            jnp.asarray(point)[None],
            jnp.asarray(init_config, dtype=jnp.float32)[None],
            max_iters=max_iters,
            tolerance=tolerance,
        )
        if none_on_fail and not bool(ok[0]):
            return None
        return np.asarray(q[0])

    # ------------------------------------------------------------------
    # validity (floor + self collision)
    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def _validate_device(self, config):
        q = self._q_rest.at[self._active_idx].set(config)
        R, t = fk_all(self.model, q)
        ok = jnp.asarray(True)
        if self.FLOOR_CHECK:
            # reference: reject when any active link origin z <= 0
            # (grr/robot.py:455-461)
            zs = t[jnp.asarray(self.active_joints)][:, 2]
            ok = jnp.logical_and(ok, jnp.all(zs > 0.0))
        if self._spheres is not None:
            gs = self._spheres["self"]
            ge = self._spheres["ee"]
            ca = coll.transform_spheres(R[gs[0]], t[gs[0]], gs[1])
            cb = coll.transform_spheres(R[ge[0]], t[ge[0]], ge[1])
            hit = coll.sphere_group_collision(
                ca, gs[2], cb, ge[2], self._spheres["thresholds"]
            )
            ok = jnp.logical_and(ok, jnp.logical_not(hit))
        return ok

    def _validate_batch(self, configs):
        return jax.vmap(self._validate_device)(configs)

    @partial(jax.jit, static_argnums=0)
    def _self_collision_device(self, config):
        full = self._q_rest.at[self._active_idx].set(config)
        R, t = fk_all(self.model, full)
        gs, ge = self._spheres["self"], self._spheres["ee"]
        ca = coll.transform_spheres(R[gs[0]], t[gs[0]], gs[1])
        cb = coll.transform_spheres(R[ge[0]], t[ge[0]], ge[1])
        return coll.sphere_group_collision(
            ca, gs[2], cb, ge[2], self._spheres["thresholds"]
        )

    def check_self_collision_batch(self, qs):
        """(B, A) -> (B,) bool; the batched validity-scan primitive of the
        teleop benchmark (``experiment/utils.py:48-60`` loops this check
        per interpolated config)."""
        if self._spheres is None:
            return np.zeros(len(qs), dtype=bool)
        return np.asarray(
            jax.vmap(self._self_collision_device)(
                jnp.asarray(qs, dtype=jnp.float32)
            )
        )

    def check_self_collision(self, q):
        """True when the arm links collide with the end-effector group
        (grr/robot.py:381-392)."""
        if self._spheres is None:
            return False
        return bool(
            self._self_collision_device(jnp.asarray(q, dtype=jnp.float32))
        )


class KinematicChain(Robot):
    """Plain serial chain (``grr/robot.py:315-318``)."""


class Planar(Robot):
    """Planar N-R chains (planar_3.rob / planar_5.rob)."""

    EE_LINK_NAME = None  # last link


class Kinova(Robot):
    """Kinova Gen3 7-DoF (``grr/robot.py:321-392``)."""

    ACTIVE_JOINTS = [1, 2, 3, 4, 5, 6, 7]
    EE_LINK_NAME = "Tool_Frame"
    SELF_GEOMETRY_LINKS = [0, 1, 2]
    EE_GEOMETRY_LINKS = [
        "gripper:Link_0",
        "gripper:Link_1",
        "gripper:Link_2",
        "gripper:Link_3",
        "gripper:Link_4",
        "gripper:Link_5",
        "gripper:Link_6",
        "gripper:Link_7",
        "gripper:Link_8",
    ]


class UR10(Robot):
    """UR10 + Robotis RH-P12-RN gripper + D435 (``grr/robot.py:395-479``)."""

    ACTIVE_JOINTS = [1, 2, 3, 4, 5, 6]
    EE_LINK_NAME = "ee_link"
    SELF_GEOMETRY_LINKS = [0, 1, 2, 3, 4, 5]
    EE_GEOMETRY_LINKS = [
        "rh_p12_rn_base",
        "rh_p12_rn_l1",
        "rh_p12_rn_l2",
        "rh_p12_rn_r1",
        "rh_p12_rn_r2",
        "d435_link",
    ]
    FLOOR_CHECK = True

    @property
    def camera_link(self):
        """The d435_color_frame link index (main.py:59 uses the PyBullet
        equivalent, URDF link 15 == .rob link 12)."""
        return self.rob.link_index("d435_color_frame")


_ROBOT_CLASSES = {
    "UR10": UR10,
    "Kinova": Kinova,
    "KinematicChain": KinematicChain,
    "Planar": Planar,
}


def make_robot(opts: dict, floor_check: bool | None = None) -> Robot:
    """Instantiate from a problem dict (see io.config.load_problem), the
    equivalent of the reference's ``getattr(sys.modules, robot_class)``
    pattern (``redundancy.py:20-27``).

    ``floor_check`` (or an opts key of the same name) overrides the
    class default. The as-modified reference adds a floor check to
    ``UR10.solve_ik`` (``grr/robot.py:452-461``) but its SHIPPED
    ``graph/ur10/rot_fixed`` roadmap predates it (its own configs put
    wrist links below z=0) — artifact-parity builds pass
    ``floor_check=False``."""
    cls = _ROBOT_CLASSES[opts["robot_class"]]
    robot = cls(
        opts["robot_name"],
        opts["domain"],
        opts["rotation_domain"],
        opts.get("fixed_rotation"),
    )
    if floor_check is None:
        floor_check = opts.get("floor_check")
    if floor_check is not None:
        # instance attr shadows the class default; must be set before the
        # first _validate_device trace (jit treats self as static)
        robot.FLOOR_CHECK = bool(floor_check)
    return robot
