"""Kinematics: chain models, FK/Jacobian, batched DLS-IK, collision.

JAX replacement for the reference's two C++ robot-model backends —
Klampt (``Expansion-GRR/grr/robot.py``) and PyBullet
(``Expansion-GRR/bullet_api/robot.py``). One pure-JAX kinematic core serves
both roles: FK/Jacobians are closed-form over the parsed ``.rob`` chain,
IK is damped-least-squares under ``lax.while_loop`` and batches with
``vmap`` (the reference called into C++ once per IK solve; here thousands of
solves run per device dispatch).
"""

from reconplan_tpu.kin.rob_parser import RobModel, parse_rob
from reconplan_tpu.kin.chain import KinematicModel, fk_all, fk_link, geometric_jacobian
from reconplan_tpu.kin.ik import IKResult, dls_ik, dls_ik_batch
from reconplan_tpu.kin.collision import (
    Capsule,
    fit_capsule_off,
    capsule_group_collision,
    fit_spheres_off,
    sphere_group_clearance,
    sphere_group_collision,
)
from reconplan_tpu.kin.robot import Robot, UR10, Kinova, KinematicChain, Planar, make_robot
from reconplan_tpu.kin.dynamics import ServoExecutor

__all__ = [
    "ServoExecutor",
    "RobModel",
    "parse_rob",
    "KinematicModel",
    "fk_all",
    "fk_link",
    "geometric_jacobian",
    "IKResult",
    "dls_ik",
    "dls_ik_batch",
    "Capsule",
    "fit_capsule_off",
    "capsule_group_collision",
    "fit_spheres_off",
    "sphere_group_clearance",
    "sphere_group_collision",
    "Robot",
    "UR10",
    "Kinova",
    "KinematicChain",
    "Planar",
    "make_robot",
]
