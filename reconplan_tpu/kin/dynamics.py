"""Servo-dynamics trajectory execution (the reference's physics-based
playback, ``main.py:218-234``: PyBullet POSITION_CONTROL motors stepped
at 240 Hz while the camera captures — executed joints LAG the command,
so executed-vs-planned tracking error is a real, measurable quantity).

A batched JAX redesign instead of a physics-engine port: the reference
scenes apply no external contacts during playback, so what its
``stepSimulation`` loop actually exercises is each joint's motor servo
— a velocity-clamped, acceleration-limited position regulator. That
regulator is modelled here directly and integrated with one
``lax.scan`` over sim ticks (one fused XLA dispatch for the whole
trajectory, vs 240 host steps/second), which keeps it batchable and
differentiable. Documented divergence: no link inertia coupling or
contact forces — per-joint servo limits are the binding constraint the
reference run exhibits.

Defaults follow the UR10's published joint limits (base/shoulder
2.09 rad/s, others 3.14 rad/s; accel ~= 5 rad/s^2 is the conservative
end of UR's 180-800 deg/s^2 envelope).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

UR10_VMAX = np.asarray([2.09, 2.09, 3.14, 3.14, 3.14, 3.14], np.float32)


@partial(jax.jit, static_argnames=("n_ticks", "hz"))
def _servo_scan(q0, qd0, times, ctraj, vmax, amax, kp, n_ticks, hz):
    """Integrate the per-joint position servo over ``n_ticks`` at
    ``hz``. Command = zero-order hold of the active waypoint (the
    reference holds each motor target until the waypoint's timestamp
    passes, ``main.py:218-234``)."""
    dt = 1.0 / hz

    def tick(state, i):
        q, qd = state
        t = i.astype(jnp.float32) * dt
        # active waypoint: first timestamp >= t (ZOH on its target)
        w = jnp.searchsorted(times, t, side="left")
        w = jnp.clip(w, 0, ctraj.shape[0] - 1)
        q_cmd = ctraj[w]
        # velocity-clamped position regulator (PyBullet POSITION_CONTROL
        # semantics: drive toward target at <= maxVelocity), with a slew
        # limit standing in for finite motor force
        qd_des = jnp.clip(kp * (q_cmd - q), -vmax, vmax)
        qd_new = qd + jnp.clip(qd_des - qd, -amax * dt, amax * dt)
        q_new = q + qd_new * dt
        return (q_new, qd_new), (q_new, qd_new)

    (_qf, _qdf), (qs, qds) = jax.lax.scan(
        tick, (q0, qd0), jnp.arange(n_ticks, dtype=jnp.int32)
    )
    return qs, qds


class ServoExecutor:
    """Execute a timestamped joint trajectory through servo dynamics.

    ``execute(times, ctraj)`` -> dict with the 240 Hz executed trace,
    the executed config at each waypoint timestamp, and tracking-error
    statistics (joint-space and, when a robot is given, workspace EE
    deviation via FK) — the quantities the reference's physics playback
    makes observable.
    """

    def __init__(self, robot=None, hz=240, vmax=None, amax=5.0, kp=8.0):
        self.robot = robot
        self.hz = int(hz)
        if vmax is None:
            n = robot.num_joints if robot is not None else 6
            vmax = UR10_VMAX[:n] if n <= 6 else np.full(n, 3.14, np.float32)
        self.vmax = np.asarray(vmax, np.float32)
        self.amax = float(amax)
        self.kp = float(kp)

    def execute(self, times, ctraj, q0=None, qd0=None):
        times = np.asarray(times, np.float32)
        ctraj = np.asarray(ctraj, np.float32)
        if q0 is None:
            q0 = ctraj[0]
        q0 = np.asarray(q0, np.float32)
        qd0 = (np.zeros_like(q0) if qd0 is None
               else np.asarray(qd0, np.float32))
        n_ticks = int(np.ceil(float(times[-1]) * self.hz)) + 1
        # pad tick count to the next power of two: ONE compile per
        # trajectory-length bucket instead of one per length
        n_pad = 1 << int(np.ceil(np.log2(max(n_ticks, 8))))
        qs, qds = _servo_scan(
            jnp.asarray(q0), jnp.asarray(qd0),
            jnp.asarray(times), jnp.asarray(ctraj),
            jnp.asarray(self.vmax), self.amax, self.kp, n_pad, self.hz,
        )
        qs = np.asarray(qs)[:n_ticks]
        qds = np.asarray(qds)[:n_ticks]
        # executed config at each waypoint timestamp
        idx = np.minimum((times * self.hz).astype(np.int64), n_ticks - 1)
        q_at_wp = qs[idx]
        err = np.abs(q_at_wp - ctraj)
        out = {
            "q_ticks": qs,
            "qd_ticks": qds,
            "q_at_waypoints": q_at_wp,
            "joint_err_max": float(err.max()) if err.size else 0.0,
            "joint_err_mean": float(err.mean()) if err.size else 0.0,
        }
        if self.robot is not None:
            ee_exec = np.asarray(self.robot.fk_point_batch(q_at_wp))[:, :3]
            ee_plan = np.asarray(self.robot.fk_point_batch(ctraj))[:, :3]
            d = np.linalg.norm(ee_exec - ee_plan, axis=-1)
            out["ee_err_max_mm"] = float(d.max() * 1e3) if d.size else 0.0
            out["ee_err_mean_mm"] = float(d.mean() * 1e3) if d.size else 0.0
        return out
