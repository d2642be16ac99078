"""Device-batched teleop trajectory-quality benchmark engine.

The reference's headline experiment
(``Expansion-GRR/experiment/trajectory_quality.py:147-199``) tracks each
trajectory tick-by-tick in a host loop — 100 trajectories x 4 kinds x 4
solver arms x ~300 ticks of one-at-a-time IK/continuity calls, each a
host round trip.

Here ALL N trajectories of a kind advance one tick per device dispatch
(the ``solve_batch`` pattern of ``resolution.py:251`` applied ACROSS
trajectories instead of along one path):

  * one batched tracking solve per tick (roadmap SE3 top-k -> joint-space
    closest seed -> LM-IK -> floor/collision validity), mirroring
    ``resolution.solve`` tracking mode (``resolution.py:299-330``);
  * one batched fixed-depth bisection continuity check per tick
    (``ExpansionSolver.is_continuous_batch``);
  * the teleop fallback state machines — roadmap path-following on
    discontinuity and the nearest-node rescue on solve failure
    (``resolution.py:171-213``) — stay host-side per trajectory, but their
    continuity primitives batch over whichever trajectories need them.

Solver-arm semantics are the reference's, quirks included:
  * every arm cold-starts from ``resolution.solve(traj[0])`` and is marked
    failed outright when start OR end has no resolution solution
    (``trajectory_quality.py:72-80``);
  * the Newton arm steps toward the raw IK result whether or not it
    converged (``resolution.solve(..., regular_ik=True)`` with
    ``none_on_fail=False``, ``trajectory_quality.py:40-44``);
  * exactly ``converge_steps`` extra ticks at the goal, no early exit
    (``trajectory_quality.py:48-56``).
"""

from __future__ import annotations

import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from reconplan_tpu.core import maths
from reconplan_tpu.kin.ik import dls_ik_batch
from reconplan_tpu.ops.nn import se3_pairwise


# ---------------------------------------------------------------------------
# batched per-tick primitives
# ---------------------------------------------------------------------------


def _pow2(n, lo=4):
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def make_tracking_solver(resolution, max_iters=100, tolerance=1e-3, n_seeds=4):
    """Jitted ``(targets (N, D), qs (N, A)) -> (q (N, A), ok (N,))``
    implementing :meth:`RedundancyResolution.solve` tracking mode for N
    independent trajectories in one dispatch.

    Multi-seed divergence as in :meth:`RedundancyResolution.solve_batch`:
    the ``n_seeds`` joint-closest roadmap configs run as parallel IK
    restarts and the valid result with minimal joint motion wins."""
    robot = resolution.robot
    road_pts = jnp.asarray(resolution.points)
    road_cfg = jnp.asarray(resolution.configs)
    k = min(resolution.workspace.interpolate_num_neighbors, len(resolution.points))
    j = max(1, min(n_seeds, k))

    @jax.jit
    def solve_many(targets, qs):
        pts = jnp.asarray(targets, dtype=jnp.float32)
        if pts.shape[1] > 3:
            pts = pts.at[:, 3:7].set(
                pts[:, 3:7] / jnp.linalg.norm(pts[:, 3:7], axis=-1, keepdims=True)
            )
        pos, rotm, use_rot = robot._ik_targets(pts)
        qpts = pts[:, :3] if road_pts.shape[1] == 3 else pts
        d = se3_pairwise(qpts, road_pts)  # (N, M)
        _, idx = jax.lax.top_k(-d, k)  # (N, k)
        cfgs = road_cfg[idx]  # (N, k, A)
        jd = robot.distance_batch(qs[:, None, :], cfgs)  # (N, k)
        _, sidx = jax.lax.top_k(-jd, j)  # (N, j)
        seeds = jnp.take_along_axis(cfgs, sidx[:, :, None], axis=1)  # (N, j, A)
        N, A = qs.shape
        res = dls_ik_batch(
            robot.model, robot._active_tuple, robot.ee_link,
            jnp.repeat(pos, j, axis=0),
            jnp.repeat(rotm, j, axis=0),
            seeds.reshape(N * j, A), robot._q_rest,
            max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
        )
        q = jnp.where(robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config)
        valid = robot._validate_batch(q)
        okj = jnp.logical_and(res.success, valid).reshape(N, j)
        q = q.reshape(N, j, A)
        dq = jnp.where(okj, robot.distance_batch(qs[:, None, :], q), jnp.inf)
        best = jnp.argmin(dq, axis=1)
        q = jnp.take_along_axis(q, best[:, None, None], axis=1)[:, 0]
        ok = jnp.take_along_axis(okj, best[:, None], axis=1)[:, 0]
        return q, ok

    return solve_many


def make_grr_tick(resolution, target_dim, max_iters=100, tolerance=1e-3,
                  greedy_seed=False):
    """ONE fused jitted dispatch per GRR teleop tick.

    ``greedy_seed=True`` adds the CURRENT config as one more IK restart
    alongside the roadmap seeds (reference GRR seeds from the roadmap
    only, ``resolution.py:299-330``; a documented divergence for the
    round-5 DTW-gap experiment): when the greedy continuous branch is
    valid it wins the min-joint-motion selection and tracks as tightly
    as the Newton arm, while the roadmap seeds still carry the rows
    where greedy tracking fails.

    Folds the tracking solve, the FK of the current configs, and an
    inline fixed-depth-3 bisection continuity check (the regime that
    covers every smooth tracking tick: config distance <= 7*eps ~ 0.86
    rad) into a single XLA computation. Rows whose config distance needs
    a deeper subdivision come back flagged ``deep`` and re-check through
    the full :meth:`ExpansionSolver.is_continuous_batch` on host — by
    then they are discontinuity candidates anyway (measured: depth<=2
    left ~36% of kinova tracking ticks deep because the multi-seed solve
    occasionally returns a farther valid basin; level 3 makes the deep
    path rare enough for the block-scan driver to stay on device).

    Returns ``tick(targets (N, D), qs (N, A)) ->
    (q_t, ok, curr_pts (N, target_dim), cont, deep)``.
    """
    from reconplan_tpu.grr.solver import (
        _interp_config_batch,
        _interp_point_batch,
    )

    robot = resolution.robot
    road_pts = jnp.asarray(resolution.points)
    road_cfg = jnp.asarray(resolution.configs)
    k = min(resolution.workspace.interpolate_num_neighbors, len(resolution.points))
    A = robot.num_joints
    eps = float(np.sqrt(A) * 5e-2)  # solver.py:318
    deviation = 1.8  # solver.py:317

    def _ik(pts, seeds):
        pos, rotm, use_rot = robot._ik_targets(pts)
        res = dls_ik_batch(
            robot.model, robot._active_tuple, robot.ee_link,
            pos, rotm, seeds, robot._q_rest,
            max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
        )
        q = jnp.where(robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config)
        valid = robot._validate_batch(q)
        return q, jnp.logical_and(res.success, valid)

    @jax.jit
    def tick(targets, qs):
        pts = jnp.asarray(targets, dtype=jnp.float32)
        if target_dim > 3:
            pts = pts.at[:, 3:7].set(
                pts[:, 3:7] / jnp.linalg.norm(pts[:, 3:7], axis=-1, keepdims=True)
            )
        qs32 = jnp.asarray(qs, dtype=jnp.float32)

        # tracking solve (resolution.py:299-330), multi-seed restarts as
        # in RedundancyResolution.solve_batch
        qpts = pts[:, :3] if road_pts.shape[1] == 3 else pts
        d = se3_pairwise(qpts, road_pts)
        _, idx = jax.lax.top_k(-d, k)
        cfgs = road_cfg[idx]
        jd = robot.distance_batch(qs32[:, None, :], cfgs)
        j = max(1, min(4, k))
        _, sidx = jax.lax.top_k(-jd, j)
        seeds = jnp.take_along_axis(cfgs, sidx[:, :, None], axis=1)
        if greedy_seed:
            seeds = jnp.concatenate([qs32[:, None, :], seeds], axis=1)
            j = j + 1
        Nr, A_ = qs32.shape
        q_j, ok_j = _ik(
            jnp.repeat(pts, j, axis=0), seeds.reshape(Nr * j, A_)
        )
        q_j = q_j.reshape(Nr, j, A_)
        ok_j = ok_j.reshape(Nr, j)
        dq_j = jnp.where(
            ok_j, robot.distance_batch(qs32[:, None, :], q_j), jnp.inf
        )
        best = jnp.argmin(dq_j, axis=1)
        q_t = jnp.take_along_axis(q_j, best[:, None, None], axis=1)[:, 0]
        ok = jnp.take_along_axis(ok_j, best[:, None], axis=1)[:, 0]

        # current workspace points
        ee = robot.fk_point_batch(qs32)  # (N, 7)
        curr_pts = ee[:, :target_dim]

        # inline continuity, S=4 segments (solver.py:304-363 semantics)
        dist = robot.distance_batch(qs32, q_t)
        n_divs = jnp.ceil(dist / eps).astype(jnp.int32)
        depth = jnp.ceil(jnp.log2(jnp.maximum(n_divs + 1, 1).astype(jnp.float32)))
        depth = depth.astype(jnp.int32)
        deep = depth > 3

        cont = jnp.ones(qs32.shape[0], dtype=bool)
        Q0, Q4 = qs32, q_t
        # level 0: midpoint at u=0.5
        u_l0 = jnp.asarray([0.5], dtype=jnp.float32)
        seeds0 = _interp_config_batch(
            Q0[:, None, :], Q4[:, None, :], 0.5, robot._cyclic_mask
        )[:, 0]
        t0 = _interp_point_batch(curr_pts, pts[:, :target_dim], u_l0)[:, 0]
        qm2, v2 = _ik(t0, seeds0)
        d_seg = robot.distance_batch(Q0, Q4)
        ok0 = (
            v2
            & (robot.distance_batch(Q0, qm2) <= deviation * d_seg)
            & (robot.distance_batch(qm2, Q4) <= deviation * d_seg)
        )
        cont = jnp.where(depth > 0, cont & ok0, cont)

        # level 1: midpoints at u=0.25, 0.75
        u_l1 = jnp.asarray([0.25, 0.75], dtype=jnp.float32)
        qa = jnp.stack([Q0, qm2], axis=1)  # (N, 2, A)
        qb = jnp.stack([qm2, Q4], axis=1)
        seeds1 = _interp_config_batch(qa, qb, 0.5, robot._cyclic_mask)
        t1 = _interp_point_batch(curr_pts, pts[:, :target_dim], u_l1)
        N = qs32.shape[0]
        qm13, v13 = _ik(
            t1.reshape(N * 2, -1), seeds1.reshape(N * 2, A)
        )
        qm13 = qm13.reshape(N, 2, A)
        v13 = v13.reshape(N, 2)
        ds = robot.distance_batch(qa, qb)
        d1 = robot.distance_batch(qa, qm13)
        d2 = robot.distance_batch(qm13, qb)
        ok1 = (v13 & (d1 <= deviation * ds) & (d2 <= deviation * ds)).all(axis=1)
        cont = jnp.where(depth > 1, cont & ok1, cont)

        # level 2: midpoints of the four level-1 segments
        # (u = 0.125, 0.375, 0.625, 0.875)
        u_l2 = jnp.asarray([0.125, 0.375, 0.625, 0.875], dtype=jnp.float32)
        qa2 = jnp.stack([Q0, qm13[:, 0], qm2, qm13[:, 1]], axis=1)  # (N,4,A)
        qb2 = jnp.stack([qm13[:, 0], qm2, qm13[:, 1], Q4], axis=1)
        seeds2 = _interp_config_batch(qa2, qb2, 0.5, robot._cyclic_mask)
        t2 = _interp_point_batch(curr_pts, pts[:, :target_dim], u_l2)
        qm2l, v2l = _ik(t2.reshape(N * 4, -1), seeds2.reshape(N * 4, A))
        qm2l = qm2l.reshape(N, 4, A)
        v2l = v2l.reshape(N, 4)
        ds2 = robot.distance_batch(qa2, qb2)
        d1_2 = robot.distance_batch(qa2, qm2l)
        d2_2 = robot.distance_batch(qm2l, qb2)
        ok2 = (
            v2l & (d1_2 <= deviation * ds2) & (d2_2 <= deviation * ds2)
        ).all(axis=1)
        cont = jnp.where(depth > 2, cont & ok2, cont)

        return q_t, ok, curr_pts, cont, deep

    return tick


def make_plan_helper(resolution, max_iters=100, tolerance=1e-3):
    """Device-batched ``resolution.plan(..., interpolation=1)`` for the
    teleop discontinuity fallback (``resolution.py:435-517``).

    The reference's plan() issues ~64 recursive host ``solve`` calls per
    invocation (4 candidate entry nodes x 8 interpolated feasibility
    solves per endpoint, then one re-solve per path segment) — measured
    ~20 s each over a host-looped runtime, and the teleop tick retries a
    failed plan EVERY tick. Here the 2x4x8 entry-feasibility solves run as
    ONE roadmap-seeded IK dispatch, the shortest path comes from the
    native Dijkstra, and the interpolation=1 segment re-solves collapse to
    the roadmap configs themselves (solve() at a roadmap node is the
    exact-node match, ``resolution.py:313-318``). Documented divergence:
    entry feasibility seeds IK from the nearest roadmap config instead of
    the reference's recursive cold solve — same accept intent, fixed
    dispatch count."""
    robot = resolution.robot
    road_pts = jnp.asarray(resolution.points)
    road_cfg = jnp.asarray(resolution.configs)

    @jax.jit
    def solve_points(pts):
        pts = jnp.asarray(pts, dtype=jnp.float32)
        pos, rotm, use_rot = robot._ik_targets(pts)
        qpts = pts[:, :3] if road_pts.shape[1] == 3 else pts
        d = se3_pairwise(qpts, road_pts)
        seeds = road_cfg[jnp.argmin(d, axis=1)]
        res = dls_ik_batch(
            robot.model, robot._active_tuple, robot.ee_link,
            pos, rotm, seeds, robot._q_rest,
            max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
        )
        q = jnp.where(robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config)
        valid = robot._validate_batch(q)
        return q, jnp.logical_and(res.success, valid)

    n_div = 8  # resolution.py:448-474 num_div
    k_entry = min(4, len(resolution.points))

    def plan_fast(curr_pt, target_pt, q_goal):
        """-> (T, A) config path [q(curr), roadmap configs..., q_goal] or
        None when no feasible entry/path exists."""
        pts2 = np.stack(
            [np.asarray(curr_pt, dtype=np.float32),
             np.asarray(target_pt, dtype=np.float32)]
        )
        nbrs = resolution.workspace.get_workspace_neighbors(
            pts2, k=k_entry, points=resolution.points
        )  # (2, k)
        subs = []
        for e in range(2):
            for n in nbrs[e]:
                node_pt = resolution.points[int(n)]
                for kk in range(n_div):
                    subs.append(
                        robot.workspace_interpolate(
                            pts2[e], node_pt, kk / n_div
                        )
                    )
        subs = np.asarray(subs, dtype=np.float32)
        _q, ok = solve_points(jnp.asarray(subs))
        ok = np.asarray(ok).reshape(2, k_entry, n_div)
        entry = [None, None]
        for e in range(2):
            for c in range(k_entry):
                if ok[e, c].all():
                    entry[e] = int(nbrs[e][c])
                    break
        if entry[0] is None or entry[1] is None:
            return None
        path = resolution._dijkstra(entry[0], entry[1])
        if path is None:
            return None
        c_path = [resolution.configs[p].astype(np.float64) for p in path]
        c_path.append(np.asarray(q_goal, dtype=np.float64))
        return np.asarray(c_path)

    return plan_fast


def make_newton_solver(robot, max_iters=100, tolerance=1e-3):
    """Jitted plain-IK tick: seeds from the current configs, returns the
    raw LM-IK result regardless of convergence (reference Newton-arm
    semantics)."""

    @jax.jit
    def solve_many(targets, qs):
        pts = jnp.asarray(targets, dtype=jnp.float32)
        pos, rotm, use_rot = robot._ik_targets(pts)
        res = dls_ik_batch(
            robot.model, robot._active_tuple, robot.ee_link,
            pos, rotm, qs, robot._q_rest,
            max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
        )
        q = jnp.where(robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config)
        return q

    return solve_many


def step_toward_batch(robot, qs, targets, max_change):
    """Vectorized ``teleop_towards`` (``resolution.py:215-228``): clamped
    shortest-path step of each row toward its target config."""
    qs = np.asarray(qs, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    cyc = np.asarray(robot._cyclic_mask)
    diff = targets - qs
    diff = np.where(cyc, np.mod(diff + np.pi, 2 * np.pi) - np.pi, diff)
    m = np.abs(diff).max(axis=1)
    u = np.where(m < max_change, 1.0, max_change / np.maximum(m, 1e-12))
    out = qs + u[:, None] * diff
    out = np.where(cyc, np.mod(out + np.pi, 2 * np.pi) - np.pi, out)
    return out


def _fk_points_batch(robot, qs):
    """Current workspace points of a config batch, dimensioned like the
    trajectory targets (pos-only unless the robot tracks rotation)."""
    pts = np.asarray(robot.fk_point_batch(np.asarray(qs, dtype=np.float32)))
    if robot.rotation != "variable":
        return pts[:, :3]
    return pts


# ---------------------------------------------------------------------------
# arms
# ---------------------------------------------------------------------------


def grr_teleop_batch(
    resolution, trajs, q0s, alive, max_change=0.04, converge_steps=100,
    verbose=False, greedy_seed=False,
):
    """Track N same-length trajectories with GRR teleop, ticks batched.

    Device-resident engine: the config state AND the config-history
    buffer live on device across the whole loop; each tick is ONE jitted
    dispatch (tracking solve + inline continuity + smooth step + history
    commit) plus ONE packed readback of the per-row flags, where the
    previous host-resident loop paid ~7 array round trips per tick. Rows
    that need the teleop fallback state machines (roadmap plan-following
    / nearest-node rescue, ``resolution.py:171-213``) are repaired on
    host and surgically written back into the device state through a
    size-bucketed row-update dispatch.

    Args:
        resolution: loaded RedundancyResolution.
        trajs: (N, T, D) workspace trajectories.
        q0s: (N, A) start configs (from cold resolution.solve).
        alive: (N,) bool — rows with a valid start/end resolution solution.

    Returns list of N (T_i, A) config trajectories ([] where not alive),
    plus a dict of fallback-path statistics.
    """
    robot = resolution.robot
    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    A = q0s.shape[1]
    total = T + converge_steps
    tick = make_grr_tick(resolution, D, greedy_seed=greedy_seed)
    plan_fast = make_plan_helper(resolution)

    def _tick_body(traj_seq, qs, hist, t):
        """One tick: solve, check, auto-step the smooth rows, write
        hist[t+1]. Rows that are NOT plainly smooth keep their config
        (host repairs them). Returns packed per-row info for the host:
        [ok, cont, deep, q_t (A), curr_pts (D)] as one f32 array."""
        targets = traj_seq[jnp.minimum(t, T - 1)]
        q_t, ok, curr_pts, cont, deep = tick(targets, qs.astype(jnp.float32))
        smooth = ok & cont & ~deep
        stepped = _step_toward_j(robot, qs, q_t, max_change)
        qs = jnp.where(smooth[:, None], stepped, qs)
        hist = hist.at[t + 1].set(qs)
        packed = jnp.concatenate(
            [
                ok[:, None].astype(jnp.float32),
                cont[:, None].astype(jnp.float32),
                deep[:, None].astype(jnp.float32),
                q_t.astype(jnp.float32),
                curr_pts.astype(jnp.float32),
            ],
            axis=1,
        )
        return qs, hist, t + 1, packed

    tick_commit = jax.jit(_tick_body)

    S = 16  # ticks per fused device block (see driver below)

    @jax.jit
    def tick_block(traj_seq, qs, hist, t):
        """S ticks in ONE dispatch (lax.scan over _tick_body). The host
        accepts the block iff every tick was all-smooth for the alive
        rows; otherwise it replays the block tick-by-tick from the
        (immutable) pre-block state, so smooth regimes pay one host round
        trip per S ticks instead of one per tick."""

        def body(carry, _):
            qs, hist, t = carry
            qs, hist, t, packed = _tick_body(traj_seq, qs, hist, t)
            return (qs, hist, t), packed

        (qs, hist, t), packed = jax.lax.scan(
            body, (qs, hist, t), None, length=S
        )
        return qs, hist, t, packed  # packed (S, N, 3+A+D)

    @jax.jit
    def write_rows(qs, hist, t, idx, vals, mask):
        """Host-repaired rows -> device state (t already incremented:
        the rows land in hist[t])."""
        vals = jnp.where(mask[:, None], vals, qs[idx])
        qs = qs.at[idx].set(vals)
        hist = hist.at[t, idx].set(vals)
        return qs, hist

    qs_d = jnp.asarray(q0s)
    hist_d = jnp.zeros((total + 1, N, A), qs_d.dtype).at[0].set(qs_d)
    t_d = jnp.int32(0)
    traj_seq = jnp.asarray(np.swapaxes(trajs, 0, 1), dtype=jnp.float32)

    plan_path = [None] * N
    plan_idx = [0] * N
    stats = {"ticks": 0, "continuous": 0, "plan_follow": 0, "rescue": 0,
             "stuck": 0, "deep_recheck": 0, "blocks": 0, "block_replays": 0}
    # per-tick workspace deviation |ee - target| (position, meters),
    # attributed to the regime that handled the row that tick — the
    # round-4 VERDICT asks where GRR's DTW gap vs Newton comes from
    # (smooth tracking vs fallback-detour ticks)
    dev = {c: [0.0, 0] for c in ("smooth", "plan", "rescue", "stuck")}

    def _dev_add(cls, dists):
        dev[cls][0] += float(np.sum(dists))
        dev[cls][1] += int(np.size(dists))

    n_alive = int(alive.sum())
    streak = S  # optimistic: try a block first
    t = 0
    t_start = time.time()
    last_beat = t_start
    while t < total:
        # wall-time heartbeat: fallback-surgery regions can take seconds
        # per tick, so tick-count-gated prints alone can go silent for
        # over an hour (round-3 weak #7) — emit progress every 30 s
        if verbose and time.time() - last_beat > 30:
            last_beat = time.time()
            print(f"  [heartbeat] tick {t}/{total} "
                  f"elapsed {last_beat - t_start:.0f}s "
                  f"rescue={stats['rescue']} plan={stats['plan_follow']} "
                  f"stuck={stats['stuck']} deep={stats['deep_recheck']}",
                  flush=True)
        # ---- fused S-tick block when the recent regime is smooth ----
        if streak >= S and t + S <= total:
            stats["blocks"] += 1
            qs_b, hist_b, t_b, packed_b = tick_block(
                traj_seq, qs_d, hist_d, t_d
            )
            packed_b = np.asarray(packed_b)  # (S, N, C) one readback
            okb = (packed_b[..., 0] > 0.5) & alive[None, :]
            contb = packed_b[..., 1] > 0.5
            deepb = packed_b[..., 2] > 0.5
            smoothb = okb & contb & ~deepb
            if bool((smoothb | ~alive[None, :]).all()):
                qs_d, hist_d, t_d = qs_b, hist_b, t_b
                stats["ticks"] += S * n_alive
                stats["continuous"] += S * n_alive
                tgt_b = trajs[:, np.minimum(np.arange(t, t + S), T - 1), :3]
                cp_b = packed_b[..., 3 + A : 3 + A + 3]  # (S, N, 3)
                _dev_add("smooth", np.linalg.norm(
                    np.swapaxes(cp_b, 0, 1)[alive] - tgt_b[alive], axis=-1
                ))
                for i in np.flatnonzero(alive):
                    plan_path[i] = None
                    plan_idx[i] = 0
                if verbose and (t // S) % 4 == 0:
                    print(f"  tick {t}/{total}  smooth {n_alive}/{n_alive} "
                          "(block)")
                t += S
                continue
            # block had a non-smooth tick: discard (pre-block state refs
            # are untouched) and replay per tick
            stats["block_replays"] += 1
            streak = 0

        qs_d, hist_d, t_d, packed = tick_commit(traj_seq, qs_d, hist_d, t_d)
        packed = np.asarray(packed)  # ONE small readback per tick
        ok = packed[:, 0] > 0.5
        cont = packed[:, 1] > 0.5
        deep = packed[:, 2] > 0.5
        q_t = packed[:, 3 : 3 + A].astype(np.float64)
        curr_pts = packed[:, 3 + A :].astype(np.float64)
        ok &= alive
        smooth_auto = ok & cont & ~deep
        stats["ticks"] += int(alive.sum())
        stats["continuous"] += int(smooth_auto.sum())
        tick_dev = np.linalg.norm(
            curr_pts[:, :3] - trajs[:, min(t, T - 1), :3], axis=-1
        )
        _dev_add("smooth", tick_dev[smooth_auto])
        # rows auto-stepped on device drop any plan state
        for i in np.flatnonzero(smooth_auto):
            plan_path[i] = None
            plan_idx[i] = 0

        attention = np.flatnonzero(alive & ~smooth_auto)
        if len(attention) == 0:
            if verbose and t % 50 == 0:
                print(f"  tick {t}/{total}  smooth {int(smooth_auto.sum())}"
                      f"/{int(alive.sum())}")
            t += 1
            streak += 1
            continue
        streak = 0

        # ---- host surgery for the rows the device didn't step ----
        qs_host = np.asarray(qs_d, dtype=np.float64)
        targets = trajs[:, min(t, T - 1)]

        cont = cont.copy()
        deep_rows = np.flatnonzero(deep & ok)
        if len(deep_rows):
            stats["deep_recheck"] += len(deep_rows)
            cont[deep_rows] = np.asarray(
                resolution.solver.is_continuous_batch(
                    qs_host[deep_rows], q_t[deep_rows],
                    curr_pts[deep_rows], targets[deep_rows],
                )
            )

        new_rows = {}
        rescue_rows = []
        for i in attention:
            if ok[i] and cont[i]:
                # deep row re-checked continuous: take the smooth step
                plan_path[i] = None
                plan_idx[i] = 0
                new_rows[i] = step_toward_batch(
                    robot, qs_host[i][None], q_t[i][None], max_change
                )[0]
                stats["continuous"] += 1
                _dev_add("smooth", tick_dev[i])
            elif ok[i]:
                # discontinuity: follow a roadmap plan
                # (resolution.py:171-195)
                stats["plan_follow"] += 1
                _dev_add("plan", tick_dev[i])
                if plan_path[i] is None:
                    c_path = plan_fast(curr_pts[i], targets[i], q_t[i])
                    if c_path is not None and len(c_path) > 1:
                        plan_path[i] = np.asarray(c_path, dtype=np.float64)
                        plan_idx[i] = 1
                        new_rows[i] = step_toward_batch(
                            robot, qs_host[i][None], plan_path[i][1][None],
                            max_change,
                        )[0]
                    else:
                        stats["stuck"] += 1
                else:
                    plan_idx[i] += 1
                    if plan_idx[i] < len(plan_path[i]):
                        new_rows[i] = step_toward_batch(
                            robot, qs_host[i][None],
                            plan_path[i][plan_idx[i]][None], max_change,
                        )[0]
                    else:
                        plan_path[i] = None
                        plan_idx[i] = 0
            else:
                rescue_rows.append(int(i))

        if rescue_rows:
            # solve-failure fallback: nearest 5 roadmap nodes, first whose
            # config is continuous from here (resolution.py:197-213)
            stats["rescue"] += len(rescue_rows)
            _dev_add("rescue", tick_dev[rescue_rows])
            F = len(rescue_rows)
            Fp = _pow2(F)
            rows = rescue_rows + [rescue_rows[-1]] * (Fp - F)
            nbrs = resolution.workspace.get_workspace_neighbors(
                targets[rows].astype(np.float32),
                k=min(5, len(resolution.points)), points=resolution.points,
            )  # (Fp, 5)
            K5 = nbrs.shape[1]
            qn = resolution.configs[nbrs.reshape(-1)]  # (Fp*5, A)
            pn = resolution.points[nbrs.reshape(-1)]
            qrep = np.repeat(qs_host[rows], K5, axis=0)
            prep = np.repeat(curr_pts[rows], K5, axis=0)
            cont5 = np.asarray(
                resolution.solver.is_continuous_batch(qn, qrep, pn, prep)
            ).reshape(Fp, K5)
            for r, i in enumerate(rescue_rows):
                hit = np.flatnonzero(cont5[r])
                if len(hit):
                    new_rows[i] = step_toward_batch(
                        robot, qs_host[i][None],
                        resolution.configs[nbrs[r, hit[0]]][None].astype(
                            np.float64
                        ),
                        max_change,
                    )[0]
                else:
                    stats["stuck"] += 1

        if new_rows:
            idx = np.fromiter(new_rows.keys(), dtype=np.int64)
            vals = np.stack([new_rows[i] for i in idx])
            for i, v in zip(idx, vals):
                qs_host[i] = v
            P = _pow2(len(idx))
            mask = np.arange(P) < len(idx)
            idx_p = np.pad(idx, (0, P - len(idx)), mode="edge")
            vals_p = np.pad(vals, ((0, P - len(vals)), (0, 0)), mode="edge")
            qs_d, hist_d = write_rows(
                qs_d, hist_d, t_d,
                jnp.asarray(idx_p), jnp.asarray(vals_p, dtype=qs_d.dtype),
                jnp.asarray(mask),
            )
        if verbose and t % 50 == 0:
            print(f"  tick {t}/{total}  smooth "
                  f"{int(smooth_auto.sum()) + sum(1 for i in attention if ok[i] and cont[i])}"
                  f"/{int(alive.sum())}")
        t += 1

    hist = np.asarray(hist_d, dtype=np.float64)  # one readback at the end
    c_trajs = [
        hist[:, i] if alive[i] else np.zeros((0, A)) for i in range(N)
    ]
    stats["deviation_by_class_mm"] = {
        c: (round(1000.0 * s / n, 3) if n else None)
        for c, (s, n) in dev.items()
    }
    stats["deviation_ticks"] = {c: n for c, (s, n) in dev.items()}
    return c_trajs, stats


def _step_toward_j(robot, qs, targets, max_change):
    """Traceable ``teleop_towards`` (``resolution.py:215-228``)."""
    cyc = robot._cyclic_mask
    diff = targets - qs
    diff = jnp.where(cyc, jnp.mod(diff + jnp.pi, 2 * jnp.pi) - jnp.pi, diff)
    m = jnp.max(jnp.abs(diff), axis=-1)
    u = jnp.where(m < max_change, 1.0, max_change / jnp.maximum(m, 1e-12))
    out = qs + u[..., None] * diff
    return jnp.where(cyc, jnp.mod(out + jnp.pi, 2 * jnp.pi) - jnp.pi, out)


def newton_teleop_batch(robot, trajs, q0s, alive, max_change=0.04,
                        converge_steps=100):
    """Plain-IK tracking arm (reference ``newton_teleop_solver``
    semantics: step toward the raw IK result).

    The entire T+converge tick loop runs as ONE ``lax.scan`` dispatch —
    the Newton arm has no host-side fallback state machine, so nothing
    requires a per-tick host round trip."""
    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    total = T + converge_steps

    @jax.jit
    def run(traj_seq, q0):
        def tick(qs, targets):
            pts = jnp.asarray(targets, dtype=jnp.float32)
            pos, rotm, use_rot = robot._ik_targets(pts)
            res = dls_ik_batch(
                robot.model, robot._active_tuple, robot.ee_link,
                pos, rotm, qs.astype(jnp.float32), robot._q_rest,
                max_iters=100, tolerance=1e-3, use_rotation=use_rot,
            )
            q_t = jnp.where(
                robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config
            ).astype(jnp.float32)
            qs = _step_toward_j(robot, qs, q_t, max_change)
            return qs, qs

        idx = jnp.minimum(jnp.arange(total), T - 1)
        _, hist = jax.lax.scan(tick, q0, traj_seq[idx])
        return hist  # (total, N, A)

    hist = np.asarray(
        run(jnp.asarray(np.swapaxes(trajs, 0, 1)),
            jnp.asarray(q0s, dtype=jnp.float32))
    )
    return [
        np.concatenate([q0s[i][None], hist[:, i]]) if alive[i]
        else np.zeros((0, q0s.shape[1]))
        for i in range(N)
    ]


def relaxed_teleop_batch(robot, trajs, q0s, alive, max_change=0.04,
                         converge_steps=100):
    """RelaxedIK arm — like the Newton arm, the whole tick loop is ONE
    ``lax.scan`` dispatch (vmapped ``_relaxed_step`` per tick, no host
    state)."""
    from reconplan_tpu.kin.relaxed import _relaxed_step

    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    total = T + converge_steps
    weights = jnp.asarray([50.0, 10.0, 1.0, 1.0], dtype=jnp.float32)

    if robot.rotation == "fixed" and robot.fixed_rotation is not None:
        fixed_quat = np.asarray(robot.fixed_rotation, dtype=np.float32)
    else:
        fixed_quat = np.asarray([0, 0, 0, 1], dtype=np.float32)

    step_many = jax.vmap(
        lambda q, p, r: _relaxed_step(
            robot.model, robot._active_tuple, robot.ee_link,
            q, p, r, robot._q_rest, weights,
        )
    )

    @jax.jit
    def run(traj_seq, q0):
        def tick(qs, targets):
            pos = targets[:, :3].astype(jnp.float32)
            if D > 3:
                quat = targets[:, 3:7].astype(jnp.float32)
                quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
            else:
                quat = jnp.broadcast_to(jnp.asarray(fixed_quat), (N, 4))
            q_t = step_many(qs.astype(jnp.float32), pos, quat)
            qs = _step_toward_j(robot, qs, q_t, max_change)
            return qs, qs

        idx = jnp.minimum(jnp.arange(total), T - 1)
        _, hist = jax.lax.scan(tick, q0, traj_seq[idx])
        return hist

    hist = np.asarray(
        run(jnp.asarray(np.swapaxes(trajs, 0, 1)),
            jnp.asarray(q0s, dtype=jnp.float32))
    )
    return [
        np.concatenate([q0s[i][None], hist[:, i]]) if alive[i]
        else np.zeros((0, q0s.shape[1]))
        for i in range(N)
    ]


# ---------------------------------------------------------------------------
# metrics (experiment/utils.py semantics, batched)
# ---------------------------------------------------------------------------


def interpolated_configs(robot, c_traj, num_div):
    """All ``num_div`` interpolation steps between consecutive configs,
    flattened: (T-1)*num_div rows (``experiment/utils.py:48-60,72-84``)."""
    c = np.asarray(c_traj, dtype=np.float64)
    qa = np.repeat(c[:-1], num_div, axis=0)
    qb = np.repeat(c[1:], num_div, axis=0)
    u = np.tile((np.arange(num_div) + 1) / num_div, len(c) - 1)[:, None]
    cyc = np.asarray(robot._cyclic_mask)
    diff = qb - qa
    diff = np.where(cyc, np.mod(diff + np.pi, 2 * np.pi) - np.pi, diff)
    out = qa + u * diff
    return np.where(cyc, np.mod(out + np.pi, 2 * np.pi) - np.pi, out)


def check_c_traj_batch(robot, goal, c_traj, num_div=8, chunk=4096):
    """Reference validity (``experiment/utils.py:30-63``): the final config
    reaches the goal (position within 0.1; rotation within 0.1 rad when the
    robot tracks rotation) AND no self-collision along the num_div-times
    interpolated path.

    Divergence (documented): for variable-rotation problems the rotation is
    checked against the GOAL's own quaternion; the reference compares
    against ``fixed_rotation`` (``utils.py:37-44``), which is only correct
    for rot_fixed problems — its benchmark default."""
    if len(c_traj) == 0:
        return False
    c_traj = np.asarray(c_traj, dtype=np.float32)
    ee = np.asarray(robot.fk_point_batch(c_traj[-1:]))[0]
    goal = np.asarray(goal)
    if np.linalg.norm(ee[:3] - goal[:3]) > 0.1:
        return False
    if robot.rotation != "free":
        if len(goal) > 3:
            ref_quat = goal[3:7]
        elif robot.fixed_rotation is not None:
            ref_quat = np.asarray(robot.fixed_rotation)
        else:
            ref_quat = None
        if ref_quat is not None:
            ang = 2 * np.arccos(
                min(1.0, abs(float(np.dot(ee[3:7], ref_quat))))
            )
            if ang > 0.1:
                return False
    qi = interpolated_configs(robot, c_traj, num_div)
    for s in range(0, len(qi), chunk):
        if robot.check_self_collision_batch(qi[s : s + chunk]).any():
            return False
    return True


def ws_traj_batch(robot, start, c_traj, num_div=4):
    """FK-resampled workspace trajectory (``experiment/utils.py:66-84``):
    starts at the input start point, then FK of every interpolated config."""
    qi = interpolated_configs(robot, c_traj, num_div)
    pts = _fk_points_batch(robot, qi)
    start = np.asarray(start, dtype=np.float64)[: pts.shape[1]]
    return np.concatenate([start[None], pts], axis=0)


def se3_cost_matrix(a, b):
    """(n, D) x (m, D) -> (n, m) workspace SE3 distances."""
    return np.asarray(
        se3_pairwise(
            jnp.asarray(np.asarray(a), dtype=jnp.float32),
            jnp.asarray(np.asarray(b), dtype=jnp.float32),
        )
    )


def dtw_reference(traj1, traj2):
    """Reference DTW (``experiment/utils.py:87-144``): DP matrix with
    inf-filled first row/column, backtracked index pairs, distance = sum of
    pairwise costs along the path normalized by ``len(traj1)``."""
    a = np.asarray(traj1)
    b = np.asarray(traj2)
    cost = se3_cost_matrix(a, b).astype(np.float64)
    return _dtw_from_cost(cost) / len(a)


def _dtw_from_cost(cost):
    """DTW dynamic program + backtrack on a precomputed cost matrix.

    The row recurrence D[i,j] = c[j] + min(D[i-1,j], D[i-1,j-1], D[i,j-1])
    vectorizes via prefix sums: unrolling horizontal moves gives
    D[i,j] = S[j] + min_{k<=j}(m'[k] - S[k-1]) with m' = min of the two
    upper entries and S = cumsum(c) — an O(m) ``minimum.accumulate`` per
    row instead of an O(m) Python loop."""
    n, m = cost.shape
    D = np.full((n, m), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n):
        up = D[i - 1]
        mprime = np.minimum(up, np.concatenate([[np.inf], up[:-1]]))
        c = cost[i]
        S = np.cumsum(c)
        S_prev = S - c
        with np.errstate(invalid="ignore"):
            D[i] = S + np.minimum.accumulate(mprime - S_prev)

    # backtrack (utils.py:105-129)
    i, j = n - 1, m - 1
    pairs = []
    while i > 0 and j > 0:
        pairs.append((i, j))
        step = int(np.argmin([D[i - 1, j], D[i, j - 1], D[i - 1, j - 1]]))
        if step == 0:
            i -= 1
        elif step == 1:
            j -= 1
        else:
            i -= 1
            j -= 1
    if i == 0:
        pairs.extend((0, jj) for jj in range(j + 1))
    else:
        pairs.extend((ii, 0) for ii in range(i + 1))

    return float(sum(cost[i, j] for i, j in pairs))


def config_lengths(robot, c_traj):
    c = np.asarray(c_traj)
    if len(c) < 2:
        return 0.0
    d = np.asarray(
        robot.distance_batch(jnp.asarray(c[:-1], dtype=jnp.float32),
                             jnp.asarray(c[1:], dtype=jnp.float32))
    )
    return float(d.sum())


def ws_length(w_traj):
    w = np.asarray(w_traj)
    if len(w) < 2:
        return 0.0
    seg = np.asarray(
        maths.se3_distance(
            jnp.asarray(w[:-1], dtype=jnp.float32),
            jnp.asarray(w[1:], dtype=jnp.float32),
        )
    )
    return float(seg.sum())


# ---------------------------------------------------------------------------
# the full benchmark
# ---------------------------------------------------------------------------


def cold_starts(resolution, trajs):
    """Per-trajectory q0 via cold resolution.solve of start AND end
    (``trajectory_quality.py:72-80``). Returns (q0s (N, A), alive (N,)).

    Batched: the cold-start semantics of :meth:`RedundancyResolution.solve`
    (k-NN -> exact-node match -> largest-connected-component weighted
    average seed, ``resolution.py:313-433``) run host-side per point on
    numpy, and ALL the IK solves collapse into one ``dls_ik_batch``
    dispatch instead of one per point (the per-point ``resolution.solve``
    loop)."""
    robot = resolution.robot
    N = len(trajs)
    A = robot.num_joints
    q0s = np.zeros((N, A), dtype=np.float64)
    alive = np.zeros(N, dtype=bool)
    if N == 0 or len(resolution.points) == 0:
        return q0s, alive

    pts = np.stack(
        [np.asarray(t[0], dtype=np.float64) for t in trajs]
        + [np.asarray(t[-1], dtype=np.float64) for t in trajs]
    )  # (2N, D) starts then ends
    if pts.shape[1] > 3:
        pts[:, 3:] /= np.linalg.norm(pts[:, 3:], axis=-1, keepdims=True)
    k = resolution.workspace.interpolate_num_neighbors
    nbrs = resolution.workspace.get_workspace_neighbors(
        pts.astype(np.float32), k=min(k, len(resolution.points)),
        points=resolution.points,
    )  # (2N, k)
    seeds = np.zeros((2 * N, A), dtype=np.float32)
    for m in range(2 * N):
        neighbors = [int(n) for n in np.atleast_1d(nbrs[m])]
        # exact node match (resolution.py:313-318)
        d0 = np.asarray(
            maths.se3_distance(
                jnp.asarray(pts[m], dtype=jnp.float32)[None],
                jnp.asarray(resolution.points[neighbors]),
            )
        )
        if d0.min() < 1e-3:
            seeds[m] = resolution.configs[neighbors[int(d0.argmin())]]
            continue
        # largest-connected-component weighted average (resolution.py:369-433)
        component = resolution._component_containing(neighbors, neighbors[0])
        comp = sorted(component)
        q_nbrs = resolution.configs[comp]
        d = np.asarray(
            maths.se3_distance(
                jnp.asarray(pts[m], dtype=jnp.float32)[None],
                jnp.asarray(resolution.points[comp]),
            )
        )
        workspace_w = (d.max() / np.maximum(d, 1e-12)) ** 2
        weights = (1.0 / (workspace_w + 1e-6)) ** 2  # resolution.py:424 quirk
        seeds[m] = np.asarray(robot.average(q_nbrs, weights))

    M = 2 * N
    Mp = _pow2(M)
    pts_p = np.pad(pts, ((0, Mp - M), (0, 0)), mode="edge")
    seeds_p = np.pad(seeds, ((0, Mp - M), (0, 0)), mode="edge")
    q, ok = robot.solve_ik_batch(
        jnp.asarray(pts_p, dtype=jnp.float32), jnp.asarray(seeds_p)
    )
    q = np.asarray(q)[:M]
    ok = np.asarray(ok)[:M]
    alive = ok[:N] & ok[N:]
    q0s[alive] = q[:N][alive].astype(np.float64)
    return q0s, alive


def analyze_arm(robot, trajs, c_trajs, num_div=4):
    """Per-trajectory metrics rows (``analyze_results`` semantics).

    Rows of equal length (the engine's output shape) batch every device
    stage across ALL trajectories — final-config FK, interpolated
    self-collision, workspace-trajectory FK, and the DTW cost matrices
    each run as ONE dispatch instead of one per row (~4 host round trips
    x N rows x 16 arm-kind pairs). The DTW dynamic program
    itself stays on host (vectorized rows, ``dtw_reference``)."""
    live = [i for i, c in enumerate(c_trajs) if len(c)]
    lens = {len(c_trajs[i]) for i in live}
    if len(live) >= 2 and len(lens) == 1:
        return _analyze_arm_batched(robot, trajs, c_trajs, live, num_div)
    rows = []
    for traj, c_traj in zip(trajs, c_trajs):
        ok = check_c_traj_batch(robot, traj[-1], c_traj)
        row = {"success": bool(ok)}
        if len(c_traj):
            w_traj = ws_traj_batch(robot, traj[0], c_traj, num_div)
            c_len = config_lengths(robot, c_traj)
            w_len = ws_length(w_traj)
            row.update(
                dtw=dtw_reference(traj, w_traj),
                c_length=c_len,
                w_length=w_len,
                ratio=c_len / max(w_len, 1e-9),
            )
        rows.append(row)
    return rows


def _analyze_arm_batched(robot, trajs, c_trajs, live, num_div=4,
                         check_div=8):
    """Batched ``analyze_arm`` core for equal-length live rows."""
    C = np.stack([c_trajs[i] for i in live])  # (M, L, A)
    M, L, A = C.shape
    goals = np.stack([np.asarray(trajs[i][-1]) for i in live])

    # --- goal reach: FK of every final config in one dispatch ---
    ee_fin = np.asarray(
        robot.fk_point_batch(C[:, -1].astype(np.float32))
    )  # (M, 7)
    reach = np.linalg.norm(ee_fin[:, :3] - goals[:, :3], axis=-1) <= 0.1
    if robot.rotation != "free":
        for m in range(M):
            if not reach[m]:
                continue
            g = goals[m]
            ref_quat = (
                g[3:7] if len(g) > 3 else (
                    np.asarray(robot.fixed_rotation)
                    if robot.fixed_rotation is not None else None
                )
            )
            if ref_quat is not None:
                ang = 2 * np.arccos(
                    min(1.0, abs(float(np.dot(ee_fin[m, 3:7], ref_quat))))
                )
                if ang > 0.1:
                    reach[m] = False

    # --- interpolated self-collision: ONE dispatch over all rows ---
    qi_chk = np.stack(
        [interpolated_configs(robot, C[m], check_div) for m in range(M)]
    )  # (M, (L-1)*check_div, A)
    flat = qi_chk.reshape(-1, A).astype(np.float32)
    coll = np.zeros(len(flat), dtype=bool)
    CH = 1 << 17
    for s in range(0, len(flat), CH):
        coll[s : s + CH] = np.asarray(
            robot.check_self_collision_batch(flat[s : s + CH])
        )
    collided = coll.reshape(M, -1).any(axis=1)
    success = reach & ~collided

    # --- workspace trajectories: ONE FK dispatch over all rows ---
    qi_ws = np.stack(
        [interpolated_configs(robot, C[m], num_div) for m in range(M)]
    )  # (M, (L-1)*num_div, A)
    W = qi_ws.shape[1]
    pts = _fk_points_batch(robot, qi_ws.reshape(-1, A))
    D = pts.shape[1]
    pts = pts.reshape(M, W, D)
    starts = np.stack(
        [np.asarray(trajs[i][0], dtype=np.float64)[:D] for i in live]
    )
    w_trajs = np.concatenate([starts[:, None], pts], axis=1)  # (M, W+1, D)

    # --- DTW cost matrices: one vmapped dispatch ---
    in_trajs = np.stack([np.asarray(trajs[i])[:, :D] for i in live])
    cost_all = np.asarray(
        jax.jit(jax.vmap(se3_pairwise))(
            jnp.asarray(in_trajs, dtype=jnp.float32),
            jnp.asarray(w_trajs, dtype=jnp.float32),
        )
    ).astype(np.float64)

    # --- lengths: batched distances ---
    cd = np.asarray(
        robot.distance_batch(
            jnp.asarray(C[:, :-1].reshape(-1, A), dtype=jnp.float32),
            jnp.asarray(C[:, 1:].reshape(-1, A), dtype=jnp.float32),
        )
    ).reshape(M, L - 1)
    c_lens = cd.sum(axis=1)
    wd = np.asarray(
        maths.se3_distance(
            jnp.asarray(w_trajs[:, :-1].reshape(-1, D), dtype=jnp.float32),
            jnp.asarray(w_trajs[:, 1:].reshape(-1, D), dtype=jnp.float32),
        )
    ).reshape(M, W)
    w_lens = wd.sum(axis=1)

    by_live = {}
    for mi, i in enumerate(live):
        dtw = _dtw_from_cost(cost_all[mi]) / len(in_trajs[mi])
        by_live[i] = {
            "success": bool(success[mi]),
            "dtw": dtw,
            "c_length": float(c_lens[mi]),
            "w_length": float(w_lens[mi]),
            "ratio": float(c_lens[mi] / max(w_lens[mi], 1e-9)),
        }
    return [
        by_live.get(i, {"success": False}) for i in range(len(c_trajs))
    ]


def summarize(rows, success_only=True):
    n = len(rows)
    if n == 0:
        return {}
    succ = [r for r in rows if r["success"]]
    vals = succ if success_only else [r for r in rows if "dtw" in r]
    out = {
        "success_rate": len(succ) / n,
        "n": n,
        "n_valid": len(vals),
    }
    for key in ("dtw", "ratio", "c_length", "w_length"):
        xs = [r[key] for r in vals if key in r]
        out[f"mean_{key}"] = float(np.mean(xs)) if xs else None
    return out


def run_reference_benchmark(
    resolution,
    trajectories_by_kind,
    random_resolution=None,
    include_relaxed=True,
    max_change=0.04,
    converge_steps=100,
    verbose=True,
    checkpoint_path=None,
    initial_results=None,
    greedy_seed=False,
    arms=("grr", "random_grr", "newton", "relaxed"),
):
    """All arms x all kinds at the reference protocol, ticks batched.

    ``trajectories_by_kind``: {kind: list of (T, D) paths}. Returns
    {kind: {arm: summary}} plus per-arm GRR fallback statistics.

    ``checkpoint_path``: write the accumulated {kind: {arm: summary}}
    JSON after EVERY completed kind — the full protocol runs for hours
    (5.3 h measured for kinova n=100 on one CPU core, longer for ur10),
    and a crash/timeout must not lose the finished kinds.

    ``initial_results``: {kind: {arm: summary}} from a prior partial
    run (a ``checkpoint_path`` dump) — kinds already present are
    skipped, so a killed multi-hour run resumes at the first
    unfinished kind instead of repaying the finished ones.

    ``arms``: which arms to run — a variant rerun (e.g. the round-5
    greedy-seeded GRR row) measures one arm in ~1/6 the wall time and
    merges against the landed table instead of repaying all four.
    """
    robot = resolution.robot
    results = dict(initial_results) if initial_results else {}
    stats_out = {}
    for kind, trajs in trajectories_by_kind.items():
        if results.get(kind):
            if verbose:
                print(f"[{kind}] resumed from checkpoint, skipping",
                      flush=True)
            continue
        if not trajs:
            results[kind] = {}
            continue
        trajs = np.stack(trajs)
        t_kind = time.time()

        def _phase(msg):
            if verbose:
                print(f"[{kind}] +{time.time() - t_kind:.0f}s {msg}",
                      flush=True)

        q0s, alive = cold_starts(resolution, trajs)
        _phase(f"{int(alive.sum())}/{len(trajs)} alive starts")
        kind_res = {}
        stats_out[kind] = {}

        if "grr" in arms:
            _phase("grr: tracking")
            grr_c, grr_stats = grr_teleop_batch(
                resolution, trajs, q0s, alive, max_change, converge_steps,
                verbose=verbose, greedy_seed=greedy_seed,
            )
            _phase("grr: analysis")
            kind_res["grr"] = summarize(analyze_arm(robot, trajs, grr_c))
            stats_out[kind]["grr"] = grr_stats

        if random_resolution is not None and "random_grr" in arms:
            _phase("random_grr: cold starts")
            rq0, ralive = cold_starts(random_resolution, trajs)
            _phase("random_grr: tracking")
            rand_c, rand_stats = grr_teleop_batch(
                random_resolution, trajs, rq0, ralive, max_change,
                converge_steps, verbose=verbose,
            )
            _phase("random_grr: analysis")
            kind_res["random_grr"] = summarize(analyze_arm(robot, trajs, rand_c))
            stats_out[kind]["random_grr"] = rand_stats

        if "newton" in arms:
            _phase("newton: tracking")
            newton_c = newton_teleop_batch(
                robot, trajs, q0s, alive, max_change, converge_steps
            )
            _phase("newton: analysis")
            kind_res["newton"] = summarize(analyze_arm(robot, trajs, newton_c))

        if include_relaxed and "relaxed" in arms:
            _phase("relaxed: tracking")
            relaxed_c = relaxed_teleop_batch(
                robot, trajs, q0s, alive, max_change, converge_steps
            )
            _phase("relaxed: analysis")
            kind_res["relaxed"] = summarize(analyze_arm(robot, trajs, relaxed_c))
        _phase("kind done")

        results[kind] = kind_res
        if checkpoint_path:
            import json

            tmp = f"{checkpoint_path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"results": results, "complete": False}, f,
                          indent=1)
            os.replace(tmp, checkpoint_path)
        if verbose:
            for arm, row in kind_res.items():
                if row:
                    print(
                        f"  {arm:<11} success {row['success_rate']:.2f} "
                        f"dtw {row['mean_dtw'] if row['mean_dtw'] is not None else float('nan'):.4f} "
                        f"ratio {row['mean_ratio'] if row['mean_ratio'] is not None else float('nan'):.2f} "
                        f"(n={row['n']}, valid={row['n_valid']})"
                    )
    return results, stats_out
