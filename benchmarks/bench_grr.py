"""Benchmark: roadmap build + closed-loop scan-plan-fuse (BASELINE config 5).

UR10 GRR roadmap (arc workspace), 500-waypoint on-device arc solve, FK
camera poses, synthetic capture, brick fusion, Chamfer vs ground truth —
the full reference pipeline (redundancy.py + main.py) timed end to end.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_nodes=200, n_waypoints=500, n_images=16, grid_dim=256):
    import jax
    import jax.numpy as jnp

    from reconplan_tpu.apps.redundancy import build_roadmap
    from reconplan_tpu.apps.scan import BANANA_MESH, D435, OBJECT_POINT
    from reconplan_tpu.grr.paths import scan_arc
    from reconplan_tpu.io.meshio import load_mesh
    from reconplan_tpu.io.render import SplatCamera
    from reconplan_tpu.kin.chain import fk_all
    from reconplan_tpu.ops import tsdf_brick as tb
    from reconplan_tpu.ops.marching import marching_cubes
    from reconplan_tpu.ops.tsdf import TSDFGrid
    from reconplan_tpu.recon.metrics import chamfer_to_mesh

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    grr, metrics = build_roadmap(
        "ur10", "rot_free", n_pos_points=n_nodes, sampling_method="random",
        out_dir="/tmp/bench_grr_roadmap", verbose=False,
    )
    t_roadmap = time.perf_counter() - t0

    arc = scan_arc(OBJECT_POINT, num_points=n_waypoints)
    t0 = time.perf_counter()
    qs, ok = grr.solve_batch(arc)
    t_solve = time.perf_counter() - t0
    qs_ok = qs[ok]

    robot = grr.robot
    cam_link = robot.camera_link

    def cam_pos_of(q):
        full = robot._q_rest.at[robot._active_idx].set(q)
        _, t = fk_all(robot.model, full)
        return t[cam_link]

    cam_positions = np.asarray(
        jax.jit(jax.vmap(cam_pos_of))(jnp.asarray(qs_ok))
    )

    cam = SplatCamera(**D435)
    cam.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
    pick = np.linspace(0, len(qs_ok) - 1, n_images).astype(int)
    t0 = time.perf_counter()
    frames = [cam.take_picture(cam_positions[i], OBJECT_POINT) for i in pick]
    t_capture = time.perf_counter() - t0
    depths = jnp.asarray(np.stack([f[0] for f in frames]))
    poses = jnp.asarray(np.stack([f[2] for f in frames]).astype(np.float32))

    grid = tb.make_brick_grid(
        (grid_dim,) * 3,
        (OBJECT_POINT[0] - 0.15, OBJECT_POINT[1] - 0.15, -0.05),
        0.3 / (grid_dim - 1),
    )
    t0 = time.perf_counter()
    grid, na = tb.integrate_frames_bricked_device(
        grid, depths, poses, D435["fx"], D435["fy"], D435["cx"], D435["cy"],
        max_active=16384,
    )
    jax.block_until_ready(grid.weight)
    t_fuse = time.perf_counter() - t0

    sdf, weight = tb.to_dense(grid)
    dense = TSDFGrid(
        sdf, weight, jnp.zeros((0, 0, 0, 3), dtype=jnp.float32),
        grid.origin, jnp.float32(grid.voxel_size), jnp.float32(grid.trunc),
    )
    tris = marching_cubes(dense)
    gt_v, gt_f = load_mesh(BANANA_MESH)
    gt_v = gt_v + np.asarray(OBJECT_POINT)
    ch = None
    if len(tris):
        ch, _, _ = chamfer_to_mesh(tris.reshape(-1, 3), gt_v, gt_f)

    print(json.dumps({
        "config": "closed-loop scan-plan-fuse",
        "roadmap_nodes": n_nodes,
        "roadmap_seconds": round(t_roadmap, 1),
        "disconnection_ratio_pct": round(metrics["disconnection_ratio"], 2),
        "waypoints_solved": int(np.asarray(ok).sum()),
        "waypoints_total": n_waypoints,
        "solve_seconds": round(t_solve, 2),
        "capture_seconds": round(t_capture, 2),
        "fuse_seconds": round(t_fuse, 2),
        "triangles": int(len(tris)),
        "chamfer_mm": round(ch * 1000, 3) if ch else None,
        "total_seconds": round(time.perf_counter() - t_all, 1),
    }))


if __name__ == "__main__":
    main()
