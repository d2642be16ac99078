"""Benchmark: banana orbit fusion at 256^3/512^3 + Chamfer (configs 1, 3, 4).

Renders an orbit of synthetic D435 frames around the YCB banana, fuses with
the brick engine, extracts a mesh, and reports throughput + Chamfer error
vs the YCB ground truth.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OBJ = [0.0, 0.0, 0.0]
BANANA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data/objects/011_banana/tsdf/nontextured.ply",
)


def main(n_frames=32, dims=(256, 512)):
    import jax
    import jax.numpy as jnp

    from reconplan_tpu.io.meshio import load_mesh
    from reconplan_tpu.io.render import SplatCamera
    from reconplan_tpu.ops import tsdf_brick as tb
    from reconplan_tpu.ops.marching import marching_cubes
    from reconplan_tpu.ops.tsdf import TSDFGrid
    from reconplan_tpu.recon.metrics import chamfer_to_mesh

    cam = SplatCamera()
    cam.add_mesh_file(BANANA, translate=OBJ)
    depths, colors, poses = [], [], []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        eye = [OBJ[0] + 0.35 * np.cos(ang), OBJ[1] + 0.35 * np.sin(ang), OBJ[2] + 0.25]
        d, c, T = cam.take_picture(eye, OBJ)
        depths.append(d)
        poses.append(T)
    depths = jnp.asarray(np.stack(depths))
    poses = jnp.asarray(np.stack(poses).astype(np.float32))
    fx, fy, cx, cy = cam.intrinsics

    gt_v, gt_f = load_mesh(BANANA)
    gt_v = gt_v + np.asarray(OBJ)

    for N in dims:
        grid = tb.make_brick_grid(
            (N, N, N), (OBJ[0] - 0.2, OBJ[1] - 0.2, OBJ[2] - 0.15), 0.4 / (N - 1)
        )
        grid, na = tb.integrate_frames_bricked_device(
            grid, depths, poses, fx, fy, cx, cy, max_active=8192
        )
        jax.block_until_ready(grid.weight)
        REPS = 5
        t0 = time.perf_counter()
        for _ in range(REPS):
            grid, na = tb.integrate_frames_bricked_device(
                grid, depths, poses, fx, fy, cx, cy, max_active=8192
            )
        jax.block_until_ready(grid.weight)
        dt = (time.perf_counter() - t0) / REPS
        fps = n_frames / dt

        sdf, weight = tb.to_dense(grid)
        dense = TSDFGrid(
            sdf, weight, jnp.zeros((0, 0, 0, 3), dtype=jnp.float32),
            grid.origin, jnp.float32(grid.voxel_size), jnp.float32(grid.trunc),
        )
        tris = marching_cubes(dense)
        ch = None
        if len(tris):
            ch, _, _ = chamfer_to_mesh(tris.reshape(-1, 3), gt_v, gt_f)
        print(json.dumps({
            "config": "banana orbit fusion",
            "device_kind": jax.devices()[0].device_kind,
            "grid": N,
            "frames": n_frames,
            "active_bricks": int(na),
            "fps": round(fps, 1),
            "triangles": int(len(tris)),
            "chamfer_mm": round(ch * 1000, 3) if ch else None,
        }))


if __name__ == "__main__":
    main()
