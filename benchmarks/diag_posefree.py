"""Diagnose the pose-free stitch on the multi-arc scan protocol:
per-frame estimated-vs-true camera pose error (rotation deg, translation
mm), using the stitcher's ``last_transforms`` diagnostics.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--arcs", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=1 << 16)
    ap.add_argument("--frame-capacity", type=int, default=1 << 14)
    args = ap.parse_args(argv)

    from reconplan_tpu.apps.scan import BANANA_MESH, D435, OBJECT_POINT
    from reconplan_tpu.grr.paths import scan_arc
    from reconplan_tpu.io.render import SplatCamera
    from reconplan_tpu.recon.stitcher import PinholeIntrinsic, RGBDStitcher

    cam = SplatCamera(**D435)
    cam.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
    cam.add_checker_floor(center=OBJECT_POINT[:2], size=0.5)
    per_arc = args.frames // args.arcs
    offsets = [0, 45, -45, -90]
    eyes = np.concatenate(
        [
            scan_arc(
                OBJECT_POINT, radius=0.25, height=0.10, num_points=per_arc,
                azimuth=3 * np.pi / 4 + np.deg2rad(offsets[a % 4]),
                max_horiz=1.03,
            )[:, :3]
            for a in range(args.arcs)
        ]
    )
    depths, colors, poses = [], [], []
    for eye in eyes:
        d, c, T = cam.take_picture(eye, OBJECT_POINT)
        depths.append(d)
        colors.append(c)
        poses.append(T)
    poses = np.stack(poses).astype(np.float32)

    st = RGBDStitcher(PinholeIntrinsic(640, 480, **D435))
    st.voxel_size = 0.004
    st.distance_threshold = 0.02
    st.model_capacity = args.capacity
    st.frame_capacity = args.frame_capacity
    st.stitch_sequence(colors, depths, poses=None)

    # truth, expressed in camera-0 coordinates like the estimates
    T0inv = np.linalg.inv(poses[0])
    gt_rel = np.einsum("ij,fjk->fik", T0inv, poses[1:])
    est = st.last_transforms
    per_arc_b = per_arc
    for i, (Tg, Te, fit, sc) in enumerate(
        zip(gt_rel, est, st.last_fits, st.last_scores)
    ):
        d = Te @ np.linalg.inv(Tg)
        rot = np.degrees(
            np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
        )
        tr = np.linalg.norm(d[:3, 3]) * 1000
        # step size from previous true pose (how far the camera moved)
        prev = gt_rel[i - 1] if i > 0 else np.eye(4, dtype=np.float32)
        dstep = Tg @ np.linalg.inv(prev)
        step_rot = np.degrees(
            np.arccos(np.clip((np.trace(dstep[:3, :3]) - 1) / 2, -1, 1))
        )
        mark = " <-- ARC JUMP" if (i + 1) % per_arc_b == 0 else ""
        print(
            f"frame {i+1:2d}: fit {float(fit):.3f} "
            f"s1 {float(sc[0]):.3f} sb {float(sc[1]):.3f}  "
            f"err rot {rot:7.2f} deg "
            f"trans {tr:8.2f} mm   (true step {step_rot:6.2f} deg){mark}",
            flush=True,
        )


if __name__ == "__main__":
    main()
