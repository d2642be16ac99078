"""Stitching CLI — rebuild of running ``python stitcher.py`` directly.

Loads a recorded RGBD capture directory (sim PNG-depth layout or RealSense
.npy-depth layout), stitches it with colored-ICP + point-to-point refinement
(reference defaults), optionally TSDF-fuses, and writes PLY outputs.

Usage: python -m reconplan_tpu.apps.stitch [capture_dir] [--out cloud.ply]
"""

from __future__ import annotations

import argparse

import numpy as np

from reconplan_tpu.io.meshio import save_ply
from reconplan_tpu.recon.stitcher import PinholeIntrinsic, RGBDStitcher

# stitcher.py:264-267 intrinsics
D435 = dict(fx=615.6707153320312, fy=615.962158203125,
            cx=326.0557861328125, cy=240.55592346191406)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture_dir", nargs="?", default="./camera")
    ap.add_argument("--rgb", default="rgb")
    ap.add_argument("--depth", default="depth")
    ap.add_argument("--out", default="stitched_cloud.ply")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)
    from reconplan_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    stitcher = RGBDStitcher(
        PinholeIntrinsic(args.width, args.height, **D435)
    )
    colors, depths = stitcher.load_dataset_two_folders(
        args.capture_dir, args.rgb, args.depth
    )
    print(f"Loaded {len(colors)} frames from {args.capture_dir}")
    cloud = stitcher.stitch_sequence(colors, depths)
    pts, cols, _ = cloud.compact()
    print(f"Stitched cloud: {len(pts)} points")
    save_ply(args.out, vertices=pts, colors=cols if len(cols) else None)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
