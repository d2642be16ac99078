"""Capture CLI — rebuild of ``python data_recorder.py``.

Drives the arm (simulated kinematic RTDE by default; the real UR10 when
``--hardware`` and ``ur_rtde`` are available) through ctraj.txt targets and
records RGBD frames + metadata in the reference's on-disk layout.

Usage: python -m reconplan_tpu.apps.record [ctraj] [--out DIR] [--hardware]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from reconplan_tpu.io.drivers import DataCollector, SimRTDE, read_joint_positions
from reconplan_tpu.io.render import SplatCamera

BANANA_MESH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "objects", "011_banana", "poisson", "nontextured.ply",
)
D435 = dict(fx=615.6707153320312, fy=615.962158203125,
            cx=326.0557861328125, cy=240.55592346191406)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ctraj", nargs="?", default="data/golden/ctraj.txt")
    ap.add_argument("--out", default="robot_data")
    ap.add_argument("--every-nth", type=int, default=20)
    ap.add_argument("--hardware", action="store_true",
                    help="use the real UR10 over ur_rtde + a RealSense")
    ap.add_argument("--ip", default="192.168.1.102")
    ap.add_argument("--rs-config", default="realsense_config.json",
                    help="RealSense advanced-mode JSON (data_recorder.py:74)")
    ap.add_argument("--rs-serial", default="",
                    help="serial-match a specific device (empty = first)")
    args = ap.parse_args(argv)
    from reconplan_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    targets = read_joint_positions(args.ctraj, every_nth=args.every_nth)
    print(f"{len(targets)} targets from {args.ctraj}")

    if args.hardware:
        from reconplan_tpu.io.drivers import HardwareRTDE, RealSenseCamera

        rtde = HardwareRTDE(args.ip)
        cam = RealSenseCamera(
            config_file=args.rs_config, serial=args.rs_serial or None
        )
        dc = DataCollector(rtde, cam, out_dir=args.out)
        n = dc.collect_data_from_targets(targets)
        print(f"captured {n} frames to {args.out}")
        cam.release()
        return

    from reconplan_tpu.io.config import load_problem
    from reconplan_tpu.kin.robot import make_robot

    opts = load_problem("ur10", "rot_free")
    robot = make_robot(opts)
    rtde = SimRTDE(robot)
    cam = SplatCamera(**D435)
    cam.add_mesh_file(BANANA_MESH, translate=(0.75, 0.75, 0.0))

    dc = DataCollector(rtde, cam, out_dir=args.out, target_point=(0.75, 0.75, 0.0))
    n = dc.collect_data_from_targets(targets, robot=robot)
    print(f"captured {n} frames into {args.out}/ (rgb/, depth/, metadata.json)")


if __name__ == "__main__":
    main()
