"""Localize the closed-loop scan's gt->mesh Chamfer tail.

The closed-loop scan (apps/scan.py; reference protocol ``main.py:68-136``)
reports a symmetric Chamfer whose gt->mesh direction dominates whenever
viewpoint COVERAGE misses part of the object (round 3: 1.687 mm gt->mesh
vs 0.390 mesh->gt at 6 arcs / 72 images). This tool answers "missing
WHERE": it samples the ground-truth surface densely, measures the exact
point-to-triangle distance to the reconstructed mesh, and bins the error
by height band and azimuth sector around the object center — so an arc
schedule can be pointed at the actual gap instead of tuned blind.

Usage:
  python benchmarks/eval_scan_coverage.py --mesh scan_output/fused_mesh.ply
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="scan_output/fused_mesh.ply",
                    help="reconstructed mesh (triangle soup PLY from scan)")
    ap.add_argument("--samples", type=int, default=60_000)
    ap.add_argument("--bins-z", type=int, default=4)
    ap.add_argument("--bins-az", type=int, default=8)
    args = ap.parse_args(argv)

    from reconplan_tpu.apps.scan import BANANA_MESH, OBJECT_POINT
    from reconplan_tpu.io.meshio import load_mesh, sample_mesh_surface
    from reconplan_tpu.recon.metrics import points_to_mesh_distance

    rec_v, rec_f = load_mesh(args.mesh)
    rec_tris = rec_v[rec_f] if rec_f is not None and len(rec_f) else \
        rec_v.reshape(-1, 3, 3)
    gt_v, gt_f = load_mesh(BANANA_MESH)
    gt_v = gt_v + np.asarray(OBJECT_POINT)
    surf, _ = sample_mesh_surface(gt_v, gt_f, args.samples, seed=0)
    surf = surf.astype(np.float32)

    d = np.asarray(points_to_mesh_distance(surf, rec_tris)) * 1000.0  # mm

    rel = surf - np.asarray(OBJECT_POINT, np.float32)
    z = surf[:, 2]
    az = np.degrees(np.arctan2(rel[:, 1], rel[:, 0])) % 360.0

    print(f"mesh: {args.mesh} ({len(rec_tris)} triangles)")
    print(f"gt->mesh over {len(surf)} GT samples: "
          f"mean {d.mean():.3f} mm  median {np.median(d):.3f}  "
          f"q95 {np.quantile(d, 0.95):.3f}  q99 {np.quantile(d, 0.99):.3f}  "
          f">1mm {np.mean(d > 1.0):.1%}  >2mm {np.mean(d > 2.0):.1%}")

    z_edges = np.quantile(z, np.linspace(0, 1, args.bins_z + 1))
    print("\nby height band (GT z, equal-count bands):")
    for b in range(args.bins_z):
        m = (z >= z_edges[b]) & (z <= z_edges[b + 1] if b == args.bins_z - 1
                                 else z < z_edges[b + 1])
        print(f"  z [{z_edges[b]*1000:7.1f}, {z_edges[b+1]*1000:7.1f}] mm: "
              f"mean {d[m].mean():.3f}  q95 {np.quantile(d[m], 0.95):.3f}  "
              f">1mm {np.mean(d[m] > 1.0):5.1%}  (n={m.sum()})")

    print("\nby azimuth sector (around object center):")
    width = 360.0 / args.bins_az
    for b in range(args.bins_az):
        m = (az >= b * width) & (az < (b + 1) * width)
        if m.sum() == 0:
            continue
        print(f"  az [{b*width:5.1f}, {(b+1)*width:5.1f}) deg: "
              f"mean {d[m].mean():.3f}  q95 {np.quantile(d[m], 0.95):.3f}  "
              f">1mm {np.mean(d[m] > 1.0):5.1%}  (n={m.sum()})")

    # worst cells of the z x az grid — the concrete viewpoint gap list
    print("\nworst (height band x azimuth sector) cells by mean error:")
    cells = []
    for bz in range(args.bins_z):
        mz = (z >= z_edges[bz]) & (z <= z_edges[bz + 1] if bz == args.bins_z - 1
                                   else z < z_edges[bz + 1])
        for ba in range(args.bins_az):
            m = mz & (az >= ba * width) & (az < (ba + 1) * width)
            if m.sum() >= 20:
                cells.append((float(d[m].mean()), bz, ba, int(m.sum())))
    cells.sort(reverse=True)
    for mean_d, bz, ba, n in cells[:8]:
        print(f"  z [{z_edges[bz]*1000:6.1f},{z_edges[bz+1]*1000:6.1f}] mm x "
              f"az [{ba*width:5.1f},{(ba+1)*width:5.1f}) deg: "
              f"mean {mean_d:.3f} mm (n={n})")


if __name__ == "__main__":
    main()
