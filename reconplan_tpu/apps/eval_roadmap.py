"""Roadmap quality evaluation CLI (``experiment/roadmap_quality.py`` parity).

Usage: python -m reconplan_tpu.apps.eval_roadmap <robot> <rotation_type>
           [--dir graph/<robot>/<type>]
"""

from __future__ import annotations

import argparse
import os

from reconplan_tpu.grr import RedundancyResolution, evaluate_roadmap
from reconplan_tpu.io.config import load_problem
from reconplan_tpu.kin.robot import make_robot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("robot", nargs="?", default="ur10")
    ap.add_argument("rotation_type", nargs="?", default="rot_variable_yaw")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--html", default=None,
                    help="write an interactive roadmap viewer HTML here")
    ap.add_argument("--census", action="store_true",
                    help="IK-reachability census: what fraction of "
                    "reachable workspace nodes the roadmap configures")
    ap.add_argument("--census-restarts", type=int, default=8)
    args = ap.parse_args(argv)
    from reconplan_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    opts = load_problem(args.robot, args.rotation_type)
    robot = make_robot(opts)
    res = RedundancyResolution(robot)
    d = args.dir or os.path.join("graph", args.robot, args.rotation_type)
    res.load_workspace_graph(os.path.join(d, "workspace.npz"))
    res.load_resolution_graph(os.path.join(d, "resolution.npz"))

    solver_path = os.path.join(d, "solver.npz")
    if os.path.exists(solver_path):
        # the build checkpoints TRUE connectivity — use it directly
        res.load_solver_graph(solver_path)
    else:
        # legacy roadmap without solver.npz: restore configs onto the
        # workspace graph and RECOMPUTE edge continuity honestly (the old
        # has_config[i] and has_config[j] proxy reported 0% disconnection
        # for any loaded roadmap)
        import numpy as np

        from reconplan_tpu.ops.nn import nearest_neighbor
        import jax.numpy as jnp

        print("no solver.npz — recomputing edge continuity from configs")
        d_, idx = nearest_neighbor(jnp.asarray(res.points), jnp.asarray(res.workspace.points))
        idx = np.asarray(idx)
        res.solver.configs[idx] = res.configs
        res.solver.has_config[idx] = True
        res.solver.check_connections(list(idx))
    evaluate_roadmap(res)
    if args.census:
        from reconplan_tpu.grr import census_reachability

        census_reachability(res, restarts=args.census_restarts)
    if args.html:
        from reconplan_tpu.viz import export_roadmap_html

        export_roadmap_html(res, args.html)
        print(f"interactive viewer written to {args.html}")


if __name__ == "__main__":
    main()
