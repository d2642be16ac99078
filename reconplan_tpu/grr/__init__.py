"""Expansion-GRR: global redundancy resolution on the accelerator.

Rebuild of the reference's planning core (``Expansion-GRR/grr/``):
  - workspace.py  -> :mod:`workspace`   (arrays + dense NN instead of
    networkx + BallTree/NNDescent)
  - solver.py     -> :mod:`solver`      (host BFS orchestrating batched
    device IK waves instead of per-node C++ IK calls)
  - resolution.py -> :mod:`resolution`  (same online API: solve /
    teleop_solve / plan)
  - workspace_path.py -> :mod:`paths`
  - roadmap_quality  -> :mod:`quality`

Roadmaps are flat arrays checkpointed as .npz (io.checkpoint), not pickled
object graphs.
"""

from reconplan_tpu.grr.workspace import RoadmapWorkspace
from reconplan_tpu.grr.solver import ExpansionSolver
from reconplan_tpu.grr.resolution import RedundancyResolution
from reconplan_tpu.grr.paths import (
    get_arc_path,
    get_linear_path,
    arc_interpolate,
    linear_interpolate,
)
from reconplan_tpu.grr.quality import census_reachability, evaluate_roadmap
from reconplan_tpu.grr import experiment, nearest_neighbors

__all__ = [
    "RoadmapWorkspace",
    "ExpansionSolver",
    "RedundancyResolution",
    "get_arc_path",
    "get_linear_path",
    "arc_interpolate",
    "linear_interpolate",
    "evaluate_roadmap",
    "experiment",
    "nearest_neighbors",
]
