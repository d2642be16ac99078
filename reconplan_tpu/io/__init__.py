"""Host-side IO: meshes, images, frame feeds, configs, checkpoints, drivers.

The host<->device boundary of the framework (SURVEY.md §5): RGBD frames and
robot commands cross here; everything inward is JAX. Replaces the
reference's librealsense/ur_rtde/OpenCV dependencies with protocol-shaped
shims (`FrameFeed`, `CommandSink`) so recorded datasets, the synthetic
on-device renderer, and (on real hardware) camera/robot drivers are
interchangeable.
"""

from reconplan_tpu.io.meshio import load_mesh, save_ply, sample_mesh_surface
from reconplan_tpu.io.config import load_problem, safe_eval
from reconplan_tpu.io.frames import (
    FrameSet,
    DirectoryFrameFeed,
    ArrayFrameFeed,
    load_rgbd_folder,
)
from reconplan_tpu.io.checkpoint import save_roadmap_npz, load_roadmap_npz

__all__ = [
    "load_mesh",
    "save_ply",
    "sample_mesh_surface",
    "load_problem",
    "safe_eval",
    "FrameSet",
    "DirectoryFrameFeed",
    "ArrayFrameFeed",
    "load_rgbd_folder",
    "save_roadmap_npz",
    "load_roadmap_npz",
]
