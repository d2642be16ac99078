"""Reconstruction pipelines: stitching, TSDF fusion, Poisson, metrics.

The model layer of the framework — what ``stitcher.py`` + the absent
TSDF/Poisson capabilities of the reference become on the accelerator.
"""

from reconplan_tpu.recon.metrics import chamfer_distance, chamfer_to_mesh
from reconplan_tpu.recon.stitcher import RGBDStitcher
from reconplan_tpu.recon.fusion import FusionPipeline, fuse_frameset
from reconplan_tpu.recon.poisson import poisson_reconstruct

__all__ = [
    "chamfer_distance",
    "chamfer_to_mesh",
    "RGBDStitcher",
    "FusionPipeline",
    "fuse_frameset",
    "poisson_reconstruct",
]
