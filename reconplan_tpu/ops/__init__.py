"""Device kernels: point clouds, nearest neighbors, ICP, TSDF, marching cubes.

JAX replacement for the Open3D C++ geometry/registration stack used by
the reference's ``stitcher.py`` plus the sklearn/pynndescent/GNAT NN
structures used by Expansion-GRR. Everything is fixed-shape (padding + masks)
and jit/vmap-friendly; the big reductions are matmul-form distance
computations.
"""

from reconplan_tpu.ops.pointcloud import (
    PointCloud,
    backproject_depth,
    voxel_downsample,
    estimate_normals,
    remove_statistical_outliers,
)
from reconplan_tpu.ops.nn import (
    pairwise_sqdist,
    knn,
    nearest_neighbor,
    se3_knn,
)
from reconplan_tpu.ops.icp import (
    ICPResult,
    icp_point_to_point,
    icp_point_to_plane,
    colored_icp,
    register_kabsch,
)
from reconplan_tpu.ops import tsdf, tsdf_brick, marching, features

__all__ = [
    "PointCloud",
    "backproject_depth",
    "voxel_downsample",
    "estimate_normals",
    "remove_statistical_outliers",
    "pairwise_sqdist",
    "knn",
    "nearest_neighbor",
    "se3_knn",
    "ICPResult",
    "icp_point_to_point",
    "icp_point_to_plane",
    "colored_icp",
    "register_kabsch",
    "tsdf",
    "tsdf_brick",
    "marching",
    "features",
]
