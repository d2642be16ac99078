"""Multi-frame RGBD stitching — API-parity port of the reference stitcher.

Public surface mirrors ``stitcher.py:9-258`` (``RGBDStitcher`` with
``create_point_cloud_from_rgbd``, ``preprocess_point_cloud``,
``register_point_clouds``, ``stitch_sequence``, ``load_default``,
``load_dataset_two_folders``, ``load_dataset_realsense``) with the same
defaults (voxel 0.02 m, distance threshold 0.05 m, colored-ICP then
point-to-point refinement, every-2-frames downsample + statistical outlier
removal 20/2.0).

Differences by design:
  * Open3D C++ -> reconplan_tpu.ops JAX kernels; the per-frame register
    loop runs as a handful of device dispatches.
  * Clouds are fixed-capacity (points + mask); the growing "combined"
    model cloud lives in a preallocated device buffer.
  * Known camera poses (e.g. from robot FK) can seed each registration —
    the reference always started from identity (``stitcher.py:77``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

from reconplan_tpu.io.frames import load_rgbd_folder
from reconplan_tpu.ops.icp import (
    color_gradients,
    colored_icp,
    icp_point_to_plane,
)
from reconplan_tpu.ops.pointcloud import (
    PointCloud,
    backproject_depth,
    estimate_normals,
    make_cloud,
    remove_statistical_outliers,
    voxel_downsample,
)


class PinholeIntrinsic:
    """Minimal stand-in for o3d.camera.PinholeCameraIntrinsic."""

    def __init__(self, width, height, fx, fy, cx, cy):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy


class RGBDStitcher:
    def __init__(self, intrinsic: PinholeIntrinsic):
        self.intrinsic = intrinsic
        self.voxel_size = 0.02  # stitcher.py:17
        self.distance_threshold = 0.05  # stitcher.py:18
        self.optimization_modulus = 2  # stitcher.py:19
        self.model_capacity = 1 << 15  # fixed device buffer for the model
        # (0.02 m voxels over a tabletop scene occupy ~5-20k slots)
        # trust region for pose-seeded registration (see stitch_sequence)
        self.pose_trust_trans = 0.01  # meters
        self.pose_trust_rot = 0.05  # radians
        # pose-free: tight-threshold score below this triggers the
        # FPFH+RANSAC global re-initialization (a well-locked frame puts
        # most of its points within 1.5 voxels of the model)
        self.global_rescue_score = 0.6
        # pose-free: frames whose best registration (chained OR rescued)
        # scores below this are NOT integrated and do NOT advance the
        # odometry chain — one unlocked frame written into the model
        # poisons every later registration against it. Well-locked frames
        # score >=0.75 on the scan fixture; spurious RANSAC optima ~0.4.
        self.integrate_score_floor = 0.55
        # independent RANSAC draws per rescue: a single unlucky draw can
        # land a spurious plane-on-plane optimum; the best post-refine
        # tight score across tries picks the real lock
        self.global_rescue_tries = 3

    # ------------------------------------------------------------------
    def create_point_cloud_from_rgbd(self, color_img, depth_img) -> PointCloud:
        """RGBD -> camera-frame cloud (``stitcher.py:21-48`` semantics:
        depth_scale 1000, trunc 3 m)."""
        return backproject_depth(
            jnp.asarray(depth_img),
            self.intrinsic.fx,
            self.intrinsic.fy,
            self.intrinsic.cx,
            self.intrinsic.cy,
            color=jnp.asarray(color_img) if color_img is not None else None,
            depth_scale=1000.0,
            depth_trunc=3.0,
        )

    def preprocess_point_cloud(self, pcd: PointCloud) -> PointCloud:
        """Downsample + estimate normals (``stitcher.py:50-71``; the FPFH
        the reference computed there was never consumed — see
        ops.features for the standalone FPFH op)."""
        down = voxel_downsample(pcd, self.voxel_size)
        return estimate_normals(down, k=30)

    def _register_j(self, source: PointCloud, target: PointCloud, T):
        """Device-side multi-scale registration (traceable).

        Coarse point-to-plane at 2x voxel / 2x distance pulls in from a
        rough initialization, then colored-ICP (when colors exist) locks
        the tangential directions, then fine point-to-plane converges the
        geometry. The reference refined with point-to-POINT
        (``stitcher.py:96-102``); point-to-plane converges quadratically
        on smooth surfaces where point-to-point stalls sliding along the
        surface — one reason the round-1 stitch sat at 5.6 mm.
        Returns (T (4,4) jnp, fitness scalar).
        """
        src_c = estimate_normals(
            voxel_downsample(source, 2.0 * self.voxel_size), k=30
        )
        tgt_c = estimate_normals(
            voxel_downsample(target, 2.0 * self.voxel_size), k=30
        )
        T = icp_point_to_plane(
            src_c, tgt_c, 2.0 * self.distance_threshold, init=T,
            max_iteration=25,
        ).transformation
        src = self.preprocess_point_cloud(source)
        tgt = self.preprocess_point_cloud(target)
        if source.has_colors and target.has_colors:
            grads = color_gradients(tgt)
            T = colored_icp(
                src, tgt, grads, self.distance_threshold, init=T,
                max_iteration=35,
            ).transformation
        res = icp_point_to_plane(
            src, tgt, self.distance_threshold, init=T, max_iteration=30
        )
        return res.transformation, res.fitness

    def _tight_score_j(self, cloud: PointCloud, model: PointCloud, T):
        """Fraction of cloud points within 1.5 voxels of the model after
        T — a registration-quality score that, unlike ICP fitness at the
        loose ``distance_threshold``, collapses for wrong-but-overlapping
        poses (smooth objects let ICP lock confidently onto the wrong
        side)."""
        from reconplan_tpu.ops.nn import nearest_neighbor

        moved = (
            jnp.matmul(cloud.points, T[:3, :3].T, precision=_HI) + T[:3, 3]
        )
        d, idx = nearest_neighbor(moved, model.points, valid=model.valid)
        close = (d < 1.5 * self.voxel_size) & cloud.valid
        if cloud.has_colors and model.has_colors:
            # geometry alone cannot reject a symmetric wrong pose (a
            # plane aligns with its own 180-degree flip); color must
            # agree too
            cdist = jnp.linalg.norm(
                cloud.colors - model.colors[idx], axis=-1
            )
            close = close & (cdist < 0.25)
        return jnp.sum(close) / jnp.maximum(jnp.sum(cloud.valid), 1)

    def _global_init_j(self, source: PointCloud, target: PointCloud,
                       key=None):
        """Traceable FPFH + RANSAC global initialization (no prior pose).

        The reference computed FPFH in ``stitcher.py:67-69`` but never
        used it; its pose-free route chains colored-ICP from identity
        (``stitcher.py:73-112``), which only works for video-dense
        captures. This supplies the missing global stage so a pose-free
        stitch survives large viewpoint jumps (e.g. the multi-arc scan
        protocol's 45-135 deg arc transitions).
        """
        from reconplan_tpu.ops.features import _ransac_core, fpfh
        from reconplan_tpu.ops.nn import nearest_neighbor

        src = estimate_normals(
            voxel_downsample(source, 2.0 * self.voxel_size), k=30
        )
        tgt = estimate_normals(
            voxel_downsample(target, 2.0 * self.voxel_size), k=30
        )
        fs = fpfh(src, k=32)
        ft = fpfh(tgt, k=32)
        _, fwd = nearest_neighbor(fs, ft, valid=tgt.valid)
        _, bwd = nearest_neighbor(ft, fs, valid=src.valid)
        mutual = jnp.arange(src.points.shape[0]) == bwd[fwd]
        corr_valid = src.valid & mutual & tgt.valid[fwd]
        both_col = src.has_colors and tgt.has_colors
        T, _score = _ransac_core(
            src.points, tgt.points, fwd, corr_valid,
            jax.random.PRNGKey(0) if key is None else key,
            inlier_threshold=3.0 * self.voxel_size,
            n_hypotheses=1024,
            src_cols=src.colors if both_col else None,
            dst_cols=tgt.colors if both_col else None,
        )
        return T

    def register_point_clouds(self, source: PointCloud, target: PointCloud,
                              initial_transform=None):
        """Multi-scale point-to-plane (+colored-ICP) registration
        (``stitcher.py:73-112`` surface). Returns (T (4,4) np, fitness)."""
        T = (
            jnp.eye(4)
            if initial_transform is None
            else jnp.asarray(initial_transform, dtype=jnp.float32)
        )
        T, fit = self._register_j(source, target, T)
        return np.asarray(T), float(fit)

    # ------------------------------------------------------------------
    def _model_append(self, model: PointCloud, cloud: PointCloud, T,
                      overflow=None):
        """Transform ``cloud`` by T and merge into the model buffer.

        The model keeps a FIXED capacity: both clouds concatenate (constant
        total shape per frame index) and a voxel downsample immediately
        compacts back under capacity. Constant shapes mean every device
        kernel compiles once for the whole sequence — a growing-model
        variant recompiled downsample/normals/ICP on every frame.

        Returns (model', overflow') where overflow' tracks (on device, no
        host sync) how far voxel occupancy exceeded capacity —
        nonzero(size=cap) silently drops voxels past the cap, so the
        overflow is surfaced once per sequence instead.
        """
        if overflow is None:
            overflow = jnp.int32(0)
        T = jnp.asarray(T, dtype=jnp.float32)
        pts = jnp.matmul(
            cloud.points, T[:3, :3].T, precision=jax.lax.Precision.HIGHEST
        ) + T[:3, 3]
        new_pts = jnp.concatenate([model.points, pts])
        new_valid = jnp.concatenate([model.valid, cloud.valid])
        new_col = None
        if model.has_colors and cloud.has_colors:
            new_col = jnp.concatenate([model.colors, cloud.colors])
        merged = make_cloud(new_pts, colors=new_col, valid=new_valid)
        # compact under capacity: voxel-average (the reference downsamples
        # every optimization_modulus frames anyway, stitcher.py:151), then
        # gather the valid slots to the front (they are scattered at voxel
        # segment starts after the sort-based downsample)
        merged = voxel_downsample(merged, self.voxel_size)
        cap = self.model_capacity
        (idx,) = jnp.nonzero(merged.valid, size=cap, fill_value=0)
        count = jnp.sum(merged.valid)
        overflow = jnp.maximum(overflow, (count - cap).astype(jnp.int32))
        valid = jnp.arange(cap) < count
        return (
            PointCloud(
                merged.points[idx],
                valid,
                merged.colors[idx] if merged.has_colors else merged.colors,
                merged.normals[idx] if merged.has_normals else merged.normals,
            ),
            overflow,
        )

    def stitch_sequence(self, color_images, depth_images, poses=None) -> PointCloud:
        """Incremental frame-to-model stitching (``stitcher.py:114-166``):
        register frame i to the merged model, transform + append + voxel
        compaction, and every ``optimization_modulus`` frames statistical
        outlier removal.

        ``poses`` (optional (F, 4, 4) cam->world) seeds each registration —
        pass robot-FK camera poses for the scan-plan-capture loop.

        The whole register+merge loop runs as ONE ``lax.scan`` dispatch:
        every per-frame stage is fixed-shape (fixed-capacity model buffer,
        mask-based downsample/outlier removal, while_loop ICP), so the
        sequence compiles once and runs with zero host round trips (a
        host loop paid ~6 dispatches per frame).
        """
        if len(color_images) != len(depth_images):
            raise ValueError("Number of color and depth images must match")

        first = self.create_point_cloud_from_rgbd(color_images[0], depth_images[0])
        # seed the fixed-capacity model buffer by merging the first frame
        # into an empty buffer through the same voxel-compaction path
        # (a direct slice-to-capacity would truncate the 307k-pixel frame
        # to its first rows — the bug that broke the first iteration)
        cap = self.model_capacity
        has_col = first.has_colors
        combined = PointCloud(
            jnp.zeros((cap, 3), dtype=jnp.float32),
            jnp.zeros(cap, dtype=bool),
            jnp.zeros((cap, 3), dtype=jnp.float32)
            if has_col
            else jnp.zeros((0, 3), dtype=jnp.float32),
            jnp.zeros((0, 3), dtype=jnp.float32),
        )
        T0 = (
            jnp.asarray(poses[0], dtype=jnp.float32)
            if poses is not None
            else jnp.eye(4, dtype=jnp.float32)
        )
        combined, overflow = self._model_append(combined, first, T0)

        F = len(color_images)
        if F > 1:
            depths = jnp.stack(
                [jnp.asarray(d) for d in depth_images[1:]]
            )
            cols = (
                jnp.stack([jnp.asarray(c) for c in color_images[1:]])
                if has_col
                else jnp.zeros((F - 1, 0, 0, 3), dtype=jnp.uint8)
            )
            pose_seq = (
                jnp.asarray(np.stack(poses[1:]), dtype=jnp.float32)
                if poses is not None
                else jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (F - 1, 4, 4))
            )
            use_pose = poses is not None

            def step(carry, inp):
                model, overflow, i, T_prev, T_prev2 = carry
                depth_i, color_i, init = inp
                if not use_pose:
                    # pose-free capture: constant-velocity seed — predict
                    # this frame's transform by extrapolating the last
                    # step's camera motion, T_prev @ (T_prev2^-1 T_prev).
                    # Raw previous-pose chaining only works when frames
                    # are video-dense; an orbiting scan moves ~10-25 deg
                    # per frame, which a same-pose seed cannot bridge.
                    R2, t2 = T_prev2[:3, :3], T_prev2[:3, 3]
                    inv2 = (
                        jnp.eye(4, dtype=T_prev2.dtype)
                        .at[:3, :3].set(R2.T)
                        .at[:3, 3].set(-jnp.matmul(R2.T, t2, precision=_HI))
                    )
                    init = jnp.matmul(
                        T_prev,
                        jnp.matmul(inv2, T_prev, precision=_HI),
                        precision=_HI,
                    )
                current_full = self.create_point_cloud_from_rgbd(
                    color_i if has_col else None, depth_i
                )
                # compact the frame to a fixed buffer BEFORE registration:
                # every downstream stage (normals kNN, downsample sorts,
                # ICP correspondence) then runs on fixed-size clouds
                # instead of the raw 307k-pixel cloud. The frame buffer is
                # sized independently of the model: one frustum sees far
                # fewer voxels than the whole scene, and ICP's pairwise
                # cost is frame_slots x model_cap.
                fcap = int(getattr(self, "frame_capacity", 0)) or cap
                down = voxel_downsample(current_full, self.voxel_size)
                (cidx,) = jnp.nonzero(down.valid, size=fcap, fill_value=0)
                ccount = jnp.sum(down.valid)
                overflow = jnp.maximum(
                    overflow, (ccount - fcap).astype(jnp.int32)
                )
                current = PointCloud(
                    down.points[cidx],
                    jnp.arange(fcap) < ccount,
                    down.colors[cidx] if down.has_colors else down.colors,
                    down.normals[cidx] if down.has_normals else down.normals,
                )
                T, fit = self._register_j(current, model, init)
                integrate = jnp.bool_(True)
                s1 = s_best = jnp.float32(1.0)
                if not use_pose:
                    # odometry chaining breaks when the camera jumps
                    # beyond ICP's capture basin (arc transitions in the
                    # multi-arc scan protocol), and on smooth objects the
                    # broken solve can still report HIGH loose-threshold
                    # fitness (confidently locked to the wrong side) — so
                    # gate on the tight-threshold score instead, and
                    # re-solve from an FPFH+RANSAC global initialization
                    # when it collapses. The global candidate must beat
                    # the chained one by a margin: near-symmetric objects
                    # make feature matching ambiguous, and the chained
                    # seed carries a motion prior the score should not
                    # discard on noise.
                    s1 = self._tight_score_j(current, model, T)

                    def _rescue(args):
                        T0, fit0, s0 = args
                        keys = jax.random.split(
                            jax.random.fold_in(jax.random.PRNGKey(17), i),
                            self.global_rescue_tries,
                        )

                        def body(best, kk):
                            Tb, fitb, sb = best
                            Tg = self._global_init_j(current, model, key=kk)
                            Tr, fitr = self._register_j(current, model, Tg)
                            sr = self._tight_score_j(current, model, Tr)
                            take = sr > sb
                            return (
                                jnp.where(take, Tr, Tb),
                                jnp.where(take, fitr, fitb),
                                jnp.maximum(sr, sb),
                            ), None

                        (Tg_b, fitg_b, sg_b), _ = jax.lax.scan(
                            body, (T0, fit0, jnp.float32(0.0)), keys
                        )
                        better = sg_b > s0 * 1.15
                        return (
                            jnp.where(better, Tg_b, T0),
                            jnp.where(better, fitg_b, fit0),
                            jnp.where(better, sg_b, s0),
                        )

                    T, fit, s_best = jax.lax.cond(
                        s1 < self.global_rescue_score,
                        _rescue,
                        lambda args: args,
                        (T, fit, s1),
                    )
                    # neither the chained nor the rescued registration
                    # locked: drop the frame (never integrate an unlocked
                    # frame — it poisons the model) and hold the odometry
                    # chain at its last locked state so the next frame
                    # re-extrapolates from a sane pose.
                    integrate = s_best >= self.integrate_score_floor
                    T = jnp.where(integrate, T, T_prev)
                    fit = jnp.where(integrate, fit, 0.0)
                if use_pose:
                    # trust-region gating against the known pose: smooth,
                    # low-texture objects let ICP slide along flat cost
                    # directions; corrections beyond the camera-pose error
                    # budget are rejected in favor of the prior.
                    d = jnp.matmul(T, jnp.linalg.inv(init), precision=_HI)
                    rot_err = jnp.arccos(
                        jnp.clip((jnp.trace(d[:3, :3]) - 1) / 2, -1, 1)
                    )
                    bad = (
                        jnp.linalg.norm(d[:3, 3]) > self.pose_trust_trans
                    ) | (rot_err > self.pose_trust_rot)
                    T = jnp.where(bad, init, T)
                model, overflow = jax.lax.cond(
                    integrate,
                    lambda mo: self._model_append(mo[0], current, T, mo[1]),
                    lambda mo: mo,
                    (model, overflow),
                )
                # outlier_std_ratio default 2.0 matches the reference
                # (stitcher.py:158-159). The statistic is GLOBAL: in a
                # mixed-density scene (dense tabletop + one object) the
                # dominant surface sets a tight threshold that scrubs the
                # object's rim/tip points as "outliers" — loosen it (or
                # set optimization_modulus high) for tabletop scans.
                std_ratio = float(getattr(self, "outlier_std_ratio", 2.0))
                model = jax.lax.cond(
                    (jnp.mod(i, self.optimization_modulus) == 0)
                    & (jnp.sum(model.valid) > 1000),
                    lambda m: remove_statistical_outliers(m, 20, std_ratio),
                    lambda m: m,
                    model,
                )
                # on a dropped frame the odometry chain does not advance
                new_prev2 = jnp.where(integrate, T_prev, T_prev2)
                return (
                    (model, overflow, i + 1, T, new_prev2),
                    (fit, T, s1, s_best),
                )

            # dispatch in blocks: one lax.scan per <= frames_per_block
            # frames (compile reused across equal-length blocks)
            fpb = int(getattr(self, "frames_per_block", 8))
            scan_fn = jax.jit(partial(jax.lax.scan, step))
            carry = (combined, overflow, jnp.int32(1),
                     jnp.eye(4, dtype=jnp.float32),
                     jnp.eye(4, dtype=jnp.float32))
            fits, Ts, scores = [], [], []
            for b0 in range(0, F - 1, fpb):
                b1 = min(b0 + fpb, F - 1)
                carry, (f_block, T_block, s1_b, sb_b) = scan_fn(
                    carry, (depths[b0:b1], cols[b0:b1], pose_seq[b0:b1])
                )
                fits.append(f_block)
                Ts.append(T_block)
                scores.append(np.stack([np.asarray(s1_b), np.asarray(sb_b)], 1))
            combined, overflow = carry[0], carry[1]
            self.last_fits = np.concatenate([np.asarray(f) for f in fits])
            self.last_transforms = np.concatenate(
                [np.asarray(t) for t in Ts]
            )
            # (F-1, 2): chained tight score, accepted tight score
            self.last_scores = np.concatenate(scores)

        overflow = int(overflow)
        if overflow > 0:
            import warnings

            warnings.warn(
                f"stitcher model buffer overflowed by {overflow} voxels "
                f"(capacity {self.model_capacity}); geometry was dropped — "
                "raise model_capacity or voxel_size",
                RuntimeWarning,
                stacklevel=2,
            )
        return combined

    # ------------------------------------------------------------------
    def visualize_registration(self, source, target, transformed=None,
                               path="registration.html"):
        """Headless twin of the reference's registration viewer
        (``stitcher.py:168-200``): overlay source/target/(transformed)
        clouds in one scene, painting uncolored clouds red/green/blue
        exactly as the reference does, and write an interactive HTML
        orbit view instead of opening an Open3D GL window (this
        framework is headless by design — see viz/html_export.py).

        Returns the written path.
        """
        from reconplan_tpu.viz.html_export import export_cloud_html

        paint = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
        pts_all, col_all = [], []
        clouds = [source, target] + ([transformed] if transformed is not None
                                     else [])
        for cloud, default_rgb in zip(clouds, paint):
            pts, cols, _ = cloud.compact()
            if len(cols) != len(pts):
                cols = np.tile(np.asarray(default_rgb, np.float32),
                               (len(pts), 1))
            pts_all.append(pts)
            col_all.append(cols)
        return export_cloud_html(
            np.concatenate(pts_all) if pts_all else np.zeros((0, 3)),
            path,
            colors=np.concatenate(col_all) if col_all else None,
        )

    # ------------------------------------------------------------------
    # dataset loaders (stitcher.py:202-258)
    # ------------------------------------------------------------------
    def load_default(self):
        return self.load_dataset_two_folders("./camera", "rgb", "depth")

    def load_dataset_two_folders(self, folder_path, rgb_foldername, depth_foldername):
        fs = load_rgbd_folder(
            folder_path,
            rgb_foldername,
            depth_foldername,
            truncate_to_multiple=self.optimization_modulus,
        )
        return list(fs.color), list(fs.depth)

    def load_dataset_realsense(self, rgb_folder, depth_folder):
        import os

        parent = os.path.dirname(rgb_folder.rstrip("/"))
        fs = load_rgbd_folder(
            parent,
            os.path.basename(rgb_folder.rstrip("/")),
            os.path.basename(depth_folder.rstrip("/")),
            truncate_to_multiple=self.optimization_modulus,
        )
        return list(fs.color), list(fs.depth)
