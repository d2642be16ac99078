"""Smoke test of the main path on one GPU (or the mesh path on four).

Runs, as one process, each phase below at the sizes users run; every
phase raises on failure and nothing falls back to the CPU:

  A. device: JAX must find a GPU;
  B. fusion at 512^3 (``bench.py``'s 32-frame 640x480 sphere orbit): the
     brick engine, with and without colour, against the dense reference
     engine ``ops.tsdf.integrate_frames``;
  C. capture: one D435 frame of the banana rendered on the GPU and on the
     CPU device;
  D. the closed-loop scan ``apps.scan.run_scan`` (plan, capture, fuse,
     close, stitch) at 512^3 with 24 images;
  E. precision: FK golden parity, an ICP fixture, and top-k neighbours
     against float64 numpy.

``--four-cards`` runs only the mesh path on a 1-D mesh of 4 GPUs: the
brick-sharded fusion against the single-card brick engine, the z-sharded
dense fusion against ``ops.tsdf`` on one card, and the sharded IK against
``dls_ik_batch``.

Earlier lines report the card (``nvidia-smi`` name and power limit), the
JAX version and each phase's times and errors; the last line is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))

N = 512  # bench grid edge
F = 32  # bench frames
MAX_ACTIVE = 8192


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# B. fusion at 512^3
# ---------------------------------------------------------------------------


def bench_colors(n_frames, H, W):
    """Deterministic u8 colour frames (u, v and frame index ramps)."""
    c = np.zeros((n_frames, H, W, 3), np.uint8)
    c[..., 0] = (np.arange(W) * 255 // W)[None, None, :]
    c[..., 1] = (np.arange(H) * 255 // H)[None, :, None]
    c[..., 2] = (np.arange(n_frames) * 37 % 256)[:, None, None]
    return c


@jax.jit
def compare_to_dense(sb, wb, cb, sd, wd, cd):
    """Brick (s, w, colour) vs dense reference, reduced on the device.

    A voxel of a brick active in a chunk gets exactly the dense update for
    that chunk; it misses the dense update of chunks where its brick is
    inactive (free space far in front of the surface, mostly, and a few
    in-band observations the centre-sampled selection does not see). So:
    the brick never counts more observations than the dense engine, the
    sdf and colour agree wherever both counted the same, almost every
    in-band dense voxel (|sdf| < 1: the surface marching cubes extracts)
    is observed, and almost every observed in-band voxel has the full
    dense weight. Free-space voxels outside the band may miss
    observations."""
    m = wb > 0
    eq = m & (wb == wd)
    band = (jnp.abs(sd) < 1.0) & (wd > 0)
    out = {
        "touched": jnp.sum(m),
        "weight_differs": jnp.sum(m & (wb != wd)),
        "weight_exceeds": jnp.sum(m & (wb > wd)),
        "sdf_max_err": jnp.max(jnp.where(eq, jnp.abs(sb - sd), 0.0)),
        "in_band": jnp.sum(band),
        "in_band_covered": jnp.sum(band & m),
        "in_band_weight_differs": jnp.sum(band & m & (wb != wd)),
    }
    if cb is not None:
        out["color_max_err"] = jnp.max(
            jnp.where(eq[..., None], jnp.abs(cb - cd), 0.0))
    return out


def phase_fusion(n=N, n_frames=F, H=480, W=640, max_active=MAX_ACTIVE):
    from bench import make_frames
    from reconplan_tpu.ops import tsdf as tsdf_ops
    from reconplan_tpu.ops import tsdf_brick as tb

    fx_scale = W / 640.0
    depths, poses, (fx, fy, cx, cy) = make_frames(
        n_frames, H=H, W=W, fx=615.67 * fx_scale, fy=615.96 * fx_scale)
    colors = bench_colors(n_frames, H, W)
    depths_d, poses_d = jnp.asarray(depths), jnp.asarray(poses)
    colors_d = jnp.asarray(colors)
    origin, vox = (-0.4, -0.4, -0.3), 0.8 / (n - 1)
    n_chunks = math.ceil(n_frames / 8)

    def brick(grid, with_color):
        return tb.integrate_frames_bricked_device(
            grid, depths_d, poses_d, fx, fy, cx, cy,
            colors=colors_d if with_color else None, max_active=max_active)

    res = {}
    for with_color in (False, True):
        tag = "brick_rgb" if with_color else "brick"
        fresh = lambda: tb.make_brick_grid(  # noqa: E731
            (n,) * 3, origin, vox, with_color=with_color)
        (grid, n_active), t_first = timed(brick, fresh(), with_color)
        # the first grid is kept for the comparison; the steady window
        # integrates into the cold-timed one (calls donate their grid)
        (live, _), t_cold = timed(brick, jax.block_until_ready(fresh()),
                                  with_color)
        t0 = time.perf_counter()
        for _ in range(5):
            live, _ = brick(live, with_color)
        jax.block_until_ready(live)
        t_steady = (time.perf_counter() - t0) / 5
        per_chunk = np.asarray(n_active)
        log(f"  {tag}: first call {t_first:.3f} s (compile + run), "
            f"cold grid {n_frames / t_cold:.1f} fps, steady "
            f"{n_frames / t_steady:.1f} fps, active bricks per chunk "
            f"{per_chunk.tolist()}")
        check(per_chunk.shape == (n_chunks,) and per_chunk.max() <= max_active,
              f"{tag}: no chunk over the {max_active}-brick cap")
        res[tag] = dict(grid=grid, fps=n_frames / t_steady,
                        cold_fps=n_frames / t_cold,
                        compile_s=t_first - t_cold)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak device bytes after brick runs: "
        f"{stats.get('peak_bytes_in_use', 'n/a')}")

    dense_fn = lambda g, c: tsdf_ops.integrate_frames(  # noqa: E731
        g, depths_d, poses_d, fx, fy, cx, cy,
        colors=None if c is None else c.astype(jnp.float32) / 255.0)
    fresh_dense = lambda c: tsdf_ops.make_grid(  # noqa: E731
        (n,) * 3, origin, vox, with_color=c)
    live, t_first = timed(dense_fn, fresh_dense(False), None)
    _, t_cold = timed(dense_fn, jax.block_until_ready(fresh_dense(False)),
                      None)
    _, t_steady = timed(dense_fn, live, None)
    log(f"  dense: first call {t_first:.3f} s (compile + run), cold grid "
        f"{n_frames / t_cold:.1f} fps, steady {n_frames / t_steady:.1f} fps")
    del live
    dense, _ = timed(dense_fn, fresh_dense(True), colors_d)

    for tag in ("brick", "brick_rgb"):
        g = res[tag]["grid"]
        sb, wb = tb.to_dense(g)
        cb = tb.to_dense_color(g) if tag == "brick_rgb" else None
        r = {k: float(v) for k, v in compare_to_dense(
            sb, wb, cb, dense.sdf, dense.weight,
            dense.color if cb is not None else None).items()}
        log(f"  {tag} vs dense: {json.dumps(r)}")
        check(r["weight_exceeds"] == 0,
              f"{tag}: weight never above the dense weight")
        check(r["in_band_weight_differs"] <= 1e-3 * r["in_band_covered"],
              f"{tag}: full dense weight on >= 99.9% of observed in-band "
              f"voxels ({r['in_band_weight_differs']:.0f} differ; all "
              f"touched voxels: {r['weight_differs'] / max(r['touched'], 1):.4%})")
        check(r["sdf_max_err"] <= 1e-5,
              f"{tag}: sdf within 1e-5 trunc units where weights agree")
        check(r["in_band_covered"] >= 0.999 * r["in_band"],
              f"{tag}: >= 99.9% of dense in-band voxels observed "
              f"({r['in_band_covered'] / max(r['in_band'], 1):.5%})")
        if cb is not None:
            check(r["color_max_err"] <= 8 / 255,
                  f"{tag}: colour within 8/255 where weights agree")
        del sb, wb, cb
    return {tag: {k: v for k, v in d.items() if k != "grid"}
            for tag, d in res.items()}


# ---------------------------------------------------------------------------
# C. capture
# ---------------------------------------------------------------------------


def phase_capture():
    from reconplan_tpu.apps.scan import BANANA_MESH, D435, OBJECT_POINT
    from reconplan_tpu.io.render import SplatCamera

    eye = [OBJECT_POINT[0] + 0.2, OBJECT_POINT[1] - 0.15, 0.25]
    out = {}
    for name, dev in (("gpu", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            cam = SplatCamera(**D435)
            cam.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
            cam.take_picture(eye, OBJECT_POINT)  # compile
            t0 = time.perf_counter()
            d, _, _ = cam.take_picture(eye, OBJECT_POINT)
            out[name] = d / 1000.0
            log(f"  render on {name}: {time.perf_counter() - t0:.4f} s/frame "
                f"(warm)")
    g, c = out["gpu"], out["cpu"]
    both = (g > 0) & (c > 0)
    err = float(np.abs(g - c)[both].max()) if both.any() else float("inf")
    cov_g, cov_c = float((g > 0).mean()), float((c > 0).mean())
    log(f"  depth max |gpu - cpu| = {err:.3e} m over {int(both.sum())} "
        f"pixels; coverage gpu {cov_g:.5f} cpu {cov_c:.5f}")
    check(both.sum() > 1000, "the banana is in view")
    check(err <= 1e-4, "depth within 1e-4 m where both hit")
    check(abs(cov_g - cov_c) <= 1e-3, "hit coverage within 0.1%")
    return {"depth_max_err_m": err, "coverage_gpu": cov_g,
            "coverage_cpu": cov_c}


# ---------------------------------------------------------------------------
# D. the closed-loop scan
# ---------------------------------------------------------------------------


def phase_scan():
    from reconplan_tpu.apps.scan import run_scan

    t0 = time.perf_counter()
    r = run_scan(
        roadmap_dir=os.path.join(REPO, "graph", "ur10", "rot_free"),
        n_waypoints=500, n_images=24,
        out_dir=os.path.join(REPO, "scan_output", "chip_smoke"),
        reconstruct="both", grid_dim=512, close_mesh="auto",
        close_depth=192,
    )
    log(f"  scan wall {time.perf_counter() - t0:.1f} s; waypoints solved "
        f"{r['waypoints_solved']}/500; stage timings "
        f"{json.dumps(r['stage_timings'])}")
    log(f"  best mesh {r.get('best_mesh')} {r.get('best_chamfer_mm')} mm; "
        f"stitch {r.get('stitch_chamfer_mm')} mm")
    check(r["best_chamfer_mm"] <= 1.5, "best_chamfer_mm <= 1.5")
    check(math.isfinite(r.get("stitch_chamfer_mm", float("nan"))),
          "stitch_chamfer_mm is finite")
    return {k: r[k] for k in ("waypoints_solved", "best_mesh",
                              "best_chamfer_mm", "stitch_chamfer_mm",
                              "stage_timings")}


# ---------------------------------------------------------------------------
# E. precision
# ---------------------------------------------------------------------------


def _load_golden():
    import re

    def nums(s):
        return [float(x) for x in
                re.findall(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", s)]

    def rows(name):
        with open(os.path.join(REPO, "data", "golden", name)) as f:
            return np.array([nums(line.split(",", 1)[1]) for line in f])

    return rows("ctraj.txt"), rows("wtraj.txt")


def phase_precision(n_nn=8192):
    from reconplan_tpu.core import maths
    from reconplan_tpu.kin import UR10
    from reconplan_tpu.ops import icp_point_to_point
    from reconplan_tpu.ops.nn import knn
    from reconplan_tpu.ops.pointcloud import make_cloud

    ur10 = UR10("ur10", [[-1, 1], [-1, 1], [-0.5, 1]], [0, 0, 1],
                [-np.pi, 0, 0])
    ctraj, wtraj = _load_golden()
    pos, _ = ur10.solve_fk_batch(ctraj.astype(np.float32))
    fk_err = float(np.linalg.norm(np.asarray(pos)[:, -1] - wtraj[:, :3],
                                  axis=-1).max())
    log(f"  FK golden max position error {fk_err:.3e} m")
    check(fk_err <= 1e-5, "FK golden parity within 1e-5 m")

    # tests/test_ops_icp.py::TestICP::test_point_to_point_recovers_pose
    rng = np.random.default_rng(42)
    d = rng.normal(size=(1500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = 0.5 + 0.05 * np.sin(5 * d[:, 0]) + 0.04 * np.cos(7 * d[:, 1])
    pts = (d * r[:, None]).astype(np.float32)
    rv, t = rng.normal(size=3) * 0.08, rng.normal(size=3) * 0.03
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(maths.quat_to_matrix(
        maths.rotvec_to_quat(jnp.asarray(rv))))
    T[:3, 3] = t
    res = icp_point_to_point(
        make_cloud(pts), make_cloud((pts @ T[:3, :3].T + T[:3, 3])
                                    .astype(np.float32)),
        max_correspondence_distance=0.1)
    delta = np.asarray(res.transformation) @ np.linalg.inv(T)
    rot_err = float(np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2,
                                      -1, 1)))
    trans_err = float(np.linalg.norm(delta[:3, 3]))
    log(f"  ICP point-to-point: rot err {rot_err:.3e} rad, trans err "
        f"{trans_err:.3e} m, fitness {float(res.fitness):.4f}")
    check(rot_err < 5e-3 and trans_err < 2e-3 and float(res.fitness) > 0.95,
          "ICP fixture within its test's tolerance")

    k = 8
    p = np.random.default_rng(1).uniform(-1, 1, (n_nn, 3)).astype(np.float32)
    _, idx = knn(jnp.asarray(p), jnp.asarray(p), k)
    idx = np.asarray(idx)
    p64 = p.astype(np.float64)
    bad = 0
    for i0 in range(0, n_nn, 1024):
        q = p64[i0:i0 + 1024]
        d2 = ((q[:, None, :] - p64[None]) ** 2).sum(-1)
        ref = np.sort(d2, axis=1)
        got = np.take_along_axis(d2, idx[i0:i0 + 1024], axis=1)
        # same neighbour set up to ties: the k distances agree with the
        # float64 k smallest to the float32 rounding of a distance
        bad += int((np.abs(np.sort(got, axis=1) - ref[:, :k])
                    > 1e-6 * np.maximum(ref[:, :k], 1e-12) + 1e-12)
                   .any(axis=1).sum())
    log(f"  top-{k} on {n_nn} points: {bad} queries differ from float64")
    check(bad == 0, "top-k neighbours equal the float64 reference")
    return {"fk_max_err_m": fk_err, "icp_rot_err": rot_err,
            "icp_trans_err": trans_err, "knn_mismatched_queries": bad}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _spread(arr, mesh):
    """Each mesh device holds one distinct, equal-sized shard."""
    shards = arr.addressable_shards
    devs = {s.device for s in shards}
    sizes = {s.data.shape for s in shards}
    return devs == set(mesh.devices.flat) and len(sizes) == 1 \
        and len(shards) == mesh.devices.size


def phase_four_cards(n=N, n_frames=F, H=480, W=640, n_ik=4096):
    from bench import make_frames
    from reconplan_tpu.kin import UR10, dls_ik_batch
    from reconplan_tpu.ops import tsdf as tsdf_ops
    from reconplan_tpu.ops import tsdf_brick as tb
    from reconplan_tpu.parallel import (
        gather_grid, make_mesh, make_sharded_grid, sharded_ik_solve,
        sharded_integrate_frames,
    )
    from reconplan_tpu.parallel.brick import (
        gather_brick_grid, make_sharded_brick_grid,
        sharded_integrate_frames_bricked,
    )

    mesh = make_mesh(4)
    check(mesh.devices.size == 4, "a 1-D mesh of 4 devices")
    s = W / 640.0
    depths, poses, (fx, fy, cx, cy) = make_frames(
        n_frames, H=H, W=W, fx=615.67 * s, fy=615.96 * s)
    origin, vox = (-0.4, -0.4, -0.3), 0.8 / (n - 1)

    # brick-sharded vs the single-card brick engine (same selection)
    g1, n1 = tb.integrate_frames_bricked_device(
        tb.make_brick_grid((n,) * 3, origin, vox), depths, poses,
        fx, fy, cx, cy, max_active=MAX_ACTIVE)
    g4 = make_sharded_brick_grid((n,) * 3, origin, vox, mesh=mesh)
    (g4, n4), t4 = timed(
        lambda g: sharded_integrate_frames_bricked(
            g, depths, poses, fx, fy, cx, cy, mesh=mesh,
            max_active_per_device=MAX_ACTIVE), g4)
    check(_spread(g4.sdf, mesh) and _spread(g4.weight, mesh),
          "brick rows sharded over the 4 devices")
    _, t4_warm = timed(
        lambda g: sharded_integrate_frames_bricked(
            g, depths, poses, fx, fy, cx, cy, mesh=mesh,
            max_active_per_device=MAX_ACTIVE),
        make_sharded_brick_grid((n,) * 3, origin, vox, mesh=mesh))
    n4 = np.asarray(n4)
    log(f"  brick-sharded: first call {t4:.3f} s, cold grid "
        f"{n_frames / t4_warm:.1f} fps; active bricks per device and chunk "
        f"{n4.tolist()}")
    check(n4.max() <= MAX_ACTIVE, "no shard over its brick cap")
    check(int(n4.sum()) == int(np.asarray(n1).sum()),
          "sharded active count equals the single-card count")
    g4 = gather_brick_grid(g4)
    s_err = float(jnp.max(jnp.abs(g4.sdf - g1.sdf)))
    w_err = float(jnp.max(jnp.abs(g4.weight - g1.weight)))
    exact = bool(jnp.array_equal(g4.sdf, g1.sdf)) and bool(
        jnp.array_equal(g4.weight, g1.weight))
    log(f"  brick-sharded vs single card: max sdf err {s_err:.3e}, "
        f"weight err {w_err:.3e}, bit-identical {exact}")
    check(s_err <= 1e-6 and w_err <= 1e-6, "brick-sharded within 1e-6")
    del g1, g4

    # z-sharded dense vs ops.tsdf on one card
    dense1 = tsdf_ops.integrate_frames(
        tsdf_ops.make_grid((n,) * 3, origin, vox), jnp.asarray(depths),
        jnp.asarray(poses), fx, fy, cx, cy)
    gz = make_sharded_grid((n,) * 3, origin, vox, mesh=mesh)
    dense_z = lambda g: sharded_integrate_frames(  # noqa: E731
        g, depths, poses, fx, fy, cx, cy, mesh=mesh)
    gz, tz = timed(dense_z, gz)
    _, tz_warm = timed(dense_z, make_sharded_grid((n,) * 3, origin, vox,
                                                  mesh=mesh))
    check(_spread(gz.sdf, mesh), "dense grid sharded along z over 4 devices")
    log(f"  z-sharded dense: first call {tz:.3f} s, cold grid "
        f"{n_frames / tz_warm:.1f} fps")
    gz = gather_grid(gz)
    zs = float(jnp.max(jnp.abs(gz.sdf - dense1.sdf)))
    zw = float(jnp.max(jnp.abs(gz.weight - dense1.weight)))
    log(f"  z-sharded vs one card: max sdf err {zs:.3e}, weight err {zw:.3e}")
    check(zs <= 1e-6 and zw <= 1e-6, "z-sharded dense within 1e-6")
    del dense1, gz

    # sharded IK vs dls_ik_batch on one card
    robot = UR10("ur10", [[-1, 1], [-1, 1], [-0.5, 1]], [0, 0, 1],
                 [-np.pi, 0, 0])
    rng = np.random.default_rng(0)
    seeds = rng.uniform(-1.0, 1.0, (n_ik, 6)).astype(np.float32)
    targets = np.asarray(robot.fk_point_batch(
        rng.uniform(-1.0, 1.0, (n_ik, 6)).astype(np.float32)))
    (q4, ok4), tik = timed(lambda: sharded_ik_solve(
        robot, targets, seeds, mesh=mesh))
    check(_spread(q4, mesh), "IK batch sharded over 4 devices")
    q4, ok4 = np.asarray(q4), np.asarray(ok4)
    pos, rotm, use_rot = robot._ik_targets(targets)

    def one_card(sl):
        r = dls_ik_batch(robot.model, robot._active_tuple, robot.ee_link,
                         pos[sl], rotm[sl], jnp.asarray(seeds[sl]),
                         robot._q_rest, use_rotation=use_rot)
        return np.asarray(r.config), np.asarray(r.success)

    # on the GPU, dls_ik_batch gives some rows other answers at batch 1024
    # than at batch 4096 (not so on the CPU; see PERF.md), and the LM
    # accept/reject tests amplify such last-bit differences. So the
    # sharded solve is held bit for bit to one card solving the same
    # per-device batches, and to one 4096-row batch as far as results go:
    # the same converged set, and every converged row of either solve at
    # a configuration that reaches its target. A row that differs is then
    # either another valid solution or a failed solve in both.
    per = n_ik // 4
    q_sl = np.concatenate([one_card(slice(k * per, (k + 1) * per))[0]
                           for k in range(4)])
    q_full, ok_full = one_card(slice(None))
    err_sl = float(np.abs(q4 - q_sl).max())
    differ = np.abs(q4 - q_full).max(axis=1) > 1e-5

    def reach(q):
        fk = np.asarray(robot.fk_point_batch(q))
        return np.linalg.norm(fk[:, :3] - targets[:, :3], axis=1)

    pos_err, pos_err_full = reach(q4), reach(q_full)
    both = differ & ok4 & ok_full
    log(f"  sharded IK: {n_ik} targets in {tik:.3f} s (first call), "
        f"converged {int(ok4.sum())} (one card, one batch: "
        f"{int(ok_full.sum())}, same set: {bool((ok4 == ok_full).all())}); "
        f"max |dq| vs one card on the same per-device batches {err_sl:.3e} "
        f"rad; rows differing from one {n_ik}-batch by > 1e-5 rad: "
        f"{int(differ.sum())} ({int(both.sum())} converged in both, "
        f"{int((differ & ~ok4 & ~ok_full).sum())} failed in both); max "
        f"position error of converged rows {pos_err[ok4].max():.3e} m "
        f"(one batch: {pos_err_full[ok_full].max():.3e} m)")
    check(err_sl <= 1e-5, "sharded IK within 1e-5 rad of one card on the "
          "same per-device batches")
    check(bool((ok4 == ok_full).all()),
          f"sharded IK converges on the same rows as one {n_ik}-row batch")
    check(max(pos_err[ok4].max(), pos_err_full[ok_full].max()) <= 1e-3 + 1e-6,
          "every converged solution of both solves reaches its target")
    for d in mesh.devices.flat:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        log(f"  {d}: peak bytes in use {peak}")
        check(peak > 0, f"{d} did work")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from bench import card_info
    from reconplan_tpu.utils.compile_cache import enable_compilation_cache

    log(f"phase A: device (jax {jax.__version__})")
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        sys.exit(f"need {want} GPUs, JAX sees {len(jax.devices())}")
    log(f"  cache: {enable_compilation_cache()}")
    log(f"  card: {card_info()}")
    log(f"  devices: {jax.devices()}")

    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [("B fusion 512^3", phase_fusion),
                  ("C capture", phase_capture),
                  ("E precision", phase_precision),
                  ("D closed-loop scan", phase_scan)]
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        fn()
        log(f"  phase {name} took {time.perf_counter() - t0:.1f} s")
    log(f"all phases {time.perf_counter() - t_all:.1f} s")
    d = jax.devices()[0]
    log(f"card: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
