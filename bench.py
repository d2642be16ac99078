"""Benchmark: brick-engine TSDF fusion throughput at 512^3 on one GPU.

Integrates batches of 32 synthetic 640x480 depth frames (the D435's
resolution; an orbit around a 0.12 m sphere) into a 512^3 brick grid
with ``ops.tsdf_brick.integrate_frames_bricked_device`` and prints ONE
JSON line: steady-state frames/s into a live grid (``value``), one batch
into a fresh grid (``cold_grid_fps``), the first call's compile-and-run
time, and the device it ran on (JAX platform, device kind and count, and
the card's name and power limit from ``nvidia-smi``).

Exits non-zero without a GPU: a CPU number is not a device metric.
``RECONPLAN_TRACE_DIR=<dir>`` adds ``REPS`` traced steady batches after
the timed window and prints, to stderr, their device idle share and top
device operations (``benchmarks/trace_summary.py``; totals over the
traced batches).

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N = 512  # grid edge in voxels
F = 32  # frames per batch
REPS = 10  # batches per timed trial
TRIALS = 3


def make_frames(n_frames, H=480, W=640, fx=615.67, fy=615.96):
    cx, cy = W / 2.0, H / 2.0
    depths, poses = [], []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        eye = np.array([0.5 * np.cos(ang), 0.5 * np.sin(ang), 0.1])
        z = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T = np.eye(4); T[:3, :3] = np.stack([x, y, z], 1); T[:3, 3] = eye
        poses.append(T)
        u = (np.arange(W) - cx) / fx
        v = (np.arange(H) - cy) / fy
        uu, vv = np.meshgrid(u, v)
        dirs = np.stack([uu, vv, np.ones_like(uu)], -1) @ T[:3, :3].T
        a = np.sum(dirs * dirs, -1)
        b = 2 * np.sum(dirs * eye, -1)
        c = np.dot(eye, eye) - 0.12**2
        disc = b * b - 4 * a * c
        t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
        depths.append(np.where(t > 0, t, 0.0).astype(np.float32) * 1000.0)
    return np.stack(depths), np.stack(poses).astype(np.float32), (fx, fy, cx, cy)


def card_info():
    """``nvidia-smi --query-gpu=name,power.limit`` of the visible cards
    (one line each), or why it could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or f"nvidia-smi rc={r.returncode}: {r.stderr.strip()}"


def device_record():
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card_info(),
    }


def main():
    from reconplan_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX backend is "
                 f"{jax.default_backend()!r}")

    from reconplan_tpu.ops import tsdf_brick as tb
    from reconplan_tpu.utils.profiling import maybe_trace

    depths, poses, (fx, fy, cx, cy) = make_frames(F)
    depths_d = jnp.asarray(depths)
    poses_d = jnp.asarray(poses)

    def fresh_grid():
        return tb.make_brick_grid((N, N, N), (-0.4, -0.4, -0.3), 0.8 / (N - 1))

    def batch(grid):
        return tb.integrate_frames_bricked_device(
            grid, depths_d, poses_d, fx, fy, cx, cy, max_active=8192
        )

    t0 = time.perf_counter()
    grid, n_active = jax.block_until_ready(batch(fresh_grid()))
    first_s = time.perf_counter() - t0

    trial_s = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            grid, n_active = batch(grid)
        jax.block_until_ready(grid)
        trial_s.append((time.perf_counter() - t0) / REPS)
    fps = F / float(np.median(trial_s))

    cold = jax.block_until_ready(fresh_grid())
    t0 = time.perf_counter()
    jax.block_until_ready(batch(cold))
    cold_fps = F / (time.perf_counter() - t0)

    if os.environ.get("RECONPLAN_TRACE_DIR"):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "benchmarks"))
        from trace_summary import summarize

        with maybe_trace():
            for _ in range(REPS):
                grid, n_active = batch(grid)
            jax.block_until_ready(grid)
        print(json.dumps({"traced_batches": REPS, **summarize(
            os.environ["RECONPLAN_TRACE_DIR"])}), file=sys.stderr)

    print(json.dumps({
        "metric": f"TSDF integration throughput @ {N}^3 voxels, 640x480 depth",
        "value": fps,
        "unit": "frames/sec",
        "cold_grid_fps": cold_fps,
        "batch_ms": [1e3 * t for t in trial_s],
        "first_call_s": first_s,
        "active_bricks_per_chunk": [int(n) for n in n_active],
        **device_record(),
    }))


if __name__ == "__main__":
    main()
