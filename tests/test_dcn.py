"""Multi-HOST (DCN) dryrun: 2 jax.distributed processes x 4 CPU devices.

The single-host mesh tests (tests/test_parallel.py) exercise every sharded kernel on a
single-process 8-device CPU mesh; what they cannot exercise is the
multi-process code path — global mesh construction from
``jax.devices()`` spanning processes, cross-process collectives, and
``multihost_utils`` data plumbing (SURVEY §5 comm row: DCN is the one
parallel axis a single host can't touch). This test spawns two real
processes via ``jax.distributed.initialize`` on the CPU backend (Gloo
collectives) and runs:

  1. a global psum through ``shard_map`` over the 8-device global mesh
     (the TSDF scatter-reduce pattern of ``parallel/fusion.py``);
  2. the z-slab sharded TSDF integration (``parallel/fusion.py``) on a
     tiny grid, checked against the single-process dense result.

Skips (not fails) when this jax build lacks multi-process CPU
collectives, recording why — the point is to exercise the path wherever
the toolchain allows, per VERDICT round-4 item 8.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
import numpy as np
pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
    initialization_timeout=60,
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())  # 2 hosts x 4 local

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from jax.experimental import multihost_utils

mesh = Mesh(np.array(jax.devices()).reshape(8), ("space",))

# ---- 1. cross-process psum (the TSDF scatter-reduce pattern) ----
def body(x):
    return jax.lax.psum(x, "space")

f = jax.jit(shard_map(body, mesh=mesh,
                      in_specs=P("space"), out_specs=P("space")))
x = multihost_utils.host_local_array_to_global_array(
    np.arange(4, dtype=np.float32)[:, None] + 10 * pid, mesh, P("space"))
y = f(x)
got = multihost_utils.global_array_to_host_local_array(y, mesh, P("space"))
# global vector = [0,1,2,3, 10,11,12,13]; psum over 8 shards = 52 per row
assert np.allclose(np.asarray(got), 52.0), np.asarray(got)

# ---- 2. z-slab sharded TSDF on the global mesh ----
sys.path.insert(0, os.environ["RECONPLAN_REPO"])
from reconplan_tpu.parallel.fusion import (
    make_sharded_grid,
    sharded_integrate_frames,
)
from reconplan_tpu.ops import tsdf as tsdf_ops

H, W = 64, 256
fx = fy = 80.0; cx, cy = W / 2, H / 2
r = 0.1
u = (np.arange(W) - cx) / fx
v = (np.arange(H) - cy) / fy
uu, vv = np.meshgrid(u, v)
depths, poses = [], []
for k in range(2):
    ang = 2 * np.pi * k / 2
    eye = np.array([0.4 * np.cos(ang), 0.4 * np.sin(ang), 0.0])
    z = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    xv = np.cross(up, z); xv /= np.linalg.norm(xv)
    yv = np.cross(z, xv)
    T = np.eye(4); T[:3, :3] = np.stack([xv, yv, z], 1); T[:3, 3] = eye
    dirs = np.stack([uu, vv, np.ones_like(uu)], -1) @ T[:3, :3].T
    a = (dirs * dirs).sum(-1); b = 2 * (dirs * eye).sum(-1)
    c = eye @ eye - r * r
    disc = b * b - 4 * a * c
    t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    depths.append((np.where(t > 0, t, 0.0) * 1000.0).astype(np.float32))
    poses.append(T.astype(np.float32))
depths = np.stack(depths); poses = np.stack(poses)

dims = (32, 32, 32); vox = 0.3 / 31; origin = (-0.15, -0.15, -0.15)
g = make_sharded_grid(dims, origin, vox, mesh=mesh)
g = sharded_integrate_frames(
    g, jnp.asarray(depths), jnp.asarray(poses), fx, fy, cx, cy, mesh=mesh)
sdf_g = multihost_utils.process_allgather(g.sdf, tiled=True)

dense = tsdf_ops.make_grid(dims, origin, vox)
dense = tsdf_ops.integrate_frames(
    dense, jnp.asarray(depths), jnp.asarray(poses), fx, fy, cx, cy)
ref = np.asarray(dense.sdf)
err = np.abs(np.asarray(sdf_g) - ref).max()
assert err < 1e-5, err
print(f"proc {pid}: psum ok, sharded tsdf max err {err:.2e}")
jax.distributed.shutdown()
"""


@pytest.mark.slow
def test_two_process_dcn_dryrun(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = "52717"
    env = dict(os.environ, RECONPLAN_REPO=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=REPO, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    joined = "\n".join(outs)
    if any(p.returncode != 0 for p in procs):
        lowered = joined.lower()
        if ("gloo" in lowered or "collectives" in lowered
                or "unimplemented" in lowered):
            pytest.skip(f"multi-process CPU collectives unavailable: "
                        f"{joined[-500:]}")
        raise AssertionError(joined[-3000:])
    assert "sharded tsdf max err" in joined
