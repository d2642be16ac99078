"""Poisson fidelity eval: EXACT analytic residual + banana Chamfer.

Sampled-Chamfer against a finite GT point set has a point-spacing floor
(~2 mm at 60k samples on the bumpy-sphere fixture) that dominated the
round-2 "1.94 mm" figure. Against an ANALYTIC surface G(p)=0 the honest
per-vertex error is |G(v)| / |grad G(v)| — first-order exact and
sampling-free. This script prints that residual for the three solver
variants (screened / pure / local-iso; see recon/poisson.py) plus the
YCB-banana Chamfer, and is the source of the numbers quoted in
BASELINE.md and the poisson docstrings.

Usage: python benchmarks/eval_poisson_fidelity.py [--depth 128]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from reconplan_tpu.io.meshio import load_mesh, sample_mesh_surface
from reconplan_tpu.recon.metrics import chamfer_to_mesh, points_to_mesh_distance
from reconplan_tpu.recon.poisson import poisson_reconstruct

RNG = np.random.default_rng(0)
R0, A, B = 0.2, 0.05, 0.04
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f_dir(d):
    return R0 + A * jnp.sin(5 * d[..., 0]) + B * jnp.cos(7 * d[..., 1])


def G(p):
    nn = jnp.linalg.norm(p, axis=-1)
    return nn - f_dir(p / nn[..., None])


def bumpy_exact(n):
    d = RNG.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = np.asarray(f_dir(jnp.asarray(d)))
    pts = (d * r[:, None]).astype(np.float32)
    g = jax.vmap(jax.grad(lambda p: G(p)))(jnp.asarray(pts))
    nrm = np.asarray(
        g / jnp.linalg.norm(g, axis=-1, keepdims=True), np.float32
    )
    return pts, nrm


def run_bumpy(tag, pts, nrm, depth, **kw):
    t0 = time.time()
    tris = poisson_reconstruct(pts, nrm, depth=depth, **kw)
    dt = time.time() - t0
    verts = jnp.asarray(tris.reshape(-1, 3))
    res = np.abs(np.asarray(G(verts)))
    gmag = np.asarray(
        jnp.linalg.norm(jax.vmap(jax.grad(lambda p: G(p)))(verts), axis=-1)
    )
    dist = res / np.maximum(gmag, 1e-6)  # first-order exact distance
    print(
        f"{tag:<34} depth={depth} tris={len(tris)} "
        f"mean={dist.mean()*1000:.3f}mm "
        f"q95={np.quantile(dist, 0.95)*1000:.3f}mm "
        f"max={dist.max()*1000:.2f}mm {dt:.1f}s"
    )

    # COVERAGE direction (round-3 verdict: vertex residual alone cannot
    # see MISSING surface). Dense analytic-surface samples -> exact
    # point-to-triangle distance to the mesh — floor-free (the mesh is a
    # continuous surface, not a point cloud), so holes and dropped lobes
    # surface as a fat q99/max tail and a nonzero gap fraction.
    cov_pts, _ = bumpy_exact(50000)
    cd = points_to_mesh_distance(cov_pts, tris)
    gap = float((cd > 2e-3).mean())
    print(
        f"{'':<34} coverage: mean={cd.mean()*1000:.3f}mm "
        f"q99={np.quantile(cd, 0.99)*1000:.3f}mm "
        f"max={cd.max()*1000:.2f}mm frac>2mm={gap*100:.2f}%"
    )
    return dist.mean(), cd


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=128)
    args = ap.parse_args()

    pts, nrm = bumpy_exact(60000)
    run_bumpy("bumpy screened (default)", pts, nrm, args.depth)
    run_bumpy("bumpy pure", pts, nrm, args.depth, screen=0.0)
    run_bumpy(
        "bumpy local_iso", pts, nrm, args.depth, screen=0.0, local_iso=True
    )

    v, f = load_mesh(
        os.path.join(REPO, "data/objects/011_banana/poisson/nontextured.ply")
    )
    bp, bn = sample_mesh_surface(v, f, 60000, seed=0)
    bp, bn = bp.astype(np.float32), bn.astype(np.float32)
    for kw, tag in (
        ({}, "banana screened (default)"),
        ({"screen": 0.0, "local_iso": True}, "banana local_iso"),
    ):
        t0 = time.time()
        tris = poisson_reconstruct(bp, bn, depth=args.depth, **kw)
        dt = time.time() - t0
        ch, m2g, g2m = chamfer_to_mesh(tris.reshape(-1, 3), v, f)
        # coverage direction, floor-free: GT surface samples -> exact
        # distance to the reconstructed triangles
        gt_samp, _ = sample_mesh_surface(v, f, 50000, seed=1)
        cd = points_to_mesh_distance(gt_samp.astype(np.float32), tris)
        print(
            f"{tag:<34} depth={args.depth} tris={len(tris)} "
            f"chamfer={ch*1000:.3f}mm "
            f"(mesh->gt {m2g*1000:.3f} gt->mesh {g2m*1000:.3f}) "
            f"coverage mean={cd.mean()*1000:.3f}mm "
            f"q99={np.quantile(cd, 0.99)*1000:.3f}mm "
            f"frac>2mm={(cd > 2e-3).mean()*100:.2f}% {dt:.1f}s"
        )


if __name__ == "__main__":
    main()
