"""Benchmark: SE3 nearest-neighbor search vs sklearn BallTree (C9 parity).

The reference's GNAT shipped a self-benchmark against BallTree on 1M random
SE3 points (``grr/gnat.py:558-653``). This is the rebuild's equivalent:
exact dense top-k on the default device vs BallTree build+query on CPU. The dense
search has ZERO build time — the quantity the reference's NN structures pay
minutes for (``workspace.py:89-93``).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_points=1_000_000, n_queries=4096, k=5):
    import jax
    import jax.numpy as jnp

    from reconplan_tpu.ops.nn import se3_knn

    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (n_points, 3))
    q = rng.normal(size=(n_points, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pts = np.concatenate([pos, q], -1).astype(np.float32)
    queries = pts[rng.choice(n_points, n_queries, replace=False)]

    pts_d = jnp.asarray(pts)
    queries_d = jnp.asarray(queries)
    # dense top-k on the device (build time: none); first call compiles
    jax.block_until_ready(se3_knn(queries_d, pts_d, k))
    t0 = time.perf_counter()
    jax.block_until_ready(se3_knn(queries_d, pts_d, k))
    t_dense = time.perf_counter() - t0

    # BallTree reference (euclidean proxy on 7D, like gnat.py's baseline)
    from sklearn.neighbors import BallTree

    t0 = time.perf_counter()
    tree = BallTree(pts)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.query(queries, k)
    t_query = time.perf_counter() - t0

    print(json.dumps({
        "config": "SE3 kNN, 1M points",
        "n_points": n_points,
        "n_queries": n_queries,
        "k": k,
        "device_kind": jax.devices()[0].device_kind,
        "dense_seconds": round(t_dense, 3),
        "dense_build_seconds": 0.0,
        "balltree_build_seconds": round(t_build, 2),
        "balltree_query_seconds": round(t_query, 3),
        "dense_exact": True,
        "note": "BallTree uses euclidean 7D (no custom SE3 metric support at speed); the dense search is the exact reference SE3 metric",
    }))


if __name__ == "__main__":
    main()
