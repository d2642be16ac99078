"""Brute-force batched nearest neighbors as matrix products.

Replaces the reference's three NN structures — sklearn BallTree
(``grr/workspace.py:75-81``), pynndescent NNDescent with a numba SE3 metric
(``workspace.py:87-100``), and the OMPL-style GNAT port (``grr/gnat.py``) —
with dense top-k. At roadmap scales (5k-100k points) a blocked distance
matrix on the accelerator beats tree traversal on CPU,
is exact (NNDescent is approximate), and needs no build phase at all
(the reference documents 40 s - 30 min NNDescent builds,
``workspace.py:89-93``).

Distance matrices are computed in matmul form (|x|^2 + |y|^2 - 2 x.y) with
f32 accumulation at HIGHEST precision (no reduced-precision TF32).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def pairwise_sqdist(x, y, precision=jax.lax.Precision.HIGHEST, center=True):
    """Squared euclidean distances (N, D) x (M, D) -> (N, M).

    ``center=True`` subtracts the joint mean first: the matmul identity's
    cancellation error scales with |x||y|, and for scenes far from the
    origin it reaches ~1e-3 absolute — enough to corrupt top-k SELECTION
    on sub-mm-spaced roadmaps (observed: a 5000-node arc graph fragmented
    into 92 components). Centering drops the error by orders of magnitude
    at the cost of one mean.
    """
    if center:
        mu = 0.5 * (jnp.mean(x, axis=0) + jnp.mean(y, axis=0))
        x = x - mu
        y = y - mu
    x2 = jnp.sum(x * x, axis=-1, keepdims=True)
    y2 = jnp.sum(y * y, axis=-1, keepdims=True)
    xy = jnp.matmul(x, y.T, precision=precision)
    return jnp.maximum(x2 + y2.T - 2.0 * xy, 0.0)


def se3_pairwise(points1, points2, position_weight=1.0, rotation_weight=0.3):
    """SE3 distance matrix (N, 7) x (M, 7) -> (N, M).

    ``w_p * ||p1-p2|| + w_r * (1 - |q1.q2|)`` — the workspace metric of the
    whole GRR stack (``grr/utils.py:35-60``), evaluated densely: the
    position term via the (centered) matmul identity, the rotation term via
    one (N, M) quaternion inner-product matmul.
    """
    d_pos = jnp.sqrt(pairwise_sqdist(points1[:, :3], points2[:, :3]))
    if points1.shape[-1] <= 3 or points2.shape[-1] <= 3:
        return d_pos
    qdot = jnp.matmul(
        points1[:, 3:7], points2[:, 3:7].T, precision=jax.lax.Precision.HIGHEST
    )
    return position_weight * d_pos + rotation_weight * (1.0 - jnp.abs(qdot))


@partial(jax.jit, static_argnames=("k", "row_chunk"))
def knn(queries, points, k, valid=None, row_chunk=1024):
    """k nearest neighbors by euclidean distance.

    Args:
        queries: (Q, D)
        points: (N, D) search set.
        k: neighbors per query (static).
        valid: optional (N,) bool mask; invalid points never match.
        row_chunk: queries processed per distance-matrix tile (bounds peak
            memory at row_chunk x N).

    Returns: (dists (Q, k), idx (Q, k)) sorted ascending.
    """
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = jnp.pad(queries, ((0, pad), (0, 0)))

    n_cand = min(max(4 * k + 16, k), points.shape[0])

    def chunk_fn(q_chunk):
        d = pairwise_sqdist(q_chunk, points)
        if valid is not None:
            d = jnp.where(valid[None, :], d, jnp.inf)
        # two-stage exact selection (matmul-form distances carry absolute
        # error; see se3_knn): candidate superset -> exact re-rank.
        _, cand = jax.lax.top_k(-d, n_cand)
        diff = q_chunk[:, None, :] - points[cand]
        d_exact = jnp.linalg.norm(diff, axis=-1)
        if valid is not None:
            d_exact = jnp.where(valid[cand], d_exact, jnp.inf)
        neg_top, pos_in_cand = jax.lax.top_k(-d_exact, k)
        idx = jnp.take_along_axis(cand, pos_in_cand, axis=1)
        return -neg_top, idx

    chunks = q_padded.reshape(-1, row_chunk, queries.shape[-1])
    dists, idx = jax.lax.map(chunk_fn, chunks)
    return (
        dists.reshape(-1, k)[:Q],
        idx.reshape(-1, k)[:Q],
    )


@partial(jax.jit, static_argnames=("row_chunk",))
def nearest_neighbor(queries, points, valid=None, row_chunk=2048):
    """Single nearest neighbor: (dists (Q,), idx (Q,))."""
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = jnp.pad(queries, ((0, pad), (0, 0)))

    def chunk_fn(q_chunk):
        d = pairwise_sqdist(q_chunk, points)
        if valid is not None:
            d = jnp.where(valid[None, :], d, jnp.inf)
        idx = jnp.argmin(d, axis=-1)
        # exact recompute of the winner (see knn note on cancellation)
        d_exact = jnp.linalg.norm(q_chunk - points[idx], axis=-1)
        return d_exact, idx

    chunks = q_padded.reshape(-1, row_chunk, queries.shape[-1])
    dists, idx = jax.lax.map(chunk_fn, chunks)
    return dists.reshape(-1)[:Q], idx.reshape(-1)[:Q]


@partial(jax.jit, static_argnames=("k", "row_chunk"))
def se3_knn(queries, points, k, valid=None, row_chunk=512):
    """k nearest neighbors under the SE3 workspace metric.

    Replaces ``get_workspace_neighbors`` NNDescent queries
    (``grr/workspace.py:446-458``) with exact dense top-k. Inputs are (Q, 7)
    / (N, 7) [pos, quat] workspace points; position-only (D=3) also works.
    """
    Q = queries.shape[0]
    pad = (-Q) % row_chunk
    q_padded = jnp.pad(queries, ((0, pad), (0, 0)))

    n_cand = min(max(4 * k + 16, k), points.shape[0])

    def chunk_fn(q_chunk):
        d = se3_pairwise(q_chunk, points)
        if valid is not None:
            d = jnp.where(valid[None, :], d, jnp.inf)
        # two-stage exact selection: the dense matmul metric carries a
        # small absolute error, so take a candidate superset by the noisy
        # metric, recompute exactly by direct subtraction, then re-rank.
        # (GRR's "falls on a node" check compares these against 1e-3,
        # resolution.py:316/345, and roadmap connectivity at sub-mm node
        # spacing depends on correct ranking.)
        _, cand = jax.lax.top_k(-d, n_cand)
        sel = points[cand]  # (chunk, n_cand, D)
        d_pos = jnp.linalg.norm(q_chunk[:, None, :3] - sel[..., :3], axis=-1)
        if points.shape[-1] > 3:
            qdot = jnp.abs(jnp.sum(q_chunk[:, None, 3:7] * sel[..., 3:7], axis=-1))
            d_exact = d_pos + 0.3 * (1.0 - qdot)
        else:
            d_exact = d_pos
        if valid is not None:
            d_exact = jnp.where(valid[cand], d_exact, jnp.inf)
        neg_top, pos_in_cand = jax.lax.top_k(-d_exact, k)
        idx = jnp.take_along_axis(cand, pos_in_cand, axis=1)
        return -neg_top, idx

    chunks = q_padded.reshape(-1, row_chunk, queries.shape[-1])
    dists, idx = jax.lax.map(chunk_fn, chunks)
    return dists.reshape(-1, k)[:Q], idx.reshape(-1, k)[:Q]
