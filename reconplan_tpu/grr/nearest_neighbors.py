"""Nearest-neighbor structures with the reference's interface (C9 parity).

The reference carries three NN structures — sklearn BallTree, pynndescent
NNDescent, and a 767-line Python port of OMPL's GNAT metric tree
(``grr/gnat.py``, ``grr/nearest_neighbors.py``) — because exact metric-tree
search is the only fast option on CPU. On an accelerator the calculus
inverts: an exact dense top-k as matrix products needs ZERO build time
(``benchmarks/bench_nn.py`` times it against a BallTree build + query).

This module exposes that engine through the reference's own abstract
interface (``grr/nearest_neighbors.py:21-68``: add/add_list/nearest/
nearest_k/nearest_r/remove/size) so code written against GNAT drops in
unchanged. ``GreedyKCenters`` is kept too (used by the reference for GNAT
pivot selection; useful generally for roadmap sparsification).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from reconplan_tpu.core import maths
from reconplan_tpu.ops.nn import se3_knn, se3_pairwise


class NearestNeighbors:
    """Abstract interface matching ``grr/nearest_neighbors.py:21-68``."""

    def add(self, point):
        raise NotImplementedError

    def add_list(self, points):
        raise NotImplementedError

    def nearest(self, point):
        raise NotImplementedError

    def nearest_k(self, point, k):
        raise NotImplementedError

    def nearest_r(self, point, r):
        raise NotImplementedError

    def remove(self, point_index):
        raise NotImplementedError

    def size(self):
        raise NotImplementedError


class DenseTopK(NearestNeighbors):
    """Exact SE3 nearest neighbors by dense device top-k.

    Drop-in for the reference's ``GNAT`` (``grr/gnat.py:19-236``): same
    query surface, exact results, no build/rebalance phase, O(1) removal
    (mask). Points are (D,) arrays, D = 3 or 7.
    """

    def __init__(self, capacity=1 << 20, dim=7):
        self._points = np.zeros((0, dim), dtype=np.float32)
        self._alive = np.zeros(0, dtype=bool)
        self.capacity = capacity

    # -- construction ---------------------------------------------------
    def add(self, point):
        self.add_list([point])

    def add_list(self, points):
        pts = np.asarray(points, dtype=np.float32).reshape(len(points), -1)
        self._points = np.concatenate([self._points[: len(self._alive)], pts])
        self._alive = np.concatenate([self._alive, np.ones(len(pts), bool)])

    def remove(self, point_index):
        self._alive[point_index] = False

    def size(self):
        return int(self._alive.sum())

    # -- queries --------------------------------------------------------
    def _query(self, point, k):
        k = min(k, len(self._points))
        d, idx = se3_knn(
            jnp.asarray(np.asarray(point, dtype=np.float32))[None],
            jnp.asarray(self._points),
            k,
            valid=jnp.asarray(self._alive),
        )
        return np.asarray(d[0]), np.asarray(idx[0])

    def nearest(self, point):
        _, idx = self._query(point, 1)
        return int(idx[0])

    def nearest_k(self, point, k):
        d, idx = self._query(point, k)
        return idx.tolist(), d.tolist()

    def nearest_r(self, point, r):
        """Radius query: all alive points within SE3 distance r."""
        d = np.asarray(
            se3_pairwise(
                jnp.asarray(np.asarray(point, dtype=np.float32))[None],
                jnp.asarray(self._points),
            )
        )[0]
        sel = np.flatnonzero((d <= r) & self._alive)
        order = np.argsort(d[sel])
        return sel[order].tolist(), d[sel][order].tolist()


class GreedyKCenters:
    """Greedy k-centers selection (``grr/nearest_neighbors.py:71-115``):
    pick k points maximizing mutual separation under the SE3 metric —
    vectorized (one distance row per iteration instead of a python loop
    over points)."""

    def kcenters(self, points, k, seed=0):
        pts = np.asarray(points, dtype=np.float32)
        n = len(pts)
        k = min(k, n)
        rng = np.random.default_rng(seed)
        centers = [int(rng.integers(n))]
        min_d = np.asarray(
            se3_pairwise(jnp.asarray(pts[centers[-1]][None]), jnp.asarray(pts))
        )[0]
        for _ in range(1, k):
            nxt = int(np.argmax(min_d))
            centers.append(nxt)
            d_new = np.asarray(
                se3_pairwise(jnp.asarray(pts[nxt][None]), jnp.asarray(pts))
            )[0]
            min_d = np.minimum(min_d, d_new)
        # distance matrix of chosen centers (the reference returns it too)
        dists = np.asarray(
            se3_pairwise(jnp.asarray(pts[centers]), jnp.asarray(pts[centers]))
        )
        return centers, dists


# Alias matching the reference's class name so imports read the same.
GNAT = DenseTopK
