"""Global redundancy resolution facade + online queries.

Rebuild of ``Expansion-GRR/grr/resolution.py`` (``RedundancyResolution``).
Holds the three roadmap stages (workspace graph, solver state, resolution
arrays) and serves the runtime kernel the applications call 500x per scan:

    solve(point, curr_config, ...)   (resolution.py:232-433)
    teleop_solve(point, curr, ...)   (resolution.py:145-213)
    plan(start, goal, ...)           (resolution.py:435-517)

Faithfully reproduces the reference's as-modified solve() logic, including
its quirks (kept deliberately — this is the behavior the golden
trajectories were produced with):
  * tracking mode: when ``curr_config`` is given, the seed is the
    joint-space-CLOSEST neighbor's config and IK runs from it directly
    (resolution.py:313-330); the weighted-average branch only runs on
    cold start.
  * cold start: exact-node match within 1e-3 first (resolution.py:316),
    else largest-connected-component weighted average where the combined
    weights are INVERSE-squared again (resolution.py:404-424) — i.e.
    closer nodes get *smaller* weights; reference behavior, see
    tests/test_grr.py::TestSolveQuirks.
  * TrackArray diagnostic codes appended exactly like
    resolution.py:281,317,322,351,432 (dumped by apps.scan to
    trackarr.txt for parity with the golden file).

Batched additions beyond the reference surface: ``solve_batch`` solves a
whole Cartesian path in a fixed number of device dispatches (sequential
seeding handled by a scan over the path), used by apps.scan.grr_plan.
"""

from __future__ import annotations

import heapq

import numpy as np

import jax.numpy as jnp

from reconplan_tpu.core import maths
from reconplan_tpu.grr.solver import ExpansionSolver
from reconplan_tpu.grr.workspace import RoadmapWorkspace
from reconplan_tpu.io.checkpoint import load_roadmap_npz, save_roadmap_npz


class RedundancyResolution:
    def __init__(self, robot):
        self.robot = robot
        self.workspace = RoadmapWorkspace(robot)
        self.solver = ExpansionSolver(self.workspace, robot)

        # resolution arrays (built or loaded)
        self.points = np.zeros((0, 7), dtype=np.float32)
        self.configs = np.zeros((0, robot.num_joints), dtype=np.float32)
        self.edges = np.zeros((0, 2), dtype=np.int64)
        self.edge_weights = np.zeros((0,), dtype=np.float32)
        self.adjacency: list[list[int]] = []

        # teleop state (resolution.py:50-53)
        self.planning_mode = False
        self.plan_path = None
        self.path_index = 0

    # ------------------------------------------------------------------
    # build stages (resolution.py:63-128)
    # ------------------------------------------------------------------
    def sample_workspace(self, obj_pos, n_pos_points, n_rot_points,
                         sampling_method="random"):
        self.workspace.sample_workspace(
            obj_pos, n_pos_points, n_rot_points, sampling_method
        )
        self.solver = ExpansionSolver(self.workspace, self.robot)

    def global_expansion(self, configs, **kwargs):
        self.solver.global_expansion(configs, **kwargs)

    def fix_boundary(self, n_neighbor_layer=1, n_iter=5):
        self.solver.fix_boundary(n_neighbor_layer, n_iter)

    def build_resolution_graph_and_nn(self, build_new_nn=True):
        res = self.solver.build_resolution()
        self._set_resolution(res)

    def _set_resolution(self, res):
        self.points = res["points"]
        self.configs = res["configs"]
        self.edges = res["edges"]
        self.edge_weights = res["edge_weights"]
        adj = [[] for _ in range(len(self.points))]
        for (i, j), w in zip(self.edges, self.edge_weights):
            adj[int(i)].append((int(j), float(w)))
            adj[int(j)].append((int(i), float(w)))
        self.adjacency = adj
        # native graph queries (C++ graphcore, python fallback)
        from reconplan_tpu.utils.native import GraphCore

        self._gc = (
            GraphCore(len(self.points), self.edges, self.edge_weights)
            if len(self.edges)
            else None
        )

    # ------------------------------------------------------------------
    # persistence (npz instead of pickles; resolution.py:130-143)
    # ------------------------------------------------------------------
    def save_resolution_graph(self, path):
        save_roadmap_npz(
            path,
            points=self.points,
            configs=self.configs,
            edges=self.edges,
            edge_weights=self.edge_weights,
        )

    def load_resolution_graph(self, path):
        data = load_roadmap_npz(path)
        self._set_resolution(data)
        print("\nResolution graph loaded")
        print("Graph has", len(self.points), "nodes")
        print("Graph has", len(self.edges), "edges")

    def save_workspace_graph(self, path):
        self.workspace.save(path)

    def load_workspace_graph(self, path):
        self.workspace.load(path)
        self.solver = ExpansionSolver(self.workspace, self.robot)

    def save_solver_graph(self, path):
        """Persist expansion-solver state (configs / has_config /
        edge_connected) so an interrupted build can resume and TRUE edge
        connectivity survives a save/load round trip (the reference
        pickles its solver graph and resumes via
        ``load_existed_solver_graph``, redundancy.py:37-52)."""
        save_roadmap_npz(
            path,
            configs=self.solver.configs,
            has_config=self.solver.has_config,
            edge_connected=self.solver.edge_connected,
        )

    def load_solver_graph(self, path):
        """Restore solver state saved by :meth:`save_solver_graph`.
        Requires the matching workspace graph to be loaded first."""
        data = load_roadmap_npz(path)
        s = self.solver
        if tuple(data["configs"].shape) != tuple(s.configs.shape) or len(
            data["edge_connected"]
        ) != len(s.edge_connected):
            raise ValueError(
                "solver graph shape mismatch vs loaded workspace "
                f"(configs {data['configs'].shape} vs {s.configs.shape})"
            )
        s.configs = np.asarray(data["configs"], dtype=np.float32)
        s.has_config = np.asarray(data["has_config"], dtype=bool)
        s.edge_connected = np.asarray(data["edge_connected"], dtype=bool)
        print(
            f"Solver graph loaded: {int(s.has_config.sum())}/"
            f"{len(s.has_config)} configured, "
            f"{int(s.edge_connected.sum())}/{len(s.edge_connected)} "
            "edges connected"
        )

    # ------------------------------------------------------------------
    # the runtime kernel (resolution.py:232-433)
    # ------------------------------------------------------------------
    def solve(
        self,
        point,
        curr_config=None,
        nearest_node_only=False,
        regular_ik=False,
        none_on_fail=False,
        TrackArray=None,
    ):
        """Solve redundancy for one workspace point. See module docstring
        for the exact mode logic mirrored from resolution.py:232-433."""
        if TrackArray is None:
            TrackArray = []
        point = np.array(point, dtype=np.float64).reshape(-1)

        def solve_with_guess(guess):
            return self.robot.solve_ik(point, guess, none_on_fail=none_on_fail)

        if regular_ik:
            return solve_with_guess(curr_config)

        if len(point) > 3:
            point[3:] = point[3:] / np.linalg.norm(point[3:])

        k = self.workspace.interpolate_num_neighbors
        if len(self.points) == 0:
            TrackArray.append(0)
            return solve_with_guess(curr_config)
        neighbors = self.workspace.get_workspace_neighbors(
            point.astype(np.float32), k=k, points=self.points
        )
        neighbors = [int(n) for n in neighbors]

        if len(neighbors) == 0:
            TrackArray.append(0)
            return solve_with_guess(curr_config)

        if nearest_node_only:
            return self.configs[neighbors[0]]

        if curr_config is not None:
            # tracking mode: joint-space closest neighbor as IK seed
            # (resolution.py:299-330)
            cc = jnp.asarray(np.asarray(curr_config, dtype=np.float32))
            dists = np.asarray(
                self.robot.distance_batch(
                    cc[None, :], jnp.asarray(self.configs[neighbors])
                )
            )
            TrackArray.append(float(dists.min()))
            return solve_with_guess(self.configs[neighbors[int(dists.argmin())]])

        # cold start: exact node match (resolution.py:313-318)
        for n in neighbors:
            if (
                float(maths.se3_distance(jnp.asarray(point, dtype=jnp.float32),
                                         jnp.asarray(self.points[n]))) < 1e-3
            ):
                TrackArray.append(0)
                return solve_with_guess(self.configs[n])

        # largest-connected-component weighted average
        # (resolution.py:369-433)
        component = self._component_containing(neighbors, neighbors[0])
        comp = sorted(component)
        q_nbrs = self.configs[comp]
        p_nbrs = self.points[comp]
        d = np.asarray(
            maths.se3_distance(
                jnp.asarray(point, dtype=jnp.float32)[None], jnp.asarray(p_nbrs)
            )
        )
        graph_d = self._graph_distances(neighbors[0], comp)
        max_d = d.max()
        workspace_w = (max_d / np.maximum(d, 1e-12)) ** 2
        graph_w = graph_d / max(graph_d.max(), 1e-12)
        joint_w = np.zeros(len(comp))
        alpha, beta = 0.0, 1.0  # resolution.py:416-417
        combined = (1 - alpha) * workspace_w + alpha * graph_w + beta * joint_w
        weights = (1.0 / (combined + 1e-6)) ** 2  # resolution.py:424 (quirk)
        q_avg = self.robot.average(q_nbrs, weights)
        TrackArray.append(2)
        return solve_with_guess(q_avg)

    def solve_batch(self, points, init_config=None, max_iters=100,
                    tolerance=1e-3, return_track=False, n_seeds=8):
        """Solve a whole Cartesian path ON DEVICE in one dispatch.

        Tracking-mode semantics of :meth:`solve` (seed = joint-space
        closest roadmap neighbor of the previous solution,
        resolution.py:299-330) expressed as a ``lax.scan`` over waypoints:
        the sequential dependence stays, but the entire loop runs in a
        single XLA computation — no per-waypoint host round trips.

        Documented divergence from the reference's single-seed tracking
        solve: the ``n_seeds`` joint-closest roadmap configs among the k
        SE3 neighbors all run as parallel IK restarts (one batched
        dispatch — the while_loop trip count is the max over seeds), and the converged+valid result closest in joint
        space to the current config wins. Near the reach boundary the
        joint-closest seed alone fails ~35% of look-at arc waypoints that
        a sibling roadmap seed solves (measured on the 6-arc ur10 scan);
        every solution still descends from a roadmap config, so the
        resolution-manifold semantics are unchanged.

        Args:
            points: (T, D) workspace waypoints.
            init_config: optional (A,) starting configuration; when None
                the first waypoint cold-starts from the nearest roadmap
                config.
            n_seeds: roadmap configs tried as IK restarts per waypoint.

        Returns (configs (T, A) np, success (T,) np bool); with
        ``return_track=True`` additionally the per-waypoint min joint
        distance to the roadmap seeds — the same tracking-mode diagnostic
        :meth:`solve` appends to TrackArray (resolution.py:322), so
        trackarr.txt stays comparable to the reference's golden file.
        """
        import jax
        from reconplan_tpu.kin.ik import dls_ik_batch
        from reconplan_tpu.ops.nn import se3_pairwise

        robot = self.robot
        pts = jnp.asarray(np.asarray(points, dtype=np.float32))
        if pts.shape[1] > 3:
            pts = pts.at[:, 3:7].set(
                pts[:, 3:7]
                / jnp.linalg.norm(pts[:, 3:7], axis=-1, keepdims=True)
            )
        road_pts = jnp.asarray(self.points)
        road_cfg = jnp.asarray(self.configs)
        k = min(self.workspace.interpolate_num_neighbors, len(self.points))

        pos_t, rotm_t, use_rot = robot._ik_targets(pts)

        if init_config is None:
            # cold start: nearest roadmap config of waypoint 0
            d0 = se3_pairwise(pts[:1], road_pts)[0]
            q0 = road_cfg[jnp.argmin(d0)]
        else:
            q0 = jnp.asarray(init_config, dtype=jnp.float32)

        j = max(1, min(n_seeds, k))

        def step(curr, inputs):
            point, pos, rotm = inputs
            # k nearest roadmap nodes under the SE3 metric
            d = se3_pairwise(point[None], road_pts)[0]
            _, idx = jax.lax.top_k(-d, k)
            cfgs = road_cfg[idx]
            jd = robot.distance_batch(curr[None, :], cfgs)
            _, sidx = jax.lax.top_k(-jd, j)
            seeds = cfgs[sidx]  # (j, A) joint-closest roadmap seeds
            res = dls_ik_batch(
                robot.model, robot._active_tuple, robot.ee_link,
                jnp.broadcast_to(pos, (j, 3)),
                jnp.broadcast_to(rotm, (j, 3, 3)),
                seeds, robot._q_rest,
                max_iters=max_iters, tolerance=tolerance,
                use_rotation=use_rot,
            )
            q = jnp.where(
                robot._cyclic_mask, maths.wrap_to_pi(res.config), res.config
            )
            valid = robot._validate_batch(q)
            okj = jnp.logical_and(res.success, valid)
            # among converged+valid restarts, prefer minimal joint motion
            dq = jnp.where(okj, robot.distance_batch(curr[None, :], q), jnp.inf)
            best = jnp.argmin(dq)
            q, ok = q[best], okj[best]
            new_curr = jnp.where(ok, q, curr)
            return new_curr, (q, ok, jnp.min(jd))

        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                               (pts.shape[0], 3, 3))
        rotm_t = rotm_t if use_rot else eye
        _, (qs, oks, track) = jax.lax.scan(step, q0, (pts, pos_t, rotm_t))
        if return_track:
            return np.asarray(qs), np.asarray(oks), np.asarray(track)
        return np.asarray(qs), np.asarray(oks)

    def _component_containing(self, nodes, target):
        """Connected component of ``target`` within the induced subgraph of
        ``nodes`` (resolution.py:370-376)."""
        nodes_set = set(nodes)
        comp = {target}
        stack = [target]
        while stack:
            i = stack.pop()
            for j, _w in self.adjacency[i]:
                if j in nodes_set and j not in comp:
                    comp.add(j)
                    stack.append(j)
        return comp

    def _graph_distances(self, source, targets):
        """Unweighted shortest-path hop counts on the resolution graph
        (resolution.py:385-388 uses nx.shortest_path_length)."""
        targets = list(targets)
        if getattr(self, "_gc", None) is not None:
            d = self._gc.bfs_distances(source)
            return np.asarray(
                [float(d[t]) if d[t] >= 0 else float(len(self.points)) for t in targets]
            )
        want = set(targets)
        dist = {source: 0}
        frontier = [source]
        found = {source} & want
        while frontier and found != want:
            nxt = []
            for i in frontier:
                for j, _w in self.adjacency[i]:
                    if j not in dist:
                        dist[j] = dist[i] + 1
                        nxt.append(j)
                        if j in want:
                            found.add(j)
            frontier = nxt
        return np.asarray([float(dist.get(t, len(self.points))) for t in targets])

    # ------------------------------------------------------------------
    # teleop (resolution.py:145-228)
    # ------------------------------------------------------------------
    def teleop_solve(self, target_point, curr_config, max_change=0.03):
        pos, rot = self.robot.solve_fk(np.asarray(curr_config), index=-1)
        curr_point = pos
        if self.robot.rotation == "variable":
            curr_point = np.concatenate([pos, rot])

        q = self.solve(target_point, curr_config, none_on_fail=True)
        if curr_config is None:
            return q

        if q is not None:
            if self.solver.is_continuous(curr_config, q, curr_point, target_point):
                self.plan_path = None
                self.path_index = 0
                return self.teleop_towards(curr_config, q, max_change)
            # plan a path towards q (resolution.py:171-195)
            if self.plan_path is None:
                c_path, _w = self.plan(curr_point, target_point, interpolation=1)
                self.plan_path = c_path if len(c_path) else None
                if self.plan_path is None:
                    return curr_config
                self.path_index = 1
                return self.teleop_towards(
                    curr_config, self.plan_path[1], max_change
                )
            self.path_index += 1
            if self.path_index < len(self.plan_path):
                return self.teleop_towards(
                    curr_config, self.plan_path[self.path_index], max_change
                )
            self.plan_path = None
            self.path_index = 0
            return curr_config

        # discontinuity fallback: nearest roadmap nodes (resolution.py:197-213)
        neighbors = self.workspace.get_workspace_neighbors(
            np.asarray(target_point, dtype=np.float32), k=5, points=self.points
        )
        for n in neighbors:
            qn = self.configs[int(n)]
            pn = self.points[int(n)]
            if self.solver.is_continuous(qn, curr_config, pn, curr_point):
                return self.teleop_towards(curr_config, qn, max_change)
        return None

    def teleop_towards(self, curr_config, target_config, max_change):
        """Clamped step toward a target config (resolution.py:215-228)."""
        diff = np.asarray(target_config) - np.asarray(curr_config)
        for i in self.robot.cyclic_joints:
            diff[i] = float(maths.wrap_to_pi(diff[i]))
        diff = np.abs(diff)
        if diff.max() < max_change:
            return self.robot.interpolate(curr_config, target_config, 1)
        u = max_change / diff.max()
        return self.robot.interpolate(curr_config, target_config, u)

    # ------------------------------------------------------------------
    # planning (resolution.py:435-517)
    # ------------------------------------------------------------------
    def _dijkstra(self, source, target):
        """Weighted shortest path on the resolution graph (native
        graphcore when available)."""
        if getattr(self, "_gc", None) is not None:
            return self._gc.shortest_path(source, target)
        dist = {source: 0.0}
        prev = {}
        pq = [(0.0, source)]
        while pq:
            d, i = heapq.heappop(pq)
            if i == target:
                break
            if d > dist.get(i, np.inf):
                continue
            for j, w in self.adjacency[i]:
                nd = d + w
                if nd < dist.get(j, np.inf):
                    dist[j] = nd
                    prev[j] = i
                    heapq.heappush(pq, (nd, j))
        if target not in dist:
            return None
        path = [target]
        while path[-1] != source:
            path.append(prev[path[-1]])
        return path[::-1]

    def plan(self, start_point, goal_point, interpolation=8):
        """Roadmap path + per-segment interpolation re-solve
        (resolution.py:435-517)."""
        start_point = np.asarray(start_point, dtype=np.float32)
        goal_point = np.asarray(goal_point, dtype=np.float32)

        def pick_entry(point):
            """First neighbor whose straight-line approach solves
            throughout (resolution.py:448-474, num_div=8)."""
            neighbors = self.workspace.get_workspace_neighbors(
                point, k=min(4, len(self.points)), points=self.points
            )
            for n in neighbors:
                n = int(n)
                for kk in range(8):
                    sub = self.robot.workspace_interpolate(
                        point, self.points[n], kk / 8
                    )
                    if self.solve(sub, none_on_fail=True) is None:
                        break
                else:
                    return n
            return None

        n1 = pick_entry(start_point)
        n2 = pick_entry(goal_point)
        if n1 is None or n2 is None:
            print("No valid neighbor found")
            return np.zeros((0, self.robot.num_joints)), np.zeros((0, self.points.shape[1]))

        path = self._dijkstra(n1, n2)
        if path is None:
            print("No path found")
            return np.zeros((0, self.robot.num_joints)), np.zeros((0, self.points.shape[1]))

        path_points = [start_point] + [self.points[p] for p in path] + [goal_point]
        w_path, c_path = [], []
        for pi, pj in zip(path_points[:-1], path_points[1:]):
            for kk in range(interpolation):
                sub = self.robot.workspace_interpolate(pi, pj, kk / interpolation)
                q = self.solve(sub, none_on_fail=True)
                if q is None:
                    continue
                w_path.append(sub)
                c_path.append(q)
        # keep w_path dim-homogeneous when a 3D goal meets a posed roadmap
        w_path.append(
            self.robot.workspace_interpolate(path_points[-2], goal_point, 1.0)
        )
        c_path.append(self.solve(goal_point))
        return np.asarray(c_path), np.asarray(w_path)
