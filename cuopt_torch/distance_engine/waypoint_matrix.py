"""Waypoint-graph distance engine.

Role parity with the reference distance engine
(cpp/src/routing/distance_engine/, `waypoint_matrix_t` at
include/cuopt/routing/distance_engine/waypoint_matrix.hpp:49:
`compute_cost_matrix` :98, `compute_waypoint_sequence`,
`compute_shortest_path_costs`; Python wrapper
python/cuopt/cuopt/distance_engine/waypoint_matrix.py:20).

The reference runs one GPU Dijkstra per target (waypoint_matrix.hpp:165).
Dijkstra's priority queue is inherently sequential, so cuopt_tpu, and
this port of it, formulate it differently: all-targets min-plus relaxation
(vectorized Bellman-Ford) — a (n_targets, n_vertices) distance tensor
relaxed over the full edge list each sweep via gather + scatter-min on
`device`, iterated until a fixed point. Each sweep is O(T * E) fully
parallel work; the sweep count is bounded by the graph's shortest-path
hop diameter, not V.

Predecessor extraction (for waypoint sequences) happens once on host from
the converged distance tensor: an edge (u -> v, w) is on a shortest-path
tree iff dist[u] + w == dist[v].
"""

from __future__ import annotations

import numpy as np

from cuopt_torch.utils.errors import ValidationError


def _relax_all(offsets, src, dst, w, sources, n_vertices, device):
    """Min-plus fixed point on `device`: distances from each source to all
    vertices. Each sweep relaxes every edge with a gather and a
    scatter-min (`scatter_reduce` "amin"); the loop reads back one flag
    per sweep and stops at a fixed point or after V + 1 sweeps.

    Returns (n_sources, n_vertices) float64 distances of float32 sums
    (inf = unreachable).
    """
    import torch

    S = len(sources)
    V = n_vertices
    src_t = torch.as_tensor(np.asarray(src, np.int64), device=device)
    dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    w_t = torch.as_tensor(np.asarray(w, np.float32), device=device)
    dist = torch.full((S, V), float("inf"), dtype=torch.float32,
                      device=device)
    dist[torch.arange(S, device=device),
         torch.as_tensor(np.asarray(sources, np.int64), device=device)] = 0.0
    index = dst_t[None, :].expand(S, -1)
    for _ in range(V + 1):
        cand = dist[:, src_t] + w_t[None, :]  # (S, E)
        new = dist.scatter_reduce(1, index, cand, "amin", include_self=True)
        changed = bool((new < dist).any())  # the sweep's one readback
        dist = new
        if not changed:
            break
    return dist.cpu().numpy().astype(np.float64)


class WaypointMatrix:
    """Waypoint graph (CSR) -> cost matrices over target locations.

    Mirrors the reference Python `WaypointMatrix`
    (python/cuopt/cuopt/distance_engine/waypoint_matrix.py:20), with the
    relaxation on `device` ("cuda" unless the caller passes "cpu").
    """

    def __init__(self, offsets, indices, weights, device="cuda"):
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "WaypointMatrix on 'cuda' needs a CUDA card; pass "
                "device='cpu' to relax on the CPU")
        self.offsets = np.asarray(offsets, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.weights = np.asarray(weights, np.float64)
        if self.offsets.ndim != 1 or len(self.offsets) < 2:
            raise ValidationError("waypoint graph needs >= 1 vertex")
        if self.offsets[0] != 0 or self.offsets[-1] != len(self.indices):
            raise ValidationError("CSR offsets must start at 0, end at nnz")
        if len(self.indices) != len(self.weights):
            raise ValidationError("indices/weights length mismatch")
        if np.any(np.diff(self.offsets) < 0):
            raise ValidationError("CSR offsets must be non-decreasing")
        self.n_vertices = len(self.offsets) - 1
        if len(self.indices) and (
            self.indices.min() < 0 or self.indices.max() >= self.n_vertices
        ):
            raise ValidationError("edge target out of range")
        if np.any(self.weights < 0):
            raise ValidationError("negative edge weights are not supported")
        # flat edge list
        self._src = np.repeat(
            np.arange(self.n_vertices, dtype=np.int64),
            np.diff(self.offsets),
        )
        self._dst = self.indices
        # state for compute_waypoint_sequence (requires a prior
        # compute_cost_matrix, as in the reference test
        # waypoint_matrix_test.cpp test_compute_waypoint_sequence_no_matrix_call)
        self._targets = None
        self._dist = None  # (n_targets, V)
        self._pred = None  # (n_targets, V) predecessor vertex or -1

    # ------------------------------------------------------------- internal
    def _all_dists(self, target_locations):
        targets = np.asarray(target_locations, np.int64)
        if len(targets) == 0:
            raise ValidationError("target_locations is empty")
        if targets.min() < 0 or targets.max() >= self.n_vertices:
            raise ValidationError("target location out of range")
        dist = _relax_all(
            self.offsets, self._src, self._dst, self.weights, targets,
            self.n_vertices, self.device,
        )
        return targets, dist

    def _predecessors(self, targets, dist):
        """Shortest-path-tree predecessors from converged distances.

        pred[s, v] = u for some edge (u->v, w) with dist[s,u]+w == dist[s,v],
        the sum taken in float32 as the relaxation took it: at the fixed
        point some edge meets it exactly. (cuopt_tpu compares the float32
        distances with float64 sums at 1e-9, so on fractional weights it
        finds no tree edge and reports "no path".)
        """
        S = len(targets)
        pred = np.full((S, self.n_vertices), -1, np.int64)
        d32 = dist.astype(np.float32)
        du = d32[:, self._src] + self.weights.astype(np.float32)[None, :]
        dv = d32[:, self._dst]
        on_tree = (du == dv) & np.isfinite(dv)
        # later edges overwrite earlier ones; any tree edge is valid
        for s in range(S):
            sel = on_tree[s]
            pred[s, self._dst[sel]] = self._src[sel]
            pred[s, targets[s]] = -1
        return pred

    # --------------------------------------------------------------- public
    def compute_cost_matrix(self, target_locations) -> np.ndarray:
        """Pairwise shortest-path costs between target locations.

        Reference: waypoint_matrix.hpp:98 (one Dijkstra per target); here
        one vectorized min-plus fixed point for all targets at once.
        """
        targets, dist = self._all_dists(target_locations)
        self._targets = targets
        self._dist = dist
        self._pred = None  # computed lazily
        return dist[:, targets].astype(np.float32)

    def compute_shortest_path_costs(self, target_locations,
                                    weights) -> np.ndarray:
        """Accumulate a second weight (e.g. travel time) along the
        *cost-shortest* paths (reference waypoint_matrix.hpp
        compute_shortest_path_costs; used for time matrices over
        distance-optimal routes)."""
        custom = np.asarray(weights, np.float64)
        if custom.shape != self.weights.shape:
            raise ValidationError(
                "custom weights must match the graph edge count"
            )
        targets, dist = self._all_dists(target_locations)
        pred = self._predecessors(targets, dist)
        # edge lookup: (u, v) -> custom weight (first matching edge on tree)
        S, T = len(targets), len(targets)
        out = np.zeros((S, T), np.float32)
        # custom cost along tree: walk pred chain per (source, target)
        edge_w = {}
        for e in range(len(self._src)):
            key = (int(self._src[e]), int(self._dst[e]))
            # keep the edge consistent with the tree (min primary weight)
            if key not in edge_w or self.weights[e] < edge_w[key][0]:
                edge_w[key] = (self.weights[e], custom[e])
        for si in range(S):
            for ti in range(T):
                v = int(targets[ti])
                s = int(targets[si])
                if not np.isfinite(dist[si, v]):
                    out[si, ti] = np.inf
                    continue
                acc = 0.0
                while v != s:
                    u = int(pred[si, v])
                    if u < 0:
                        break
                    acc += edge_w[(u, v)][1]
                    v = u
                out[si, ti] = acc
        self._targets = targets
        self._dist = dist
        self._pred = pred
        return out

    def compute_waypoint_sequence(self, target_locations, locations):
        """Expand a route over target locations into the full waypoint
        path (reference waypoint_matrix.hpp compute_waypoint_sequence;
        requires compute_cost_matrix first).

        locations: route as indices into target_locations (reference
        waypoint_matrix_test data_model.hpp: locations{0,2,3,0,0,1,0} over
        target_locations{0,1,2,4}).
        Returns (sequence_offsets, full_path): full_path concatenates the
        waypoints of each leg including both endpoints (a zero-length leg
        contributes a single vertex); sequence_offsets[k] is the start of
        leg k in full_path and the last entry is len(full_path).
        """
        if self._dist is None or self._targets is None:
            raise ValidationError(
                "compute_cost_matrix must be called before "
                "compute_waypoint_sequence"
            )
        if self._pred is None:
            self._pred = self._predecessors(self._targets, self._dist)
        idxs = [int(x) for x in np.asarray(locations).ravel()]
        for i in idxs:
            if i < 0 or i >= len(self._targets):
                raise ValidationError(
                    f"route location index {i} out of range of "
                    f"target_locations"
                )
        full_path: list[int] = []
        seq_offsets = [0]
        for k in range(len(idxs) - 1):
            si, ti = idxs[k], idxs[k + 1]
            a = int(self._targets[si])
            b = int(self._targets[ti])
            if a == b:
                full_path.append(a)
                seq_offsets.append(len(full_path))
                continue
            if not np.isfinite(self._dist[si, b]):
                raise ValidationError(f"no path from {a} to {b}")
            # walk pred chain b -> a
            chain = [b]
            v = b
            while v != a:
                v = int(self._pred[si, v])
                if v < 0:
                    raise ValidationError(f"no path from {a} to {b}")
                chain.append(v)
            chain.reverse()
            full_path.extend(chain)
            seq_offsets.append(len(full_path))
        return (
            np.asarray(seq_offsets, np.int32),
            np.asarray(full_path, np.int32),
        )
