"""Branch & bound over LP relaxations.

Counterpart of cuopt_tpu/mip/branch_and_bound.py, which mirrors the
reference host B&B (cpp/src/dual_simplex/branch_and_bound.hpp
`branch_and_bound_t`: best-first std::priority_queue of mip_node_t,
incumbent exchange callbacks). Differences, by design:

  - node relaxations are solved by the host dual simplex from the
    parent's basis when the instance fits its gate; otherwise by PDLP on
    `device` with tightened tolerances, the frontier's nodes batched into
    one stacked program (lp/batch.py: identical sparsity pattern, only
    the bound vectors differ);
  - bound-propagation presolve runs at every node (reference probes via
    GPU bound propagation, bounds_presolve.cuh).

Branching: most-fractional (pseudo-cost branching is a follow-up).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex import is_available
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.lp.batch import batch_solve
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.mip.presolve import propagate_bounds
from cuopt_torch.mip.rounding import fits_simplex, is_feasible
from cuopt_torch.parallel.sharding import make_mesh
from cuopt_torch.utils.logger import get_logger
from cuopt_torch.utils.timer import Timer


def safe_dual_bound(prob, y, lv, uv, nnz_rows=None):
    """Rigorous lower bound on min c^T x s.t. L<=Ax<=U, lv<=x<=uv from ANY
    dual vector y (weak duality on the Lagrangian; see
    BranchAndBound._safe_dual_bound for the derivation). Standalone so the
    MIP root bound uses the same safeguard (mip/solve.py)."""
    if y is None:
        return -math.inf
    if nnz_rows is None:
        nnz_rows = np.repeat(
            np.arange(prob.n_constraints), np.diff(prob.offsets)
        )
    y = np.asarray(y, float).copy()
    L = prob.constraint_lower_bounds
    U = prob.constraint_upper_bounds
    y[(y > 0) & ~np.isfinite(L)] = 0.0
    y[(y < 0) & ~np.isfinite(U)] = 0.0
    y[~np.isfinite(y)] = 0.0
    r = np.asarray(prob.objective_coefficients, float).copy()
    np.subtract.at(r, prob.indices, prob.values * y[nnz_rows])
    row_term = np.zeros_like(y)
    pos, neg = y > 0, y < 0
    row_term[pos] = L[pos] * y[pos]
    row_term[neg] = U[neg] * y[neg]
    var_term = np.zeros_like(r)
    with np.errstate(invalid="ignore"):
        pos, neg = r > 1e-14, r < -1e-14
        var_term[pos] = lv[pos] * r[pos]
        var_term[neg] = uv[neg] * r[neg]
    total = float(np.sum(row_term) + np.sum(var_term)
                  + prob.objective_offset)
    return total if not math.isnan(total) else -math.inf


@dataclass(order=True)
class _Node:
    bound: float
    seq: int
    lv: np.ndarray = field(compare=False)
    uv: np.ndarray = field(compare=False)
    x_warm: np.ndarray | None = field(compare=False, default=None)
    y_warm: np.ndarray | None = field(compare=False, default=None)
    # warm simplex basis statuses from the parent node (int8[n+m]);
    # reference warm-starts node re-solves from the parent basis
    # (dual_simplex/branch_and_bound.hpp node solves)
    vstat: np.ndarray | None = field(compare=False, default=None)
    depth: int = field(compare=False, default=0)
    # LP effort multiplier: grows when a node's relaxation hits its
    # iteration limit and the node is re-queued (never silently dropped)
    effort: int = field(compare=False, default=1)
    # pseudo-cost bookkeeping: which branch created this node
    branch_var: int = field(compare=False, default=-1)
    branch_up: bool = field(compare=False, default=False)
    branch_frac: float = field(compare=False, default=0.0)


class BranchAndBound:
    def __init__(self, prob, mip_settings, node_lp_tol=1e-6,
                 max_nodes=100_000, probe_cache=None, device="cuda"):
        self.prob = prob
        self.device = device  # where PDLP node relaxations run
        self.settings = mip_settings
        # root probing cache (reference probing_cache.cuh:88): sparse
        # implied-bound deltas applied for free at nodes that fix a
        # probed binary (see _propagate)
        self.probe_cache = probe_cache or {}
        self.node_lp_tol = node_lp_tol
        self.max_nodes = max_nodes
        self.log = get_logger()
        # exact host simplex for node relaxations (reference B&B runs on
        # dual simplex, branch_and_bound.hpp:45); the sparse-LU engine
        # (cpp/dual_simplex/sparse_lu.hpp) handles mid-size instances, so
        # the gate is only a guard against huge node LPs where the PDLP
        # bound engine is the better fit
        self.use_simplex = fits_simplex(prob) and is_available()
        self.is_int = prob.variable_types == "I"
        self.int_tol = mip_settings.tolerances.integrality_tolerance
        self.incumbent = None
        self.incumbent_obj = math.inf  # internal minimize orientation
        self.best_bound = -math.inf
        self.nodes_explored = 0
        self.simplex_iters = 0
        self.solution_callbacks = []
        # incumbent exchange is cross-thread in concurrent mode
        # (reference mip/solver.cu:150-166 callback wiring)
        import threading

        self._lock = threading.Lock()
        # pseudo-costs (reference dual_simplex/pseudo_costs.cpp): average
        # objective degradation per unit fraction, per direction
        n_vars = prob.n_variables
        self._pc_up = np.zeros(n_vars)
        self._pc_dn = np.zeros(n_vars)
        self._pc_up_n = np.zeros(n_vars, np.int64)
        self._pc_dn_n = np.zeros(n_vars, np.int64)
        # nodes whose relaxation stayed unresolved past the effort cap:
        # the subtree is open, so OPTIMAL may not be claimed
        self._lost_nodes = 0
        # CSR row index of each nnz, for host A^T y in the safe bound
        self._nnz_rows = np.repeat(
            np.arange(prob.n_constraints), np.diff(prob.offsets)
        )
        # recent node relaxation solutions, harvested by the diversity
        # loop for rounding + LP completion (dive-style primal moves)
        from collections import deque

        self.recent_x = deque(maxlen=8)
        # resumable search state (see _start/step/solve)
        self._started = False
        self._root_infeasible = False
        self._complete = False
        self._heap: list[_Node] = []
        self._pending: list[tuple[_Node, dict]] = []
        # plunge stack: after branching, the preferred child is explored
        # depth-first (warm bases, fast incumbent discovery) until it
        # prunes; then selection falls back to best-first (reference
        # B&B interleaves dives the same way)
        self._dive: list[_Node] = []
        self._plunge_tick = 0
        self._seq = 0

    def _node_bound(self, raw, node):
        """Node lower bound: the exact dual objective when the
        relaxation was solved by the native dual simplex to optimality
        (reference node bounds are exact dual simplex,
        dual_simplex/branch_and_bound.hpp:45); otherwise the rigorous
        Lagrangian safe bound from the approximately-feasible PDLP dual
        — never raw dual_objective from a PDLP iterate."""
        if raw.get("solved_by") == "dual_simplex" and \
                raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
            b = raw.get("dual_objective", math.nan)
            if b is not None and not math.isnan(b):
                return float(b)
        return self._safe_dual_bound(
            raw.get("dual_solution"), node.lv, node.uv
        )

    def _safe_dual_bound(self, y, lv, uv):
        """Rigorous lower bound from ANY dual vector y (Lagrangian bound).

        A PDLP dual iterate is only approximately feasible, so its reported
        dual objective cannot be used to prune (reference node bounds come
        from exact dual simplex, dual_simplex/branch_and_bound.hpp:45).
        Instead:  bound = sum_i y_i * (L_i if y_i>0 else U_i)
                        + sum_j r_j * (l_j if r_j>0 else u_j),
        with r = c - A^T y, which is a valid lower bound on the node LP for
        every y (weak duality on the Lagrangian). Duals that would multiply
        an infinite constraint bound are clamped to 0 first so the row term
        stays finite; an infinite variable bound hit by a nonzero reduced
        cost yields -inf (valid, just uninformative).
        """
        return safe_dual_bound(self.prob, y, lv, uv, self._nnz_rows)

    def _should_strong_branch(self, node, frac):
        """Strong-branch at shallow depth while pseudo-costs are cold
        (reference initializes pseudo-costs via multi-threaded strong
        branching, dual_simplex/pseudo_costs.cpp:236-258)."""
        if not self.use_simplex or node.depth > 4:
            return False
        cand = np.where(frac > self.int_tol)[0]
        if len(cand) < 2:
            return False
        cold = ((self._pc_up_n[cand] == 0) |
                (self._pc_dn_n[cand] == 0)).mean()
        return cold > 0.5

    def _strong_branch(self, node, x, frac, raw, timer, top_k=8,
                       iter_cap=300):
        """Score the top-k fractional candidates by actually solving both
        child LPs with a small iteration cap, in a thread pool (the
        simplex releases the GIL inside the C call). Seeds pseudo-costs
        and returns the product-rule winner."""
        from concurrent.futures import ThreadPoolExecutor
        import os as _os

        cand = np.where(frac > self.int_tol)[0]
        order = np.argsort(-frac[cand])
        cand = cand[order[:top_k]]
        vstat = raw.get("vstat")
        base = self._safe_dual_bound(
            raw.get("dual_solution"), node.lv, node.uv
        )

        def child_bound(j, up):
            lv2 = node.lv.copy()
            uv2 = node.uv.copy()
            if up:
                lv2[j] = math.ceil(x[j])
            else:
                uv2[j] = math.floor(x[j])
            if lv2[j] > uv2[j]:
                return math.inf
            r = self._solve_relaxation(
                lv2, uv2, timer=timer, vstat=vstat, iteration_cap=iter_cap,
            )
            if r["status"] == C.CUOPT_TERIMINATION_STATUS_INFEASIBLE:
                return math.inf
            fake = _Node(-math.inf, 0, lv2, uv2)
            return self._node_bound(r, fake)

        n_threads = max(1, min(8, (_os.cpu_count() or 2) - 1))
        jobs = [(int(j), up) for j in cand for up in (False, True)]
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            bounds = list(ex.map(lambda a: child_bound(*a), jobs))
        best_j, best_score = int(cand[0]), -math.inf
        for i, j in enumerate(cand):
            dn_b, up_b = bounds[2 * i], bounds[2 * i + 1]
            f = float(frac[j])
            dn_gain = max(dn_b - base, 0.0) if math.isfinite(dn_b) \
                else 1e6
            up_gain = max(up_b - base, 0.0) if math.isfinite(up_b) \
                else 1e6
            # seed pseudo-costs from the measured degradations
            if math.isfinite(dn_b) and self._pc_dn_n[j] == 0:
                self._pc_dn[j] = dn_gain / max(f, 1e-9)
                self._pc_dn_n[j] = 1
            if math.isfinite(up_b) and self._pc_up_n[j] == 0:
                self._pc_up[j] = up_gain / max(1.0 - f, 1e-9)
                self._pc_up_n[j] = 1
            score = max(dn_gain, 1e-6) * max(up_gain, 1e-6)
            if score > best_score:
                best_score, best_j = score, int(j)
        return best_j

    def _update_pseudo_cost(self, node, child_bound):
        j = node.branch_var
        if j < 0 or node.branch_frac <= 1e-12 or \
                not math.isfinite(child_bound) or \
                not math.isfinite(node.bound):
            return
        gain = max(child_bound - node.bound, 0.0)
        if node.branch_up:
            f = 1.0 - node.branch_frac
            self._pc_up[j] = (self._pc_up[j] * self._pc_up_n[j]
                              + gain / max(f, 1e-9)) / (
                self._pc_up_n[j] + 1)
            self._pc_up_n[j] += 1
        else:
            f = node.branch_frac
            self._pc_dn[j] = (self._pc_dn[j] * self._pc_dn_n[j]
                              + gain / max(f, 1e-9)) / (
                self._pc_dn_n[j] + 1)
            self._pc_dn_n[j] += 1

    def _select_branch_var(self, x, frac):
        """Pseudo-cost product rule with fractionality fallback for
        uninitialized variables."""
        cand = np.where(frac > self.int_tol)[0]
        if len(cand) == 0:
            return -1
        f = frac[cand]
        has_pc = (self._pc_up_n[cand] > 0) & (self._pc_dn_n[cand] > 0)
        if has_pc.any() and has_pc.mean() > 0.3:
            dn = np.where(self._pc_dn_n[cand] > 0, self._pc_dn[cand],
                          np.median(self._pc_dn[self._pc_dn_n > 0])
                          if (self._pc_dn_n > 0).any() else 1.0)
            up = np.where(self._pc_up_n[cand] > 0, self._pc_up[cand],
                          np.median(self._pc_up[self._pc_up_n > 0])
                          if (self._pc_up_n > 0).any() else 1.0)
            score = np.maximum(dn * f, 1e-6) * np.maximum(
                up * (1.0 - f), 1e-6
            )
            return int(cand[int(np.argmax(score))])
        return int(cand[int(np.argmax(f))])

    # internal orientation: minimize (maximize already negated by caller)
    def _solve_relaxation(self, lv, uv, x_warm=None, y_warm=None,
                          timer=None, effort=1, vstat=None,
                          iteration_cap=None, deadline=None):
        sub = self.prob
        node_prob = type(sub)(
            offsets=sub.offsets, indices=sub.indices, values=sub.values,
            objective_coefficients=sub.objective_coefficients,
            objective_offset=sub.objective_offset,
            maximize=False,
            constraint_lower_bounds=sub.constraint_lower_bounds,
            constraint_upper_bounds=sub.constraint_upper_bounds,
            row_types=sub.row_types, rhs=sub.rhs,
            variable_lower_bounds=lv, variable_upper_bounds=uv,
            variable_types=sub.variable_types,
            variable_names=sub.variable_names, row_names=sub.row_names,
        )
        s = PDLPSolverSettings()
        s.method = C.CUOPT_METHOD_PDLP
        s.set_optimality_tolerance(self.node_lp_tol)
        s.detect_infeasibility = True
        s.iteration_limit = 50_000 * int(effort)
        if iteration_cap is not None:
            s.iteration_limit = iteration_cap
        if timer is not None:
            s.time_limit = max(timer.remaining(), 0.5)
        if deadline is not None:
            # respect the cooperative slice deadline: one long node
            # solve must not overrun the whole slice (r04's cod105 run
            # blew 38s past its limit this way)
            import time as _time

            s.time_limit = max(
                min(s.time_limit, deadline - _time.monotonic() + 0.25),
                0.5,
            )
        if self.use_simplex:
            raw = solve_lp_simplex(node_prob, s, timer or Timer(),
                                   vstat=vstat, want_vstat=True)
            self.simplex_iters += raw["iterations"]
            return raw
        s.initial_primal_solution = x_warm
        s.initial_dual_solution = y_warm
        raw = PdlpSolver(node_prob, s, self.device).run()
        self.simplex_iters += raw["iterations"]
        return raw

    def _node_problem(self, lv, uv):
        sub = self.prob
        return type(sub)(
            offsets=sub.offsets, indices=sub.indices, values=sub.values,
            objective_coefficients=sub.objective_coefficients,
            objective_offset=sub.objective_offset,
            maximize=False,
            constraint_lower_bounds=sub.constraint_lower_bounds,
            constraint_upper_bounds=sub.constraint_upper_bounds,
            row_types=sub.row_types, rhs=sub.rhs,
            variable_lower_bounds=lv, variable_upper_bounds=uv,
            variable_types=sub.variable_types,
            variable_names=sub.variable_names, row_names=sub.row_names,
        )

    def _solve_relaxations_batch(self, nodes, timer):
        """Batched node relaxations: the frontier nodes share one sparsity
        pattern (only the variable bounds differ), so lp/batch.py stacks
        them into ONE batched PDLP program on `device`, split over a mesh
        of min(cards, nodes) cards when the tree solves on a card and
        more than one is attached (cuopt_tpu branch_and_bound.py:394-401,
        without its silent fallbacks). Returns raw dicts per node; a
        failure raises."""
        s = PDLPSolverSettings()
        s.method = C.CUOPT_METHOD_PDLP
        s.set_optimality_tolerance(self.node_lp_tol)
        s.detect_infeasibility = True
        s.iteration_limit = 50_000
        if timer is not None:
            s.time_limit = max(timer.remaining(), 0.5)
        probs = [self._node_problem(n.lv, n.uv) for n in nodes]
        mesh = None
        cards = torch.cuda.device_count()
        if torch.device(self.device).type == "cuda" and cards > 1 and \
                len(nodes) > 1:
            mesh = make_mesh(min(cards, len(nodes)))
        raws = [sol._raw for sol in batch_solve(probs, s, self.device,
                                                mesh=mesh)]
        for r in raws:
            self.simplex_iters += r.get("iterations", 0)
        return raws

    def _propagate(self, lv, uv):
        p = self.prob
        if self.probe_cache:
            lv = np.asarray(lv, float).copy()
            uv = np.asarray(uv, float).copy()
            for j, entry in self.probe_cache.items():
                if j < len(lv) and uv[j] - lv[j] <= self.int_tol:
                    hit = entry.get(int(round(lv[j])))
                    if hit is not None:
                        idx, l_imp, u_imp = hit
                        lv[idx] = np.maximum(lv[idx], l_imp)
                        uv[idx] = np.minimum(uv[idx], u_imp)
        return propagate_bounds(
            p.offsets, p.indices, p.values,
            p.constraint_lower_bounds, p.constraint_upper_bounds,
            lv, uv, self.is_int, max_rounds=5,
        )

    def set_incumbent(self, x, obj):
        """External (heuristic) incumbent injection, reference
        population.add_external_solution / set_new_solution."""
        with self._lock:
            if obj >= self.incumbent_obj - 1e-12:
                return
            self.incumbent = np.asarray(x, float)
            self.incumbent_obj = float(obj)
            callbacks = list(self.solution_callbacks)
            xc, oc = self.incumbent, self.incumbent_obj
        for cb in callbacks:
            cb(xc, oc)

    def _gap_closed(self):
        t = self.settings.tolerances
        if self.incumbent is None:
            return False
        gap = self.incumbent_obj - self.best_bound
        return gap <= t.absolute_mip_gap + t.relative_mip_gap * max(
            abs(self.incumbent_obj), 1e-10
        )

    def _start(self, timer):
        """Lazy search-state init so the search is resumable: `step`
        drives one bounded slice, `solve` loops it to completion. State
        (heap/pending/seq) lives on the instance across slices so the
        MIP orchestrator can interleave tree search with heuristic
        slices in ONE thread (no GIL starvation; reference runs them on
        separate CUDA streams, mip/solver.cu:125-190)."""
        if self._started:
            return
        self._started = True
        pres = self._propagate(
            self.prob.variable_lower_bounds.copy(),
            self.prob.variable_upper_bounds.copy(),
        )
        if pres.infeasible:
            self._root_infeasible = True
            self._heap = []
            return
        self._heap = [_Node(-math.inf, 0, pres.lv, pres.uv)]

    def step(self, timer, halt=None, deadline=None):
        """Run the best-first loop until `deadline` (time.monotonic
        seconds), the timer expires, or the search finishes. Returns
        True when the search is over (call `result()` for the outcome).
        """
        import time as _time

        self._start(timer)
        if self._root_infeasible:
            return True
        prob = self.prob
        heap = self._heap
        while heap or self._pending or self._dive:
            if timer.expired() or (halt is not None and halt.is_set()):
                return True
            if deadline is not None and _time.monotonic() >= deadline:
                return False  # suspended; resume with another step()
            if self.nodes_explored >= self.max_nodes:
                return True
            in_dive = False
            if self._pending:
                node, raw = self._pending.pop(0)
                if self.incumbent is not None and node.bound >= (
                    self.incumbent_obj - 1e-12
                ):
                    continue  # pruned while waiting in the batch
            elif self._dive:
                node = self._dive.pop()
                in_dive = True
                if self.incumbent is not None and node.bound >= (
                    self.incumbent_obj - 1e-12
                ):
                    continue  # plunge ends: child pruned by bound
                raw = self._solve_relaxation(
                    node.lv, node.uv, node.x_warm, node.y_warm,
                    timer, effort=node.effort, vstat=node.vstat,
                    deadline=deadline,
                )
                self.nodes_explored += 1
            elif not heap:
                break
            else:
                # a fresh plunge starts from every 4th best-first pop:
                # dives find incumbents (warm bases, rounding-preferred
                # children), best-first pops raise the global bound —
                # all-dive selection starved the bound side
                self._plunge_tick += 1
                in_dive = self._plunge_tick % 4 == 0
                node = heapq.heappop(heap)
                # best-first: heap top is the global bound
                self.best_bound = max(self.best_bound, node.bound) \
                    if node.bound > -math.inf else self.best_bound
                if self.incumbent is not None and node.bound >= (
                    self.incumbent_obj - 1e-12
                ):
                    # every open node's (rigorous) bound >= incumbent
                    self.best_bound = self.incumbent_obj
                    self._complete = True
                    return True
                if not self.use_simplex and len(heap) >= 3 and \
                        node.effort == 1:
                    # batched frontier relaxations (one vmapped program)
                    batch = [node]
                    while heap and len(batch) < 8 and \
                            heap[0].effort == 1:
                        batch.append(heapq.heappop(heap))
                    raws = self._solve_relaxations_batch(batch, timer)
                    self.nodes_explored += len(batch)
                    self._pending = list(zip(batch, raws))
                    node, raw = self._pending.pop(0)
                else:
                    raw = self._solve_relaxation(
                        node.lv, node.uv, node.x_warm, node.y_warm,
                        timer, effort=node.effort, vstat=node.vstat,
                        deadline=deadline,
                    )
                    self.nodes_explored += 1
            if raw["status"] == C.CUOPT_TERIMINATION_STATUS_INFEASIBLE:
                continue
            bound = max(node.bound, self._node_bound(raw, node))
            if raw["status"] not in (
                C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
            ):
                # unresolved node (iteration/time limit): re-queue with the
                # improved rigorous bound and more LP effort — dropping it
                # would silently lose the subtree (reference keeps nodes
                # open, branch_and_bound.hpp:45).
                if self.incumbent is not None and bound >= (
                    self.incumbent_obj - 1e-12
                ):
                    continue  # rigorous prune
                if timer.expired() or (
                    halt is not None and halt.is_set()
                ):
                    self._seq += 1
                    heapq.heappush(heap, _Node(
                        bound, self._seq, node.lv, node.uv, node.x_warm,
                        node.y_warm, node.depth, effort=node.effort,
                    ))
                    return True
                if node.effort >= 64:
                    self._lost_nodes += 1
                    continue
                self._seq += 1
                heapq.heappush(heap, _Node(
                    bound, self._seq, node.lv, node.uv, node.x_warm,
                    node.y_warm, node.depth, effort=node.effort * 4,
                ))
                continue
            self._update_pseudo_cost(node, bound)
            if self.incumbent is not None and bound >= (
                self.incumbent_obj - 1e-12
            ):
                continue  # prune by bound
            x = raw["primal_solution"]
            self.recent_x.append(np.asarray(x, float))
            frac = np.abs(x - np.round(x))
            frac = np.where(self.is_int, frac, 0.0)
            j = self._select_branch_var(x, frac)
            if j >= 0 and frac[j] > self.int_tol and \
                    self._should_strong_branch(node, frac):
                j = self._strong_branch(node, x, frac, raw, timer)
            if j < 0 or frac[j] <= self.int_tol:
                j = int(np.argmax(frac))
            if frac[j] <= self.int_tol:
                # integral: candidate incumbent
                xi = np.where(self.is_int, np.round(x), x)
                xi = np.clip(xi, node.lv, node.uv)
                if is_feasible(prob, xi):
                    obj = float(
                        prob.objective_coefficients @ xi
                        + prob.objective_offset
                    )
                    self.set_incumbent(xi, obj)
                continue
            # branch on the selected variable; the rounding-preferred
            # child goes on the plunge stack (depth-first dive with a
            # warm basis), the other to the best-first heap
            prefer_down = frac[j] < 0.5
            for child_dir in ("down", "up"):
                lv2 = node.lv.copy()
                uv2 = node.uv.copy()
                if child_dir == "down":
                    uv2[j] = math.floor(x[j])
                else:
                    lv2[j] = math.ceil(x[j])
                if lv2[j] > uv2[j]:
                    continue
                pres = self._propagate(lv2, uv2)
                if pres.infeasible:
                    continue
                self._seq += 1
                child = _Node(
                    bound, self._seq, pres.lv, pres.uv,
                    x_warm=x, y_warm=raw["dual_solution"],
                    vstat=raw.get("vstat"),
                    depth=node.depth + 1,
                    branch_var=j, branch_up=(child_dir == "up"),
                    branch_frac=float(frac[j]),
                )
                preferred = (child_dir == "down") == prefer_down
                if preferred and in_dive and self.use_simplex and \
                        len(self._dive) < 64:
                    self._dive.append(child)
                else:
                    heapq.heappush(heap, child)
            if self._gap_closed():
                return True
        return True  # heap + pending exhausted

    def solve(self, timer, halt=None):
        """Best-first search to completion. Returns dict with
        incumbent/bound/status."""
        while not self.step(timer, halt=halt):
            pass
        return self.result()

    def result(self):
        """Outcome of the search so far (valid after any step())."""
        if self._root_infeasible:
            return self._result(C.CUOPT_TERIMINATION_STATUS_INFEASIBLE)
        complete = self._complete
        if self._started and not self._heap and not self._pending \
                and not self._dive and self._lost_nodes == 0:
            # heap exhausted with no lost subtrees: search complete
            complete = True
            if self.incumbent is not None:
                self.best_bound = self.incumbent_obj
        complete = complete and self._lost_nodes == 0
        if complete and self.incumbent is None:
            return self._result(C.CUOPT_TERIMINATION_STATUS_INFEASIBLE)
        if self._gap_closed() or (complete and self.incumbent is not None):
            return self._result(C.CUOPT_TERIMINATION_STATUS_OPTIMAL)
        if self.incumbent is not None:
            return self._result(C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND)
        return self._result(C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT)

    def _result(self, status):
        return {
            "status": status,
            "incumbent": self.incumbent,
            "incumbent_obj": self.incumbent_obj,
            "best_bound": self.best_bound,
            "nodes": self.nodes_explored,
            "simplex_iters": self.simplex_iters,
        }
