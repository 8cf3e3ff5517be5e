"""Population / diversity manager for the MIP heuristic engine.

Counterpart of cuopt_tpu/mip/population.py, with role parity with the
reference diversity manager
(cpp/src/mip/diversity/diversity_manager.cuh:38 `run_solver`,
population.cuh:34): a fixed-size pool split into feasible/infeasible
halves, recombination of pairs (agreeing integers fixed, disagreement
set re-optimized by a batched feasibility-jump run), external (B&B)
solution injection, and user solution callbacks.

The recombination sub-search runs the same batched FJ climbers as the
main heuristic (feasibility_jump.py), with tightened variable bounds and
on the solve's device: the analogue of the reference's bound-prop
recombiner.
"""

from __future__ import annotations

import math
import time

import numpy as np

import torch

from cuopt_torch.lp.internals import (
    GetSolutionCallback,
    SetSolutionCallback,
)
from cuopt_torch.lp.settings import MIPSolverSettings
from cuopt_torch.mip.branch_and_bound import BranchAndBound
from cuopt_torch.mip.feasibility_jump import run_feasibility_jump
from cuopt_torch.mip.feasibility_pump import line_segment_search
from cuopt_torch.mip.presolve import eliminate_fixed, propagate_bounds
from cuopt_torch.mip.rounding import is_feasible, lp_completion, violation
from cuopt_torch.utils.logger import get_logger
from cuopt_torch.utils.timer import Timer


class Population:
    """Solution pool (internal minimize orientation)."""

    def __init__(self, prob, max_size=16, int_tol=1e-5):
        import threading

        self.prob = prob
        self.max_size = max_size
        self.int_tol = int_tol
        self.feasible: list[tuple[float, np.ndarray]] = []  # (obj, x)
        self.infeasible: list[tuple[float, np.ndarray]] = []  # (viol, x)
        self.callbacks = []
        self.log = get_logger()
        # heuristic workers and the B&B callback insert concurrently
        self._lock = threading.RLock()
        # adaptive feasibility weight (reference population.cuh:34):
        # the infeasible half is ranked by obj + w * violation; w rises
        # when feasible members are scarce (pressure toward
        # feasibility) and falls when they are plentiful (near-feasible
        # members with good objectives survive and steer recombination)
        self.infeas_weight = 1.0

    @property
    def best(self):
        with self._lock:
            return self.feasible[0] if self.feasible else None

    def snapshot(self, k=None):
        """Consistent copies of (feasible, infeasible) prefixes."""
        with self._lock:
            return list(self.feasible[:k]), list(self.infeasible[:k])

    def add(self, x, from_external=False) -> bool:
        """Insert a candidate; returns True if it improved the best."""
        x = np.asarray(x, float)
        if is_feasible(self.prob, x, tol=1e-6):
            obj = float(self.prob.objective_coefficients @ x
                        + self.prob.objective_offset)
            with self._lock:
                improved = not self.feasible or \
                    obj < self.feasible[0][0] - 1e-12
                if any(abs(obj - o) < 1e-12 and np.allclose(x, xx)
                       for o, xx in self.feasible):
                    return False
                self.feasible.append((obj, x))
                self.feasible.sort(key=lambda t: t[0])
                del self.feasible[self.max_size:]
            if improved and not from_external:
                self._run_get_callbacks(x, obj)
            return improved
        v = violation(self.prob, x)
        with self._lock:
            self.infeasible.append((v, x))
            self._sort_infeasible_locked()
            del self.infeasible[self.max_size:]
        return False

    def _sort_infeasible_locked(self):
        c = self.prob.objective_coefficients
        off = self.prob.objective_offset
        w = self.infeas_weight
        self.infeasible.sort(
            key=lambda t: float(c @ t[1] + off) + w * t[0]
        )

    def adapt_weight(self):
        """Re-balance the infeasible-half ranking pressure from the
        current feasible/infeasible mix (reference adaptive weights,
        population.cuh:34)."""
        with self._lock:
            nf, ni = len(self.feasible), len(self.infeasible)
            if nf < 2 and ni:
                self.infeas_weight = min(self.infeas_weight * 1.3, 1e6)
            elif nf > max(ni, 2):
                self.infeas_weight = max(self.infeas_weight / 1.3, 1e-3)
            self._sort_infeasible_locked()

    # ------------------------------------------------------------ callbacks
    def _run_get_callbacks(self, x, obj):
        for cb in self.callbacks:
            if isinstance(cb, GetSolutionCallback):
                try:
                    cb.get_solution(x.copy(), np.array([obj]))
                except Exception as e:  # user code must not kill the solve
                    self.log.warning(f"get_solution callback failed: {e}")

    def poll_set_callbacks(self):
        """Ask SetSolutionCallbacks for injected solutions (reference
        callbacks_implems.hpp:28-88)."""
        m = self.prob.n_variables
        for cb in self.callbacks:
            if isinstance(cb, SetSolutionCallback):
                buf = np.full(m, np.nan)
                if self.best is not None:
                    buf[:] = self.best[1]
                cost = np.array([math.inf])
                try:
                    cb.set_solution(buf, cost)
                except Exception as e:
                    self.log.warning(f"set_solution callback failed: {e}")
                    continue
                if np.all(np.isfinite(buf)):
                    self.add(buf)


def recombine(prob, xa, xb, rng, fj_budget_s=0.5, dtype="float64",
              device="cuda"):
    """Bound-prop recombiner (reference diversity_manager.cuh
    `recombine` :49 with the bound-propagation recombiner): fix integers
    where parents agree, PROPAGATE the implied bounds through the
    constraints (shrinking the disagreement set's domains), then
    re-optimize the rest with a short batched FJ run on `device`."""
    is_int = prob.variable_types == "I"
    agree = is_int & (np.abs(xa - xb) < 1e-9)
    if agree.sum() == 0 or agree.sum() == is_int.sum():
        return None
    lv = np.where(agree, np.round(xa), prob.variable_lower_bounds)
    uv = np.where(agree, np.round(xa), prob.variable_upper_bounds)
    pres = propagate_bounds(
        prob.offsets, prob.indices, prob.values,
        prob.constraint_lower_bounds, prob.constraint_upper_bounds,
        lv, uv, is_int, max_rounds=3,
    )
    if pres.infeasible:
        return None  # the agreement set cannot be completed
    sub = type(prob)(
        offsets=prob.offsets, indices=prob.indices, values=prob.values,
        objective_coefficients=prob.objective_coefficients,
        objective_offset=prob.objective_offset, maximize=False,
        constraint_lower_bounds=prob.constraint_lower_bounds,
        constraint_upper_bounds=prob.constraint_upper_bounds,
        row_types=prob.row_types, rhs=prob.rhs,
        variable_lower_bounds=pres.lv,
        variable_upper_bounds=pres.uv,
        variable_types=prob.variable_types,
    )
    mix = np.where(rng.uniform(size=len(xa)) < 0.5, xa, xb)
    starts = [mix, (xa + xb) / 2]
    x, obj, found = run_feasibility_jump(
        sub, starts, fj_budget_s, seed=int(rng.integers(1 << 30)),
        dtype=torch.float64 if dtype == "float64" else torch.float32,
        device=device,
    )
    if not found:
        return None
    return np.asarray(x)


def run_diversity_loop(prob, pop: Population, timer, deadline_s,
                       bnb=None, rng=None, dtype="float64",
                       x_relax=None, use_fj=True, device="cuda"):
    """Evolutionary improvement loop (reference diversity_manager.cuh
    run_solver :42): recombine + line-segment search + callback polling,
    pushing improvements into the B&B (set_new_solution) until the
    deadline. LP completions, sub-MIPs and recombinations run on
    `device`."""
    log = get_logger()
    rng = rng or np.random.default_rng(0)
    is_int = prob.variable_types == "I"
    mixed = bool(is_int.any()) and not bool(is_int.all())
    t_end = time.monotonic() + deadline_s

    def left():
        return t_end - time.monotonic()

    def add(x, tag):
        """pop.add + improvement logging (which move family earned it)."""
        before = pop.best[0] if pop.best is not None else math.inf
        got = pop.add(x)
        if got and pop.best is not None and pop.best[0] < before - 1e-9:
            log.debug(f"diversity[{tag}] incumbent {pop.best[0]:.6g}")
        return got

    rounds = 0
    while left() > 0 and not timer.expired():
        rounds += 1
        pop.poll_set_callbacks()
        pop.adapt_weight()
        improved = False
        pool, infeas_pool = pop.snapshot(6)
        if mixed and bnb is not None and rounds % 2 == 0 and \
                getattr(bnb, "recent_x", None) and left() > 0.3:
            # dive completions: round + LP-complete recent B&B node
            # relaxations — their integer patterns carry the tree's
            # diversity (reference B&B node repair role)
            try:
                xn = bnb.recent_x.popleft()
            except IndexError:
                xn = None
            if xn is not None:
                xc, objc = lp_completion(
                    prob, xn, timer, time_cap=min(2.0, left()),
                    device=device,
                )
                if xc is not None:
                    improved |= add(xc, "dive-completion")
        if mixed and pool and rounds % 2 == 1 and left() > 0.3:
            # local-branching completion: flip a few of the incumbent's
            # binaries and LP-complete the pattern (the strongest primal
            # move on mixed lot-sizing-style instances; reference
            # relaxed_lp.cuh run_lp_with_vars_fixed role)
            xb = pool[0][1].copy()
            bins = np.where(
                is_int
                & (prob.variable_upper_bounds
                   - prob.variable_lower_bounds <= 1.0 + 1e-9)
                & np.isfinite(prob.variable_lower_bounds)
                & np.isfinite(prob.variable_upper_bounds)
            )[0]
            if len(bins):
                # graded neighborhood sizes: small flips exploit, large
                # flips diversify (local-branching radius schedule)
                k = int(rng.choice([1, 2, 4, 8, 16,
                                    max(1, int(0.05 * len(bins)))]))
                pick = rng.choice(bins, size=min(k, len(bins)),
                                  replace=False)
                xb[pick] = (prob.variable_lower_bounds[pick]
                            + prob.variable_upper_bounds[pick]
                            - xb[pick])
            xc, objc = lp_completion(
                prob, xb, timer, time_cap=min(2.0, left()),
                device=device,
            )
            if xc is not None:
                improved |= add(xc, "local-branch")
        if pool and rounds % 3 == 0 and left() > 1.0 and \
                not timer.expired():
            # sub-MIP LNS: exact B&B over a RINS/mutation neighborhood
            xs = submip_improve(
                prob, pool[0][1], x_relax, rng, timer,
                budget_s=min(4.0, left()), device=device,
            )
            if xs is not None:
                improved |= add(xs, "submip-lns")
        if use_fj and len(pool) >= 2 and left() > 0.2:
            i, j = rng.choice(len(pool), size=2, replace=False)
            xb = pool[j][1]
            # weight-ranked infeasible members feed recombination too —
            # search pressure from the infeasible half (reference
            # population.cuh:34)
            if infeas_pool and rng.uniform() < 0.3:
                xb = infeas_pool[0][1]
            child = recombine(
                prob, pool[i][1], xb, rng,
                fj_budget_s=min(0.5, max(t_end - time.monotonic(), 0.05)),
                dtype=dtype, device=device,
            )
            if child is not None:
                if mixed:
                    xc, _ = lp_completion(
                        prob, child, timer,
                        time_cap=min(2.0, max(t_end - time.monotonic(),
                                              0.1)),
                        device=device,
                    )
                    if xc is not None:
                        child = xc
                improved |= add(child, "recombine")
        if x_relax is not None and pool and left() > 0.1:
            x, obj, found = line_segment_search(
                prob, x_relax, pool[0][1]
            )
            if found:
                improved |= add(x, "line-segment")
            # RINS-style dive (relaxation-induced neighborhood): fix the
            # integers where the incumbent AGREES with the rounded LP
            # relaxation, bound-prop + FJ the disagreement set — the
            # reference's relaxed-LP-guided recombination
            # (diversity_manager.cuh + relaxed_lp.cuh roles)
            if use_fj and rounds % 3 == 1 and left() > 0.3:
                xr_round = np.where(is_int, np.round(x_relax), x_relax)
                child = recombine(
                    prob, pool[0][1], xr_round, rng,
                    fj_budget_s=min(
                        2.0, max(t_end - time.monotonic(), 0.05)
                    ),
                    dtype=dtype, device=device,
                )
                if child is not None:
                    if mixed:
                        xc, _ = lp_completion(
                            prob, child, timer,
                            time_cap=min(
                                2.0,
                                max(t_end - time.monotonic(), 0.1),
                            ),
                            device=device,
                        )
                        if xc is not None:
                            child = xc
                    improved |= add(child, "rins-recombine")
        if infeas_pool and pool and left() > 0.1:
            # try pulling an infeasible candidate towards the best
            x, obj, found = line_segment_search(
                prob, infeas_pool[0][1], pool[0][1],
            )
            if found:
                improved |= add(x, "infeas-pull")
        if improved and bnb is not None and pop.best is not None:
            bnb.set_incumbent(pop.best[1], pop.best[0])
        # B&B preemption (reference diversity_manager.cuh:38): when the
        # tree search has (nearly) closed the gap, heuristic cycles are
        # wasted — yield the remaining budget
        if bnb is not None and pop.best is not None and \
                math.isfinite(bnb.best_bound):
            gap = pop.best[0] - bnb.best_bound
            if gap <= 1e-6 * max(1.0, abs(pop.best[0])):
                break
        if not improved and rounds > 4 and len(pool) < 2:
            break  # nothing to evolve
    return rounds


def submip_improve(prob, x_inc, x_relax, rng, timer, budget_s=4.0,
                   free_frac=0.2, settings=None, device="cuda"):
    """Large-neighborhood sub-MIP: fix most integers at the incumbent,
    solve the remaining small MIP EXACTLY with the host B&B, and map the
    result back (RINS when guided by the relaxation, mutation-LNS when
    random) — the reference gets the same effect from its recombiners +
    B&B repair (diversity_manager.cuh:49, relaxed_lp.cuh).

    Returns an improved full-space x or None.
    """
    is_int = prob.variable_types == "I"
    idx_int = np.flatnonzero(is_int)
    if len(idx_int) == 0:
        return None
    x_inc = np.asarray(x_inc, float)
    xi = np.round(x_inc[idx_int])
    # Neighborhood size: the sub-MIP must be EXACTLY solvable inside its
    # few-second budget, so cap the freed-integer count — on a
    # 1,600-integer instance, free_frac alone would free ~300 and the
    # sub-B&B times out having proven nothing (50v-10 plateau, r05).
    want = min(96, max(8, int(free_frac * len(idx_int))))
    if x_relax is not None and rng.uniform() < 0.5:
        # RINS: free the integers that DISAGREE with the relaxation
        xr = np.round(np.asarray(x_relax, float)[idx_int])
        free = xi != xr
        if free.sum() > want:  # keep a random want-sized subset
            keep = rng.choice(np.flatnonzero(free), size=want,
                              replace=False)
            free = np.zeros(len(idx_int), bool)
            free[keep] = True
        elif free.sum() < want:
            pool = np.flatnonzero(~free)
            extra = rng.choice(pool, size=min(want - int(free.sum()),
                                              len(pool)), replace=False)
            free[extra] = True
    else:
        free = np.zeros(len(idx_int), bool)
        free[rng.choice(len(idx_int), size=min(want, len(idx_int)),
                        replace=False)] = True
    lv = prob.variable_lower_bounds.copy().astype(float)
    uv = prob.variable_upper_bounds.copy().astype(float)
    fix = idx_int[~free]
    lv[fix] = uv[fix] = np.clip(np.round(x_inc[fix]), lv[fix], uv[fix])
    red = eliminate_fixed(prob, lv, uv, 1e-9)
    if red is None:
        return None
    sub = red.problem
    s = settings or MIPSolverSettings()
    bnb = BranchAndBound(sub, s, device=device)
    x0 = red.project(x_inc)
    if is_feasible(sub, x0):
        obj0 = float(sub.objective_coefficients @ x0
                     + sub.objective_offset)
        bnb.set_incumbent(x0, obj0)
    t = Timer(min(budget_s, max(timer.remaining(), 0.2)))
    res = bnb.solve(t)
    if res.get("incumbent") is None:
        return None
    out = red.postsolve(res["incumbent"])
    if not is_feasible(prob, out):
        return None
    return out
