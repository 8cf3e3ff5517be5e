"""MIP solve orchestration.

Counterpart of cuopt_tpu/mip/solve.py, which mirrors reference
cpp/src/mip/solve.cu (`run_mip` :67, `solve_mip` :155) and solver.cu
(`run_solver` :84): presolve and probing on the host, the root relaxation
(host dual simplex when the instance fits its gate, else PDLP on the
card), heuristics running alongside a host branch-and-bound, with
incumbents flowing both ways.

  - The feasibility-jump climbers (mip/feasibility_jump.py) step on the
    card in a background thread, under a CUDA stream of their own: the
    counterpart of the reference's heuristic stream (mip/solver.cu:125-190).
    The thread is joined before the solve returns.
  - Roundings, LP completions, the feasibility pump and the population
    loop feed the same thread-safe population; the B&B and the population
    loop share the main thread in cooperative time slices, as in
    cuopt_tpu.
  - Root GMI cuts lift the tree's bound where the root LP passes the cut
    gate (mip/cuts.py strengthen_root).

Where this differs from cuopt_tpu, without changing a result:
  - the user's problem is never modified: presolve works on a copy;
  - a heuristic that fails (the FJ thread, the pump inside it, a
    population slice) stops, and its exception is logged and kept in the
    result under "heuristic_errors", while B&B's answer stands; nothing
    else is caught: a failing root LP, cut round or B&B raises;
  - `device` is "cuda" unless the caller asks for "cpu"; without a card
    the call raises at once;
  - the FJ thread starts before the roundings' LP completions, not after
    them, and a tree that stops without an incumbent and without a proof
    (its unsolved nodes used up their LP effort) leaves the rest of the
    time limit to it: on the 50k staircase MIP the completions and the
    tree's PDLP nodes each take tens of seconds;
  - the climbers bump weights without decay (FjEngine's decay 1.0, where
    cuopt_tpu's 0.95 caps a violated row's weight at 20 (1 + v)) and aim
    each row a margin of 1% of its 1-norm inside its bounds: on the 50k
    staircase MIP cuopt_tpu's rule left them at six violated rows;
  - when there is no incumbent to recombine, the heuristic share of each
    round of the tree is left to the FJ thread.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import threading
import time

import numpy as np
import torch

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex import is_available
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.lp.internals import (
    GetSolutionCallback,
    SetSolutionCallback,
)
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import MIPSolverSettings, PDLPSolverSettings
from cuopt_torch.lp.solution import Solution
from cuopt_torch.lp.solve import _solve_no_constraints
from cuopt_torch.mip.branch_and_bound import BranchAndBound, safe_dual_bound
from cuopt_torch.mip.cuts import strengthen_root
from cuopt_torch.mip.feasibility_jump import FjEngine
from cuopt_torch.mip.feasibility_pump import feasibility_pump
from cuopt_torch.mip.population import Population, run_diversity_loop
from cuopt_torch.mip.presolve import (
    eliminate_fixed,
    probe_variables,
    propagate_bounds,
)
from cuopt_torch.mip.rounding import (
    bounds_repair_rounding,
    constraint_prop_rounding,
    fits_simplex,
    is_feasible,
    lp_completion,
    make_roundings,
)
from cuopt_torch.utils.logger import get_logger, solve_log_context
from cuopt_torch.utils.timer import Timer

HEURISTIC_THREAD = "cuopt-torch-mip-heuristics"
# the FJ thread's weight decay and row margin (FjEngine; module docstring)
FJ_DECAY, FJ_MARGIN = 1.0, 0.01


def _internal_minimize(prob):
    """A minimize-orientation copy of `prob` (maximize handled by negation,
    like the device problem build) and the sign that maps its objective
    back. Always a copy: presolve rebinds its bounds."""
    if not prob.maximize:
        return dataclasses.replace(prob), 1.0
    return dataclasses.replace(
        prob, objective_coefficients=-prob.objective_coefficients,
        objective_offset=-prob.objective_offset, maximize=False), -1.0


def solve_mip(prob, settings: MIPSolverSettings | None = None,
              device="cuda") -> Solution:
    """Solve a MIP; the device work (PDLP relaxations, the FJ climbers)
    runs on `device`, "cuda" unless the caller asks for "cpu"."""
    settings = settings or MIPSolverSettings()
    device = torch.device(device)
    torch.empty(0, device=device)  # no card: raises here, not later
    log = get_logger()
    with solve_log_context(settings.log_file or None,
                           settings.log_to_console):
        prob.validate()
        timer = Timer(settings.time_limit)
        errors: list[str] = []
        raw = _run_mip(prob, settings, timer, log, device, errors)
        raw["heuristic_errors"] = errors
        sol = Solution(prob, raw)
        if settings.solution_file:
            sol.write_to_sol_file(settings.solution_file)
        log.info(
            f"MIP solve done: status={sol.get_termination_reason()} "
            f"obj={raw.get('primal_objective', float('nan')):.10g} "
            f"bound={raw.get('solution_bound', float('nan')):.10g} "
            f"nodes={raw.get('nodes', 0)} time={timer.elapsed():.2f}s")
        return sol


def _make_raw(prob, sign, x, obj, bound, status, nodes=0, iters=0,
              timer=None):
    is_int = prob.variable_types == "I"
    if x is not None:
        x = np.asarray(x, float)
        x = np.where(is_int, np.round(x), x)
    gap = math.inf
    if x is not None and math.isfinite(bound):
        gap = abs(obj - bound) / max(abs(obj), 1e-10)
    return {
        "status": status,
        "iterations": iters,
        "attempts": 0,
        "nodes": nodes,
        "solve_time": timer.elapsed() if timer else 0.0,
        "primal_solution": x if x is not None else np.zeros(
            prob.n_variables),
        "dual_solution": None,
        "reduced_cost": None,
        "primal_objective": sign * obj if x is not None else math.nan,
        "dual_objective": sign * bound if math.isfinite(bound)
        else math.nan,
        "gap": gap,
        "mip_gap": gap,
        "solution_bound": sign * bound if math.isfinite(bound)
        else math.nan,
        "l2_primal_residual": 0.0,
        "l2_dual_residual": 0.0,
        "linf_primal_residual": 0.0,
        "linf_dual_residual": 0.0,
    }


def _run_mip(prob, settings, timer, log, device, errors):
    pint, sign = _internal_minimize(prob)
    is_int = pint.variable_types == "I"
    m, n = pint.n_variables, pint.n_constraints

    def infeasible():
        return _make_raw(prob, sign, None, math.nan, -math.inf,
                         C.CUOPT_TERIMINATION_STATUS_INFEASIBLE, timer=timer)

    # ---- trivial cases ----
    if m == 0 or n == 0:
        raw = _solve_no_constraints(prob)
        raw["mip_gap"] = 0.0
        raw["solution_bound"] = raw["primal_objective"]
        raw["nodes"] = 0
        return raw

    # ---- presolve: bound propagation ----
    int_tol = settings.tolerances.integrality_tolerance
    pres = propagate_bounds(
        pint.offsets, pint.indices, pint.values,
        pint.constraint_lower_bounds, pint.constraint_upper_bounds,
        pint.variable_lower_bounds, pint.variable_upper_bounds,
        is_int, max_rounds=10, int_tol=int_tol)
    if pres.infeasible:
        return infeasible()
    pint.variable_lower_bounds = pres.lv
    pint.variable_upper_bounds = pres.uv

    # ---- presolve: probing on binaries (reference multi_probe.cuh) ----
    probe_cache = None
    if not timer.expired():
        n_bin = int(np.sum(is_int & np.isfinite(pres.lv)
                           & np.isfinite(pres.uv)
                           & (pres.uv - pres.lv <= 1.0 + 1e-9)))
        if n_bin > 0:
            pr = probe_variables(
                pint.offsets, pint.indices, pint.values,
                pint.constraint_lower_bounds, pint.constraint_upper_bounds,
                pres.lv, pres.uv, is_int,
                max_probes=min(64, max(4, int(2e6) // max(1, pint.nnz))),
                int_tol=int_tol)
            if pr.infeasible:
                return infeasible()
            if pr.n_fixed or pr.tightened:
                log.debug(f"probing: {pr.n_probed} probed, {pr.n_fixed} "
                          f"fixed, {pr.tightened} bounds tightened")
            pint.variable_lower_bounds = pr.lv
            pint.variable_upper_bounds = pr.uv
            pres.lv, pres.uv = pr.lv, pr.uv
            probe_cache = pr.cache

    # trivial presolve: eliminate fixed variables + compact the CSR
    # (reference trivial_presolve.cuh), solve the reduced MIP and
    # postsolve the assignment back to user space
    red = eliminate_fixed(pint, pres.lv, pres.uv, int_tol)
    if red is not None:
        sub = copy.copy(settings)
        sub.initial_solutions = [
            red.project(x0) for x0 in settings.initial_solutions
            if len(np.asarray(x0)) == m]
        sub.mip_callbacks = [_postsolved(cb, red)
                             for cb in settings.mip_callbacks]
        log.debug(f"trivial presolve: eliminated {int(red.fixed.sum())} "
                  f"fixed variables ({m} -> {len(red.keep)})")
        raw = _run_mip(red.problem, sub, timer, log, device, errors)
        x_red = raw.get("primal_solution")
        has_x = x_red is not None and not math.isnan(
            raw.get("primal_objective", math.nan))
        bound = raw.get("solution_bound", math.nan)
        out = _make_raw(
            prob, sign,
            red.postsolve(x_red) if has_x else None,
            raw.get("primal_objective", math.nan) if has_x else math.nan,
            bound if bound is not None and not math.isnan(bound)
            else -math.inf,
            raw["status"], nodes=raw.get("nodes", 0),
            iters=raw.get("iterations", 0), timer=timer)
        for k in ("fj", "mip_stats"):
            if k in raw:
                out[k] = raw[k]
        return out

    # all variables fixed by presolve?
    if np.all(pres.lv >= pres.uv - 1e-9):
        x = (pres.lv + pres.uv) / 2
        x = np.where(is_int, np.round(x), x)
        if is_feasible(pint, x):
            obj = float(pint.objective_coefficients @ x
                        + pint.objective_offset)
            return _make_raw(prob, sign, x, obj, obj,
                             C.CUOPT_TERIMINATION_STATUS_OPTIMAL, timer=timer)
        return infeasible()

    return _MipRun(prob, pint, sign, settings, timer, log, device, errors,
                   probe_cache, pres).run()


class _PostsolvedGet(GetSolutionCallback):
    """A user's GetSolutionCallback fed solutions of the reduced problem
    of trivial presolve: each is postsolved to the user's space first."""

    def __init__(self, cb, red):
        self.cb, self.red = cb, red

    def get_solution(self, solution, solution_cost):
        self.cb.get_solution(self.red.postsolve(solution), solution_cost)


class _PostsolvedSet(SetSolutionCallback):
    """A user's SetSolutionCallback polled by the reduced problem: it
    fills a buffer of the user's space, projected back afterwards."""

    def __init__(self, cb, red):
        self.cb, self.red = cb, red

    def set_solution(self, solution, solution_cost):
        full = self.red.postsolve(solution)
        self.cb.set_solution(full, solution_cost)
        solution[:] = self.red.project(full)


def _postsolved(cb, red):
    """`cb` wrapped for the reduced problem. (cuopt_tpu wraps each
    callback in a plain function, which its population then skips, so
    no callback of a reduced solve reaches the user there.)"""
    if isinstance(cb, GetSolutionCallback):
        return _PostsolvedGet(cb, red)
    if isinstance(cb, SetSolutionCallback):
        return _PostsolvedSet(cb, red)
    return cb


class _MipRun:
    """One MIP solve after presolve: population, root relaxation,
    heuristics, cuts and the tree."""

    def __init__(self, prob, pint, sign, settings, timer, log, device,
                 errors, probe_cache, pres):
        self.prob, self.pint, self.sign = prob, pint, sign
        self.settings, self.timer, self.log = settings, timer, log
        self.device, self.errors = device, errors
        self.probe_cache, self.pres = probe_cache, pres
        self.is_int = pint.variable_types == "I"
        self.mixed = bool(self.is_int.any()) and not bool(self.is_int.all())
        self.dtype = (torch.float64 if settings.dtype == "float64"
                      else torch.float32)
        self.pop = Population(pint, int_tol=settings.tolerances
                              .integrality_tolerance)
        self.pop.callbacks = list(settings.mip_callbacks)
        # the heuristic thread and the main thread share these
        self.heur_stop = threading.Event()
        self.heur_done = threading.Event()  # set after the first FJ chunk
        self.inject = {"bnb": None, "x_relax": None}
        self.fj_engine = None
        self.heur_thread = None
        self.diversity_failed = False

    # ------------------------------------------------------------ errors
    def _record(self, where, e):
        msg = f"{where}: {type(e).__name__}: {e}"
        self.errors.append(msg)
        self.log.warning(f"heuristic failed, B&B goes on: {msg}")

    def _objective(self, x):
        return float(self.pint.objective_coefficients @ x
                     + self.pint.objective_offset)

    # ------------------------------------------------- heuristic thread
    def _push(self, x, obj):
        if self.heur_stop.is_set():
            return
        self.pop.add(x)
        b = self.inject.get("bnb")
        if b is not None:
            b.set_incumbent(x, obj)

    def _harvest(self, out):
        if out is None:
            return
        pint, timer = self.pint, self.timer
        xfj, objfj = out
        obj = objfj + float(pint.objective_offset)
        xfj = np.where(self.is_int, np.round(xfj), xfj)
        if not is_feasible(pint, xfj):
            self.log.debug(f"[{timer.elapsed():.1f}s] fj candidate "
                           f"{obj:.6g} failed exact recheck")
            return
        # on mixed instances the climber's continuous part is whatever the
        # jumps left it at: the LP completion of its integer pattern is
        # the exact best version
        if self.mixed and not timer.expired():
            xc, objc = lp_completion(pint, xfj, timer, time_cap=2.0,
                                     device=self.device)
            if xc is not None and objc < obj:
                xfj, obj = xc, objc
        self._push(xfj, obj)
        self.log.debug(f"[{timer.elapsed():.1f}s] fj incumbent {obj:.6g}")

    def _heuristic_thread(self, fj_starts):
        stream = contextlib.nullcontext()
        if self.device.type == "cuda":
            stream = torch.cuda.stream(torch.cuda.Stream(self.device))
        try:
            with stream:
                eng = FjEngine(self.pint, fj_starts[:8], dtype=self.dtype,
                               device=self.device, decay=FJ_DECAY,
                               margin=FJ_MARGIN)
                self.fj_engine = eng
                self._harvest(eng.step())
                self.heur_done.set()
                if not self.heur_stop.is_set():
                    self._stepping_loop(eng)
        except Exception as e:  # recorded: the solve goes on without it
            self._record("feasibility jump thread", e)
        finally:
            self.heur_done.set()

    def _stepping_loop(self, eng):
        """Chunk-step the climbers for the rest of the solve, with the
        pump once when FJ cannot reach feasibility, the root's roundings
        and incumbent-aware restarts (cuopt_tpu mip/solve.py:347)."""
        pumped = False
        last_inc = math.inf
        since_reseed = 0
        timer = self.timer
        while not self.heur_stop.is_set() and not timer.expired():
            out = eng.step()
            since_reseed += 1
            self._harvest(out)
            # feasibility pump once, when FJ can't reach feasibility
            # (reference local_search/feasibility_pump/)
            x_rel = self.inject.get("x_relax")
            if not pumped and self.pop.best is None and \
                    eng.chunks >= 24 and x_rel is not None:
                pumped = True
                r = timer.remaining()
                budget = 5.0 if not math.isfinite(r) else min(0.3 * r, 15.0)
                xfp, objfp, found = feasibility_pump(
                    self.pint, x_rel, budget,
                    int_tol=self.settings.tolerances.integrality_tolerance,
                    dtype=self.settings.dtype, device=self.device)
                if found:
                    self._push(xfp, objfp)
            # once the root relaxation lands, restart part of the batch
            # from its roundings
            seeds = self.inject.pop("seeds", None)
            if seeds:
                for xs in seeds[:3]:
                    eng.reseed(xs, n_replace=1)
            # incumbent-aware restarts when the pool's best moved or the
            # climbers have gone stale
            best = self.pop.best
            if best is not None and (
                    best[0] < last_inc - 1e-9 or since_reseed >= 64):
                last_inc = best[0]
                since_reseed = 0
                eng.reseed(best[1])
            if eng.chunks % 64 == 0:
                self.log.debug(f"[{timer.elapsed():.1f}s] fj chunks="
                               f"{eng.chunks} best={eng.pushed_obj:.6g}")

    def _diversity(self, budget, bnb, seed, x_relax, use_fj=True):
        """One population slice; a failure is recorded and ends the
        slices."""
        if self.diversity_failed:
            return
        try:
            run_diversity_loop(
                self.pint, self.pop, self.timer, budget, bnb=bnb,
                rng=np.random.default_rng(seed), dtype=self.settings.dtype,
                x_relax=x_relax, use_fj=use_fj, device=self.device)
        except Exception as e:  # recorded: the solve goes on without it
            self.diversity_failed = True
            self._record("population loop", e)

    # -------------------------------------------------------------- run
    def _add_feasible(self, xs, incumbent):
        """Add the feasible points of `xs` to the population; returns the
        better of `incumbent` and the best of them as (obj, x)."""
        for xr in xs:
            if is_feasible(self.pint, xr):
                obj = self._objective(xr)
                self.pop.add(xr)
                if obj < incumbent[0]:
                    incumbent = (obj, xr)
        return incumbent

    def _root(self):
        """The root relaxation: (raw, bound, simplex_stalled)."""
        pint, timer = self.pint, self.timer
        if fits_simplex(pint) and is_available():
            s0 = PDLPSolverSettings()
            # hard-capped budget: a degenerate root LP can stall the dual
            # simplex for the whole limit; if it does not finish inside
            # this slice the nodes will not either, and the tree runs on
            # batched PDLP relaxations instead
            rem = timer.remaining()
            s0.time_limit = min(
                max(0.1 * rem, 2.0) if math.isfinite(rem) else 15.0, 15.0)
            root = solve_lp_simplex(pint, s0, timer)
            self.log.debug(f"[{timer.elapsed():.1f}s] root simplex: "
                           f"status={root['status']} "
                           f"iters={root.get('iterations')}")
            if root["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
                return root, float(root["dual_objective"]), False
            if root["status"] == C.CUOPT_TERIMINATION_STATUS_INFEASIBLE:
                return root, -math.inf, False
        simplex_stalled = fits_simplex(pint) and is_available()
        s = PDLPSolverSettings()
        s.method = C.CUOPT_METHOD_PDLP
        s.set_optimality_tolerance(1e-6)
        s.detect_infeasibility = True
        s.iteration_limit = 100_000
        if math.isfinite(timer.remaining()):
            s.time_limit = max(0.25 * timer.remaining(), 1.0)
        s.dtype = self.settings.dtype
        root = PdlpSolver(pint, s, self.device).run()
        # rigorous root bound: a PDLP dual is only approximately feasible
        bound = -math.inf
        if root["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
            bound = safe_dual_bound(pint, root.get("dual_solution"),
                                    pint.variable_lower_bounds,
                                    pint.variable_upper_bounds)
        return root, bound, simplex_stalled

    def run(self):
        pint, pop, timer, log = self.pint, self.pop, self.timer, self.log
        settings, is_int, m = self.settings, self.is_int, pint.n_variables
        for x0 in settings.initial_solutions:
            x0 = np.asarray(x0, float)
            if len(x0) == m:
                pop.add(np.where(is_int, np.round(x0), x0))
        # pre-root seeds: bound midpoints + random roundings
        lv0 = np.where(np.isfinite(self.pres.lv), self.pres.lv, 0.0)
        uv0 = np.where(np.isfinite(self.pres.uv), self.pres.uv,
                       np.maximum(lv0, 0.0) + 1.0)
        mid = np.clip((lv0 + uv0) / 2, self.pres.lv, self.pres.uv)
        starts = make_roundings(pint, mid, n_random=5)
        inc = self._add_feasible(starts, (math.inf, None))
        if pop.best is not None and pop.best[0] < inc[0]:
            inc = pop.best
        want_fj = m > 20 or inc[1] is None

        # ---- root LP relaxation ----
        root, root_bound, simplex_stalled = self._root()
        if root["status"] == C.CUOPT_TERIMINATION_STATUS_INFEASIBLE:
            return _make_raw(self.prob, self.sign, None, math.nan,
                             -math.inf, C.CUOPT_TERIMINATION_STATUS_INFEASIBLE,
                             timer=timer)
        x_relax = root["primal_solution"]
        self.inject["x_relax"] = x_relax
        log.debug(f"[{timer.elapsed():.1f}s] root relaxation done, "
                  f"bound={root_bound:.6g}")

        # ---- relaxation-guided roundings (reference
        # local_search/rounding/{constraint_prop,bounds_repair}.cu) ----
        relax_starts = make_roundings(pint, x_relax, n_random=5)
        cp = constraint_prop_rounding(pint, x_relax)
        if cp is not None:
            relax_starts.append(cp)
        for xr in list(relax_starts[:3]):
            relax_starts.append(bounds_repair_rounding(pint, xr))
        inc = self._add_feasible(relax_starts, inc)
        self.inject["seeds"] = relax_starts[:3]

        # ---- heuristic thread: FJ climbers on their own stream, stepping
        # while the main thread LP-completes the roundings ----
        heur_th = None
        if want_fj and not timer.expired():
            heur_th = threading.Thread(
                target=self._heuristic_thread, args=(relax_starts + starts,),
                daemon=True, name=HEURISTIC_THREAD)
            heur_th.start()
        else:
            self.heur_done.set()
        self.heur_thread = heur_th
        try:
            if heur_th is not None:
                rem = timer.remaining()
                head = min(0.15 * rem, 6.0) if math.isfinite(rem) else 6.0
                self.heur_done.wait(timeout=max(head, 1.0))
            # mixed-integer instances: LP-complete the leading roundings
            # (reference relaxed_lp.cuh:50 run_lp_with_vars_fixed)
            if self.mixed:
                for xr in relax_starts[:3]:
                    if timer.expired():
                        break
                    xc, objc = lp_completion(pint, xr, timer,
                                             device=self.device)
                    if xc is not None:
                        pop.add(xc)
                        if objc < inc[0]:
                            inc = (objc, xc)
                        log.debug(f"[{timer.elapsed():.1f}s] lp completion "
                                  f"{objc:.6g}")
            if pop.best is not None and pop.best[0] < inc[0]:
                inc = pop.best
            if settings.heuristics_only:
                raw = self._heuristics_only(inc, root_bound, x_relax)
            else:
                raw = self._tree(inc, root, root_bound, simplex_stalled,
                                 x_relax)
        finally:
            self.heur_stop.set()  # discard late heuristic pushes
            # join the worker before returning: none outlives the solve
            if heur_th is not None:
                heur_th.join()
        eng = self.fj_engine
        if eng is not None:
            raw["fj"] = {"device": str(eng.device), "chunks": eng.chunks,
                         "climbers": eng.batch_size, "block": eng.block,
                         **eng.stats}
        return raw

    def _wait_for_heuristics(self, budget=math.inf):
        """Leave the card and the host to the heuristic thread for
        `budget` seconds, or until an incumbent appears, the thread ends
        or the limit. A tree that stopped without an incumbent and without
        proving infeasibility (its unsolved nodes exhausted their LP
        effort) leaves it the rest of the time."""
        th = self.heur_thread
        end = time.monotonic() + budget
        while self.pop.best is None and th is not None and th.is_alive() \
                and not self.timer.expired() and time.monotonic() < end:
            th.join(timeout=0.05)

    def _heuristics_only(self, inc, root_bound, x_relax):
        """Evolutionary loop only (reference heuristics_only,
        mip/solver_settings.hpp); the FJ climbers keep stepping in the
        background while the main thread recombines."""
        timer = self.timer
        rem = timer.remaining()
        self.heur_done.wait(timeout=max(rem, 0.0) if math.isfinite(rem)
                            else 600.0)
        rem = timer.remaining()
        if math.isfinite(rem) and rem > 0.2:
            self._diversity(rem * 0.9, None, 0, x_relax)
        elif not math.isfinite(rem):
            self._diversity(30.0, None, 0, x_relax)
        self.heur_stop.set()
        if self.pop.best is not None:
            inc = self.pop.best
        if inc[1] is not None:
            return _make_raw(
                self.prob, self.sign, inc[1], inc[0], root_bound,
                C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND, timer=timer)
        return _make_raw(
            self.prob, self.sign, None, math.nan, root_bound,
            C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT, timer=timer)

    def _tree(self, inc, root, root_bound, simplex_stalled, x_relax):
        pint, pop, timer, log = self.pint, self.pop, self.timer, self.log
        # ---- root GMI cuts (mip/cuts.py): lift the tree's LP bound ----
        prob_tree = pint
        n_cuts = 0
        cut_stats = {"rounds": 0, "solved": 0}
        if not simplex_stalled and math.isfinite(root_bound) and \
                not timer.expired():
            rem = timer.remaining()
            cut_timer = Timer(min(0.2 * rem, 20.0)
                              if math.isfinite(rem) else 20.0)
            prob_cut, cut_bound, n_cuts, x_cut = strengthen_root(
                pint, self.settings, cut_timer, log, stats=cut_stats)
            if prob_cut is None or cut_bound <= root_bound:
                n_cuts = 0
            else:
                prob_tree = prob_cut
                root_bound = cut_bound
                log.debug(f"[{timer.elapsed():.1f}s] root cuts: {n_cuts} "
                          f"gmi rows, bound -> {root_bound:.6g}")
                if x_cut is not None:
                    # the cut-LP optimum is far closer to integrality than
                    # the plain root: a better RINS/rounding guide
                    x_relax = x_cut
                    self.inject["x_relax"] = x_cut
                    self.inject["seeds"] = make_roundings(
                        pint, x_cut, n_random=2)[:3]

        # ---- branch & bound interleaved with the population loop ----
        # (reference mip/solver.cu:125-190 runs B&B alongside the GPU
        # heuristics; here they time-slice the main thread cooperatively)
        bnb = BranchAndBound(prob_tree, self.settings,
                             probe_cache=self.probe_cache,
                             device=self.device)
        if simplex_stalled:
            # the root stalled inside its simplex budget (degenerate LP);
            # nodes would stall the same way: batched PDLP relaxations
            bnb.use_simplex = False
        bnb.solution_callbacks.append(
            lambda x, o: pop.add(x, from_external=True))
        if pop.best is not None and pop.best[0] < inc[0]:
            inc = pop.best
        if inc[1] is not None:
            bnb.set_incumbent(inc[1], inc[0])
        if math.isfinite(root_bound):
            bnb.best_bound = root_bound
        self.inject["bnb"] = bnb  # late heuristic results flow straight in
        rem = timer.remaining()
        if math.isfinite(rem) and rem > 3.0 and pint.n_variables > 20:
            slice_no = 1
            heur_share = 0.35  # fraction of each round spent evolving
            bound_hist = []
            while not timer.expired():
                bnb_slice = min(4.0, max(0.5, timer.remaining() * 0.5))
                bnb_slice *= (1.0 - heur_share) / 0.65
                done = bnb.step(timer,
                                deadline=time.monotonic() + bnb_slice)
                bound_hist.append(bnb.best_bound)
                # when the tree stops raising the bound, shift the clock
                # toward the heuristics
                if len(bound_hist) >= 6 and math.isfinite(bound_hist[-1]):
                    scale = max(1.0, abs(inc[0]) if math.isfinite(inc[0])
                                else abs(bound_hist[-1]))
                    stalled = bound_hist[-1] - bound_hist[-6] < 1e-4 * scale
                    heur_share = 0.6 if stalled else 0.35
                if pop.best is not None:
                    bnb.set_incumbent(pop.best[1], pop.best[0])
                if done:
                    break
                heur_slice = min(
                    bnb_slice * heur_share / max(1 - heur_share, 1e-9),
                    max(timer.remaining(), 0.0))
                # host-only moves run from the first slice; the FJ-based
                # recombiners join once the engine's first chunk is done;
                # with nothing to recombine the FJ thread has the slice
                if heur_slice > 0.05 and pop.best is not None:
                    self._diversity(heur_slice, bnb, slice_no, x_relax,
                                    use_fj=self.heur_done.is_set())
                elif heur_slice > 0.05:
                    self._wait_for_heuristics(heur_slice)
                slice_no += 1
                if pop.best is not None:
                    bnb.set_incumbent(pop.best[1], pop.best[0])
            res = bnb.result()
        else:
            res = bnb.solve(timer)
        if res["status"] == C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT:
            self._wait_for_heuristics()
        status = res["status"]
        x, obj, bound = res["incumbent"], res["incumbent_obj"], \
            res["best_bound"]
        if pop.best is not None and (x is None or pop.best[0] < obj - 1e-12):
            obj, x = pop.best
            if status != C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
                status = C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND
        if x is None and inc[1] is not None:
            obj, x = inc
            status = C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND
        raw = _make_raw(
            self.prob, self.sign, x, obj, bound, status,
            nodes=res["nodes"], iters=res["simplex_iters"], timer=timer)
        # which engine took each LP of the tree
        raw["mip_stats"] = {
            "root_lp": root.get("solved_by", "pdlp"),
            "cut_rounds": cut_stats["rounds"],
            "cut_rounds_solved": cut_stats["solved"], "root_cuts": n_cuts,
            "node_lp": "dual_simplex" if bnb.use_simplex else "pdlp"}
        return raw
