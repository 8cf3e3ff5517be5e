"""LP solve orchestration.

Counterpart of cuopt_tpu/lp/solve.py, which mirrors reference
cpp/src/linear_programming/solve.cu: `solve_lp` :554, method dispatch
`solve_lp_with_method` :539 {Concurrent, PDLP, DualSimplex}:

  - DualSimplex solves on the host with the native dual simplex;
  - Concurrent races that simplex against PDLP on `device`
    (dual_simplex/concurrent.py, reference solve.cu:467-537);
  - PDLP runs alone on `device`, then crosses over to a vertex when
    `settings.crossover` is set and PDLP ended OPTIMAL (reference
    solve.cu:383-441).
"""

from __future__ import annotations

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex import run_concurrent_lp, solve_with_dual_simplex
from cuopt_torch.dual_simplex.crossover import crossover
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solution import Solution
from cuopt_torch.utils.logger import get_logger, solve_log_context
from cuopt_torch.utils.timer import Timer


def _trivial_empty_solution(prob, status=None):
    m = prob.n_variables
    n = prob.n_constraints
    x = np.clip(np.zeros(m), prob.variable_lower_bounds,
                prob.variable_upper_bounds)
    obj = float(prob.objective_coefficients @ x + prob.objective_offset)
    return {
        "status": status or C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
        "iterations": 0,
        "attempts": 0,
        "solve_time": 0.0,
        "primal_solution": x,
        "dual_solution": np.zeros(n),
        "reduced_cost": np.asarray(prob.objective_coefficients, float),
        "primal_objective": obj,
        "dual_objective": obj,
        "gap": 0.0,
        "l2_primal_residual": 0.0,
        "l2_dual_residual": 0.0,
        "linf_primal_residual": 0.0,
        "linf_dual_residual": 0.0,
    }


def solve_lp(prob, settings: PDLPSolverSettings | None = None,
             device="cuda") -> Solution:
    """Solve an LP by `settings.method`. PDLP runs on `device` ("cuda"
    unless the caller asks for "cpu"; without a card a PDLP or concurrent
    solve on "cuda" raises); the dual simplex runs on the host."""
    settings = settings or PDLPSolverSettings()
    log = get_logger()
    with solve_log_context(settings.log_file or None,
                           settings.log_to_console):
        prob.validate()
        timer = Timer(settings.time_limit)
        if prob.n_variables == 0 or prob.n_constraints == 0:
            # Trivial/empty problems: solved in closed form (bounds only).
            sol = Solution(prob, _solve_no_constraints(prob))
        else:
            method = settings.method
            if method == C.CUOPT_METHOD_DUAL_SIMPLEX:
                raw = solve_with_dual_simplex(prob, settings, timer)
            elif method == C.CUOPT_METHOD_CONCURRENT:
                raw = run_concurrent_lp(prob, settings, timer, device)
            else:
                raw = PdlpSolver(prob, settings, device).run(timer)
                if settings.crossover and \
                        raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
                    raw = crossover(prob, raw, settings, timer)
            sol = Solution(prob, raw)
        if settings.solution_file:
            sol.write_to_sol_file(settings.solution_file)
        info = sol.get_additional_termination_information()
        log.info(
            f"LP solve done: status={sol.get_termination_reason()} "
            f"obj={info.get('primal_objective', float('nan')):.10g} "
            f"iters={info.get('iterations', 0)} "
            f"time={info.get('solve_time', 0.0):.3f}s"
        )
        return sol


def _solve_no_constraints(prob):
    """Closed-form solve when there are no constraints (or no variables):
    each variable sits at the bound favored by its cost."""
    c = prob.objective_coefficients * (-1.0 if prob.maximize else 1.0)
    lv = prob.variable_lower_bounds
    uv = prob.variable_upper_bounds
    x = np.where(c > 0, lv, np.where(c < 0, uv, np.clip(0.0, lv, uv)))
    if np.any(np.isinf(x) & (c != 0)):
        status = C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
        x = np.where(np.isinf(x), 0.0, x)
    else:
        status = C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    x = np.where(np.isinf(x), np.clip(0.0, lv, uv), x)
    obj = float(prob.objective_coefficients @ x + prob.objective_offset)
    # constraints with no variables: activity is 0, feasible iff
    # lc <= 0 <= uc for every row
    if prob.n_constraints > 0:
        lc = prob.constraint_lower_bounds
        uc = prob.constraint_upper_bounds
        if np.any(lc > 0) or np.any(uc < 0):
            status = C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
    raw = _trivial_empty_solution(prob, status)
    raw["primal_solution"] = np.asarray(x, float)
    raw["primal_objective"] = obj
    raw["dual_objective"] = obj
    return raw
