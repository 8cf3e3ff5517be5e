"""Rounding heuristics: nearest / randomized roundings of the LP
relaxation plus a simple feasibility-pump loop.

Counterpart of cuopt_tpu/mip/rounding.py, which mirrors reference
local_search/rounding/{simple_rounding,constraint_prop} (SURVEY.md section
2.3). Host numpy; candidate generation feeds the batched FJ climbers
(mip/feasibility_jump.py). `lp_completion` solves its LP with the host
dual simplex, or by PDLP on `device`.
"""

from __future__ import annotations

import math

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex import is_available
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings


def violation(prob, x, tol=1e-6):
    act = np.zeros(prob.n_constraints)
    rows = np.repeat(
        np.arange(prob.n_constraints, dtype=np.int64), np.diff(prob.offsets)
    )
    np.add.at(act, rows, prob.values * x[prob.indices])
    lo = np.where(
        np.isfinite(prob.constraint_lower_bounds),
        np.maximum(prob.constraint_lower_bounds - act, 0.0), 0.0,
    )
    hi = np.where(
        np.isfinite(prob.constraint_upper_bounds),
        np.maximum(act - prob.constraint_upper_bounds, 0.0), 0.0,
    )
    return float(np.sum(lo + hi))


def is_feasible(prob, x, tol=1e-6):
    if np.any(x < prob.variable_lower_bounds - tol):
        return False
    if np.any(x > prob.variable_upper_bounds + tol):
        return False
    is_int = prob.variable_types == "I"
    if np.any(np.abs(x[is_int] - np.round(x[is_int])) > 1e-5):
        return False
    return violation(prob, x) <= tol * max(1, prob.n_constraints) ** 0.5


def make_roundings(prob, x_relax, n_random=6, seed=0):
    """Candidate integer points from the relaxation solution."""
    rng = np.random.default_rng(seed)
    is_int = prob.variable_types == "I"
    lv, uv = prob.variable_lower_bounds, prob.variable_upper_bounds
    outs = []

    def clampround(x):
        x = np.clip(x, lv, uv)
        x = np.where(is_int, np.round(x), x)
        return np.clip(x, lv, uv)

    outs.append(clampround(x_relax))
    outs.append(clampround(np.where(is_int, np.floor(x_relax), x_relax)))
    outs.append(clampround(np.where(is_int, np.ceil(x_relax), x_relax)))
    frac = x_relax - np.floor(x_relax)
    for _ in range(n_random):
        thresh = rng.uniform(0.2, 0.8, len(x_relax))
        xr = np.where(
            is_int, np.floor(x_relax) + (frac > thresh), x_relax
        )
        outs.append(clampround(xr))
    return outs


def constraint_prop_rounding(prob, x_relax, int_tol=1e-6):
    """Constraint-propagation rounding (reference
    local_search/rounding/constraint_prop.cu): round integers ONE AT A
    TIME, most-fractional last, propagating bounds after each fix so
    later roundings respect the implications of earlier ones. Returns a
    candidate x (may still be infeasible) or None when propagation
    proves the partial rounding dead."""
    from cuopt_torch.mip.presolve import propagate_bounds

    x = np.asarray(x_relax, float).copy()
    is_int = prob.variable_types == "I"
    lv = prob.variable_lower_bounds.astype(float).copy()
    uv = prob.variable_upper_bounds.astype(float).copy()
    frac = np.where(is_int, np.abs(x - np.round(x)), -1.0)
    order = np.argsort(frac)  # confident (near-integral) first
    for j in order:
        if not is_int[j]:
            continue
        v = float(np.clip(np.round(x[j]), lv[j], uv[j]))
        lv[j] = uv[j] = v
        x[j] = v
        if frac[j] > 0.25:  # only propagate where rounding is uncertain
            pres = propagate_bounds(
                prob.offsets, prob.indices, prob.values,
                prob.constraint_lower_bounds,
                prob.constraint_upper_bounds,
                lv, uv, is_int, max_rounds=1,
            )
            if pres.infeasible:
                return None
            lv, uv = pres.lv, pres.uv
            x = np.clip(x, lv, uv)
    return np.clip(np.where(is_int, np.round(x), x), lv, uv)


def bounds_repair_rounding(prob, x, max_rounds=50):
    """Bounds-repair rounding (reference
    local_search/rounding/bounds_repair.cu): walk the violated
    constraints and shift the variable with the largest leverage
    (|a_ij| * available slack toward its bound) by integer steps until
    the row is satisfied or no variable can move. Continuous variables
    move fractionally. Returns the repaired x (feasible or best-effort).
    """
    x = np.asarray(x, float).copy()
    is_int = prob.variable_types == "I"
    lv, uv = prob.variable_lower_bounds, prob.variable_upper_bounds
    rows = np.repeat(
        np.arange(prob.n_constraints, dtype=np.int64),
        np.diff(prob.offsets),
    )
    for _ in range(max_rounds):
        act = np.zeros(prob.n_constraints)
        np.add.at(act, rows, prob.values * x[prob.indices])
        lo_v = np.where(np.isfinite(prob.constraint_lower_bounds),
                        prob.constraint_lower_bounds - act, 0.0)
        hi_v = np.where(np.isfinite(prob.constraint_upper_bounds),
                        act - prob.constraint_upper_bounds, 0.0)
        viol = np.maximum(np.maximum(lo_v, hi_v), 0.0)
        i = int(np.argmax(viol))
        if viol[i] <= 1e-6:
            return x
        need = lo_v[i] if lo_v[i] > hi_v[i] else -hi_v[i]  # signed need
        a, b = prob.offsets[i], prob.offsets[i + 1]
        cols = prob.indices[a:b]
        coefs = prob.values[a:b]
        # room of each variable in the helpful direction
        room = np.where(coefs * need > 0,
                        np.where(coefs > 0, uv[cols] - x[cols],
                                 x[cols] - lv[cols]),
                        np.where(coefs > 0, x[cols] - lv[cols],
                                 uv[cols] - x[cols]))
        lever = np.abs(coefs) * np.maximum(room, 0.0)
        k = int(np.argmax(lever))
        if lever[k] <= 1e-12:
            return x  # stuck: no variable can reduce this violation
        j = int(cols[k])
        step = need / coefs[k]
        if is_int[j]:
            step = np.ceil(abs(step)) * np.sign(step)
        new = float(np.clip(x[j] + step, lv[j], uv[j]))
        if abs(new - x[j]) < 1e-12:
            return x
        x[j] = new
    return x


def lp_completion(prob, x, timer=None, time_cap=5.0, device="cuda"):
    """Fix the integer variables at round(x) and solve the remaining LP
    over the continuous variables EXACTLY (native dual simplex when it
    fits, PDLP on `device` otherwise): the optimal continuous completion
    of an integer pattern, the work-horse primal move on mixed-integer
    instances where FJ's single-variable jumps cannot set the continuous
    side well (reference cpp/src/mip/relaxed_lp/relaxed_lp.cuh:50
    `run_lp_with_vars_fixed`).

    Returns (x_complete, objective) or (None, inf) when the pattern is
    infeasible or its LP ends unsolved. `prob` must be in the internal
    minimize orientation. Only a simplex that cannot be built sends a
    fitting LP to PDLP; any other error propagates."""
    is_int = prob.variable_types == "I"
    if not is_int.any() or is_int.all():
        return None, math.inf
    xi = np.round(np.asarray(x, float))
    lv = np.where(is_int, np.clip(xi, prob.variable_lower_bounds,
                                  prob.variable_upper_bounds),
                  prob.variable_lower_bounds)
    uv = np.where(is_int, lv, prob.variable_upper_bounds)
    # rows that no completion can meet: is_feasible would refuse every
    # completion, so the LP (at 50k, seconds of PDLP) is not solved
    if _unreachable(prob, lv, uv) > 1e-6 * max(1, prob.n_constraints) ** 0.5:
        return None, math.inf
    sub = type(prob)(
        offsets=prob.offsets, indices=prob.indices, values=prob.values,
        objective_coefficients=prob.objective_coefficients,
        objective_offset=prob.objective_offset, maximize=False,
        constraint_lower_bounds=prob.constraint_lower_bounds,
        constraint_upper_bounds=prob.constraint_upper_bounds,
        row_types=prob.row_types, rhs=prob.rhs,
        variable_lower_bounds=lv, variable_upper_bounds=uv,
        variable_types=prob.variable_types,
    )
    s = PDLPSolverSettings()
    s.set_optimality_tolerance(1e-6)
    s.detect_infeasibility = True
    s.time_limit = min(
        time_cap, timer.remaining() if timer is not None else time_cap
    )
    if fits_simplex(prob) and is_available():
        raw = solve_lp_simplex(sub, s, timer)
    else:
        s.method = C.CUOPT_METHOD_PDLP
        raw = PdlpSolver(sub, s, device).run()
    if raw["status"] != C.CUOPT_TERIMINATION_STATUS_OPTIMAL:
        return None, math.inf
    xc = np.asarray(raw["primal_solution"], float)
    xc = np.where(is_int, xi, xc)
    if not is_feasible(prob, xc):
        return None, math.inf
    obj = float(prob.objective_coefficients @ xc
                + prob.objective_offset)
    return xc, obj


def _unreachable(prob, lv, uv):
    """The total by which the rows' activity ranges over the box [lv, uv]
    miss the rows' bounds: a lower bound on the violation of any x in
    the box."""
    rows = np.repeat(np.arange(prob.n_constraints, dtype=np.int64),
                     np.diff(prob.offsets))
    a, j = prob.values, prob.indices
    lo_a = np.bincount(rows, weights=np.minimum(a * lv[j], a * uv[j]),
                       minlength=prob.n_constraints)
    hi_a = np.bincount(rows, weights=np.maximum(a * lv[j], a * uv[j]),
                       minlength=prob.n_constraints)
    with np.errstate(invalid="ignore"):
        miss = np.maximum(lo_a - prob.constraint_upper_bounds, 0.0) + \
            np.maximum(prob.constraint_lower_bounds - hi_a, 0.0)
    return float(np.nansum(miss))


def fits_simplex(prob) -> bool:
    """The size gate under which the MIP solver takes the host dual
    simplex for an LP (cuopt_tpu mip/solve.py:442-445, rounding.py:196,
    branch_and_bound.py:108)."""
    return (prob.n_constraints <= 20_000 and prob.n_variables <= 40_000
            and prob.nnz <= 2_000_000)
