"""Feasibility pump.

Counterpart of cuopt_tpu/mip/feasibility_pump.py, with role parity with
the reference FP (cpp/src/mip/local_search/feasibility_pump/): alternate
between

  1. rounding the LP point to the nearest integer point x~, and
  2. projecting back: solve the distance LP  min sum_j d_j  s.t. original
     constraints and  -d_j <= x_j - x~_j <= d_j  for integer j,

perturbing the rounding on cycles. The projection LP reuses one augmented
problem whose matrix is static across iterations; only the distance-row
bounds move. Each iteration moves them in place; the device problem
cached on the problem object is keyed on a digest of the bounds
(lp/pdlp.py build_device_problem), so projection LP k, solved on
`device`, carries iteration k's targets. (cuopt_tpu's cache key leaves
the bounds out, so from the second iteration on it solves the first
iteration's LP again.)
"""

from __future__ import annotations

import math
import time

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.lp.pdlp import PdlpSolver
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.mip.rounding import is_feasible


def _build_distance_problem(prob, int_idx):
    """Augment [x] -> [x, d] with rows x_j - d_j <= x~_j <= x_j + d_j.

    Returns a new OptimizationProblem template; per-iteration only the
    constraint bounds of the distance rows change (set via
    update_distance_bounds)."""
    m = prob.n_variables
    n = prob.n_constraints
    k = len(int_idx)
    # distance rows: for each integer j: (x_j - d_j) in [-inf, x~_j]
    #                and (x_j + d_j) in [x~_j, +inf]
    rows = []
    cols = []
    vals = []
    for r, j in enumerate(int_idx):
        rows += [n + 2 * r, n + 2 * r, n + 2 * r + 1, n + 2 * r + 1]
        cols += [int(j), m + r, int(j), m + r]
        vals += [1.0, -1.0, 1.0, 1.0]
    all_rows = np.concatenate([
        np.repeat(np.arange(n), np.diff(prob.offsets)),
        np.asarray(rows, np.int64),
    ])
    all_cols = np.concatenate([prob.indices, np.asarray(cols, np.int64)])
    all_vals = np.concatenate([prob.values, np.asarray(vals, float)])
    order = np.argsort(all_rows, kind="stable")
    offsets = np.zeros(n + 2 * k + 1, np.int64)
    np.add.at(offsets, all_rows[order] + 1, 1)
    np.cumsum(offsets, out=offsets)

    q = type(prob)(
        offsets=offsets,
        indices=all_cols[order],
        values=all_vals[order],
        objective_coefficients=np.concatenate(
            [np.zeros(m), np.ones(k)]
        ),
        objective_offset=0.0,
        maximize=False,
        constraint_lower_bounds=np.concatenate([
            prob.constraint_lower_bounds,
            np.zeros(2 * k),  # placeholder, set per iteration
        ]),
        constraint_upper_bounds=np.concatenate([
            prob.constraint_upper_bounds, np.zeros(2 * k),
        ]),
        row_types=np.concatenate([
            prob.row_types, np.full(2 * k, "R", "U1"),
        ]) if len(prob.row_types) == n else np.full(n + 2 * k, "R", "U1"),
        rhs=np.zeros(n + 2 * k),
        variable_lower_bounds=np.concatenate([
            prob.variable_lower_bounds, np.zeros(k),
        ]),
        variable_upper_bounds=np.concatenate([
            prob.variable_upper_bounds, np.full(k, np.inf),
        ]),
        variable_types=np.concatenate([
            np.full(m, "C", "U1"), np.full(k, "C", "U1"),
        ]),
    )
    return q


def _set_distance_bounds(q, n, int_idx, x_round):
    k = len(int_idx)
    lo = q.constraint_lower_bounds
    hi = q.constraint_upper_bounds
    tgt = x_round[int_idx]
    lo[n:n + 2 * k:2] = -np.inf
    hi[n:n + 2 * k:2] = tgt
    lo[n + 1:n + 2 * k + 1:2] = tgt
    hi[n + 1:n + 2 * k + 1:2] = np.inf


def feasibility_pump(prob, x_relax, time_budget_s, int_tol=1e-5,
                     max_iters=25, seed=0, dtype="float64", device="cuda"):
    """Run FP from the LP-relaxation point, its projection LPs by PDLP on
    `device`. prob must be in minimize orientation. Returns (x, obj,
    found)."""
    rng = np.random.default_rng(seed)
    is_int = prob.variable_types == "I"
    int_idx = np.where(is_int)[0]
    if len(int_idx) == 0:
        return None, math.inf, False
    n = prob.n_constraints
    m = prob.n_variables
    q = _build_distance_problem(prob, int_idx)

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.set_optimality_tolerance(1e-4)
    s.iteration_limit = 20_000
    s.dtype = dtype
    s.log_to_console = False

    x_lp = np.asarray(x_relax, float).copy()
    t_end = time.monotonic() + time_budget_s
    seen = set()
    for _ in range(max_iters):
        if time.monotonic() >= t_end:
            break
        x_round = x_lp.copy()
        x_round[int_idx] = np.round(x_lp[int_idx])
        x_round = np.clip(
            x_round, prob.variable_lower_bounds,
            prob.variable_upper_bounds,
        )
        if is_feasible(prob, x_round, tol=1e-6):
            obj = float(prob.objective_coefficients @ x_round
                        + prob.objective_offset)
            return x_round, obj, True
        key = tuple(np.round(x_round[int_idx]).astype(np.int64).tolist())
        if key in seen:
            # cycle: perturb the most fractional entries
            frac = np.abs(x_lp[int_idx] - np.round(x_lp[int_idx]))
            kflip = max(1, len(int_idx) // 10)
            flip = np.argsort(-frac)[:kflip]
            delta = np.where(x_lp[int_idx[flip]]
                             > x_round[int_idx[flip]], 1.0, -1.0)
            x_round[int_idx[flip]] = np.clip(
                x_round[int_idx[flip]] + delta,
                prob.variable_lower_bounds[int_idx[flip]],
                prob.variable_upper_bounds[int_idx[flip]],
            )
            key = tuple(np.round(
                x_round[int_idx]).astype(np.int64).tolist())
            if key in seen:
                jflip = rng.choice(len(int_idx),
                                   size=min(3, len(int_idx)),
                                   replace=False)
                lo = prob.variable_lower_bounds[int_idx[jflip]]
                hi = np.minimum(
                    prob.variable_upper_bounds[int_idx[jflip]], lo + 10
                )
                x_round[int_idx[jflip]] = rng.integers(
                    lo.astype(np.int64), hi.astype(np.int64) + 1
                )
        seen.add(key)
        # projection LP
        _set_distance_bounds(q, n, int_idx, x_round)
        s.time_limit = max(min(5.0, t_end - time.monotonic()), 0.5)
        raw = PdlpSolver(q, s, device).run()
        if raw["status"] not in (
            C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
            C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT,
            C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT,
        ):
            break
        x_lp = raw["primal_solution"][:m]
        dist = float(np.abs(x_lp[int_idx]
                            - np.round(x_lp[int_idx])).sum())
        if dist <= int_tol * max(1, len(int_idx)):
            x_fin = x_lp.copy()
            x_fin[int_idx] = np.round(x_lp[int_idx])
            if is_feasible(prob, x_fin, tol=1e-6):
                obj = float(prob.objective_coefficients @ x_fin
                            + prob.objective_offset)
                return x_fin, obj, True
    return None, math.inf, False


def line_segment_search(prob, x_from, x_to, n_samples=16):
    """Round points along the segment [x_from, x_to] and keep the best
    feasible one (reference line_segment_search/ in
    cpp/src/mip/local_search/). Vectorized over samples."""
    is_int = prob.variable_types == "I"
    ts = np.linspace(0.0, 1.0, n_samples + 1)
    best, best_obj = None, math.inf
    for t in ts:
        x = (1 - t) * np.asarray(x_from, float) + t * np.asarray(
            x_to, float
        )
        x = np.clip(x, prob.variable_lower_bounds,
                    prob.variable_upper_bounds)
        x[is_int] = np.round(x[is_int])
        if is_feasible(prob, x, tol=1e-6):
            obj = float(prob.objective_coefficients @ x
                        + prob.objective_offset)
            if obj < best_obj:
                best, best_obj = x, obj
    return best, best_obj, best is not None
