"""Gomory mixed-integer (GMI) cutting planes from the dual-simplex root
basis.

The port's own copy of cuopt_tpu/mip/cuts.py (numpy), on the port's
simplex bindings (dual_simplex/bindings.py).

Reference role: cuOpt's B&B tightens bounds purely by branching (it has
no cut separators — dual_simplex/branch_and_bound.cpp); on
fixed-charge/covering structures that leaves the root relaxation gap
almost untouched (50v-10: bound +92 over 15k nodes, r05). The classic
fix is a few rounds of GMI cuts at the root: rows of the simplex
tableau for fractional basic integers yield valid inequalities that
lift the LP bound for EVERY node of the tree.

Derivation used here (matches the native simplex formulation,
cpp/dual_simplex/simplex.cpp: columns z = (x, s), M = [A, -I],
M z = 0, l <= z <= u, logical column j>=n is -e_{j-n}):

  basic integer z_k in basis row r:  z_k = -sum_{j in N} alpha_j z_j,
  alpha_j = (B^-1 M_j)_r.
  Shift nonbasics to their bound:  z_j = l_j + t_j  or  u_j - t_j,
  t_j >= 0, giving  z_k = beta + sum_j abar_j t_j  with beta = the
  current value of z_k.  With a_j = -abar_j and f0 = frac(beta),
  fj = frac(a_j), the GMI cut is

    sum_{t_j integer} [ fj <= f0 ? fj : f0 (1-fj)/(1-f0) ] t_j
    + sum_{t_j continuous} [ a_j >= 0 ? a_j : f0 (-a_j)/(1-f0) ] t_j
    >= f0 .

  t_j counts as integer only when z_j is an integer column at an
  integral bound (z_j = 0.5 + t_j is not an integer for integer t_j).
  All t-space coefficients are nonnegative, so dropping a small one
  TIGHTENS the cut by up to coef_j (u_j - l_j): a cut is kept only if
  that sum, and the same sum for the x-space terms dropped after
  substituting t back and folding the slack part through s = A x into
  a pure x-space row  w x >= rhs, stays below _MAX_DROPPED.

Cuts are appended as one-sided constraints (rhs <= row <= +inf) and the
augmented problem drives the B&B's node relaxations; heuristics keep
the cheaper original rows.
"""

from __future__ import annotations

import math

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.dual_simplex import is_available
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
from cuopt_torch.lp.settings import PDLPSolverSettings

_EPS_F0 = 1e-4       # reject almost-integral tableau rows
_EPS_COEF = 1e-11    # drop tiny ones, if bounded (see gmi_cuts)
_MAX_DYNAMIC = 1e7   # reject numerically wild cuts
_MAX_DROPPED = 1e-9  # most a cut may be tightened by its dropped terms


def _csr_to_dense(prob):
    A = np.zeros((prob.n_constraints, prob.n_variables))
    off = prob.offsets
    for i in range(prob.n_constraints):
        A[i, prob.indices[off[i]:off[i + 1]]] = \
            prob.values[off[i]:off[i + 1]]
    return A


def gmi_cuts(prob, x, s, vstat, is_int, max_cuts=32, int_tol=1e-6):
    """Generate GMI cuts from one optimal basis.

    x: structural solution (n,), s: row activities A x (m,),
    vstat: int8[n+m] basis statuses (0 lower / 1 upper / 2 basic).
    Returns (rows, rhs): rows (k, n) cut coefficients with
    `rows @ x >= rhs` valid for every mixed-integer feasible point.
    """
    n, m = prob.n_variables, prob.n_constraints
    A = _csr_to_dense(prob)
    lz = np.concatenate([prob.variable_lower_bounds,
                         prob.constraint_lower_bounds])
    uz = np.concatenate([prob.variable_upper_bounds,
                         prob.constraint_upper_bounds])
    z = np.concatenate([x, s])
    vstat = np.asarray(vstat, np.int8)
    basic = np.flatnonzero(vstat == 2)
    if len(basic) != m:
        return np.zeros((0, n)), np.zeros(0)
    # fractional basic INTEGER STRUCTURAL variables, most fractional first
    zint = np.zeros(n + m, bool)
    zint[:n] = is_int
    frac = z - np.floor(z)
    cand = [k for k in basic
            if k < n and zint[k]
            and _EPS_F0 < frac[k] < 1.0 - _EPS_F0]
    cand.sort(key=lambda k: -min(frac[k], 1.0 - frac[k]))
    cand = cand[:max_cuts]
    if not cand:
        return np.zeros((0, n)), np.zeros(0)

    # B = M[:, basic];  M = [A, -I]
    B = np.zeros((m, m))
    for p, k in enumerate(basic):
        if k < n:
            B[:, p] = A[:, k]
        else:
            B[k - n, p] = -1.0
    rows_of = {k: p for p, k in enumerate(basic)}
    E = np.zeros((m, len(cand)))
    for q, k in enumerate(cand):
        E[rows_of[k], q] = 1.0
    try:
        W = np.linalg.solve(B.T, E)          # (m, k) rows of B^-1
    except np.linalg.LinAlgError:
        return np.zeros((0, n)), np.zeros(0)
    # alpha rows over all n+m columns: W^T [A, -I]
    alpha_x = W.T @ A                        # (k, n)
    alpha_s = -W.T                           # (k, m)
    alpha = np.concatenate([alpha_x, alpha_s], axis=1)

    nb_low = vstat == 0
    nb_up = vstat == 1
    # t_j = z_j - l_j (or u_j - z_j) is integral only if the active bound
    # is: an integer column at a fractional bound takes g_cont
    active = np.where(nb_low, lz, np.where(nb_up, uz, 0.0))
    # t_j's range; a slack's comes from its row's activity range too
    lo_x, hi_x = prob.variable_lower_bounds, prob.variable_upper_bounds
    with np.errstate(invalid="ignore"):
        int_shift = np.abs(active - np.round(active)) <= int_tol
        a_lo = np.where(A != 0.0, A * lo_x, 0.0)
        a_hi = np.where(A != 0.0, A * hi_x, 0.0)
        act_lo = np.minimum(a_lo, a_hi).sum(axis=1)
        act_hi = np.maximum(a_lo, a_hi).sum(axis=1)
        t_range = np.minimum(uz, np.concatenate([hi_x, act_hi])) - \
            np.maximum(lz, np.concatenate([lo_x, act_lo]))
        x_mag = np.maximum(np.abs(lo_x), np.abs(hi_x))
    out_rows, out_rhs = [], []
    for q, k in enumerate(cand):
        beta = z[k]
        f0 = beta - math.floor(beta)
        if not (_EPS_F0 < f0 < 1.0 - _EPS_F0):
            continue
        a_row = alpha[q]
        # a_j = -abar_j;  abar_j = -a for at-lower, +a for at-upper
        a = np.where(nb_low, a_row, np.where(nb_up, -a_row, 0.0))
        # a nonbasic FREE column with real weight breaks the bound shift
        free_nb = ~nb_low & ~nb_up
        free_nb[basic] = False
        if np.any(free_nb & (np.abs(a_row) > 1e-9)):
            continue
        fj = a - np.floor(a)
        g_int = np.where(fj <= f0 + 1e-12, fj,
                         f0 * (1.0 - fj) / (1.0 - f0))
        g_cont = np.where(a >= 0.0, a, f0 * (-a) / (1.0 - f0))
        coef = np.where(zint & int_shift, g_int, g_cont)
        coef[basic] = 0.0
        coef[k] = 0.0
        # bound shift needs finite bounds wherever the cut has weight,
        # dropped weight included
        nz = coef != 0.0
        if np.any(nz & nb_low & ~np.isfinite(lz)) or \
                np.any(nz & nb_up & ~np.isfinite(uz)):
            continue
        # dropping coef_j t_j (t_j <= u_j - l_j) tightens the cut by up
        # to coef_j (u_j - l_j): keep the cut only if that is negligible
        tiny = nz & (np.abs(coef) < _EPS_COEF)
        if np.sum(np.abs(coef[tiny]) * t_range[tiny]) > _MAX_DROPPED:
            continue
        coef = np.where(tiny, 0.0, coef)
        nz = coef != 0.0
        if not nz.any():
            continue
        mx, mn = np.max(coef[nz]), np.min(coef[nz])
        if mx / max(mn, 1e-300) > _MAX_DYNAMIC or mx > 1e8:
            continue
        # substitute t_j = z_j - l_j (lower) / u_j - z_j (upper):
        #   sum coef t = w_z . z - sum_low coef l + sum_up coef u >= f0
        w_z = np.where(nb_low, coef, -coef)
        bshift = np.where(nb_low[nz], coef[nz] * lz[nz],
                          -coef[nz] * uz[nz])
        rhs = f0 + float(np.sum(bshift))
        # fold slack coefficients through s = A x
        w_x = w_z[:n] + w_z[n:] @ A
        # dropping w_j x_j moves the row by up to |w_j| max(|l_j|, |u_j|)
        tiny_x = (w_x != 0.0) & (np.abs(w_x) < _EPS_COEF)
        if np.sum(np.abs(w_x[tiny_x]) * x_mag[tiny_x]) > _MAX_DROPPED:
            continue
        w_x = np.where(tiny_x, 0.0, w_x)
        if not np.any(w_x):
            continue
        scale = np.max(np.abs(w_x))
        out_rows.append(w_x / scale)
        out_rhs.append(rhs / scale)
    if not out_rows:
        return np.zeros((0, n)), np.zeros(0)
    return np.stack(out_rows), np.asarray(out_rhs)


def append_rows(prob, rows, rhs):
    """Problem copy with `rows @ x >= rhs` constraints appended."""
    n = prob.n_variables
    k = rows.shape[0]
    offs = [prob.offsets[-1]]
    idx_parts = [prob.indices]
    val_parts = [prob.values]
    for r in range(k):
        nzj = np.flatnonzero(rows[r])
        idx_parts.append(nzj.astype(prob.indices.dtype))
        val_parts.append(rows[r, nzj])
        offs.append(offs[-1] + len(nzj))
    return type(prob)(
        offsets=np.concatenate([prob.offsets, np.asarray(
            offs[1:], prob.offsets.dtype)]),
        indices=np.concatenate(idx_parts),
        values=np.concatenate(val_parts),
        objective_coefficients=prob.objective_coefficients,
        objective_offset=prob.objective_offset, maximize=False,
        constraint_lower_bounds=np.concatenate(
            [prob.constraint_lower_bounds, rhs]),
        constraint_upper_bounds=np.concatenate(
            [prob.constraint_upper_bounds, np.full(k, np.inf)]),
        row_types=np.concatenate(
            [prob.row_types, np.full(k, "G", dtype=prob.row_types.dtype)]
        ) if getattr(prob, "row_types", None) is not None else None,
        rhs=np.concatenate([prob.rhs, rhs])
        if getattr(prob, "rhs", None) is not None else None,
        variable_lower_bounds=prob.variable_lower_bounds,
        variable_upper_bounds=prob.variable_upper_bounds,
        variable_types=prob.variable_types,
    )


def strengthen_root(pint, settings, timer, log, rounds=12,
                    max_cuts=64, min_gain=1e-7, stats=None):
    """Iterated root GMI separation: solve -> cut -> resolve.

    Returns (prob_cut, bound, n_cuts, x_cut) — prob_cut is None when no
    cut survived (caller keeps the original problem/bound); x_cut is
    the LAST cut-LP optimum (much closer to integrality than the plain
    root relaxation, so it makes a far better RINS/rounding guide).
    `stats`, when given, is a dict that receives the cut-round LPs
    started ("rounds") and solved to OPTIMAL ("solved").
    """
    stats = {} if stats is None else stats
    stats.update(rounds=0, solved=0)
    n, m = pint.n_variables, pint.n_constraints
    if not is_available() or m * (n + m) > 3e7 or m > 4096:
        return None, -math.inf, 0, None
    is_int = pint.variable_types == "I"
    if not is_int.any():
        return None, -math.inf, 0, None
    cur = pint
    bound = -math.inf
    total = 0
    x_cut = None
    for it in range(rounds):
        if timer.expired():
            break
        s0 = PDLPSolverSettings()
        rem = timer.remaining()
        s0.time_limit = min(10.0, max(1.0, 0.1 * rem)
                            if math.isfinite(rem) else 10.0)
        stats["rounds"] += 1
        raw = solve_lp_simplex(cur, s0, timer, want_vstat=True)
        if raw["status"] != C.CUOPT_TERIMINATION_STATUS_OPTIMAL or \
                raw.get("vstat") is None:
            break
        stats["solved"] += 1
        new_bound = float(raw["dual_objective"])
        if total and new_bound < bound + min_gain * max(1.0, abs(bound)):
            bound = max(bound, new_bound)
            break  # cuts stopped paying
        bound = max(bound, new_bound)
        x = np.asarray(raw["primal_solution"], float)
        x_cut = x
        frac = np.abs(x - np.round(x))
        if not np.any((frac > 1e-6) & is_int):
            break  # LP optimum already integral
        sact = _row_activity(cur, x)
        rows, rhs = gmi_cuts(cur, x, sact, raw["vstat"], is_int,
                             max_cuts=max_cuts)
        # keep only cuts actually violated at the LP optimum
        if len(rhs):
            viol = rhs - rows @ x
            keep = viol > 1e-7
            rows, rhs = rows[keep], rhs[keep]
        if not len(rhs):
            break
        cur = append_rows(cur, rows, rhs)
        total += len(rhs)
        log.debug(
            f"[{timer.elapsed():.1f}s] gmi round {it + 1}: +{len(rhs)} "
            f"cuts ({total} total), root bound {new_bound:.6g}"
        )
    if total == 0:
        return None, bound, 0, x_cut
    return cur, bound, total, x_cut


def _row_activity(prob, x):
    off = prob.offsets
    s = np.empty(prob.n_constraints)
    for i in range(prob.n_constraints):
        s[i] = prob.values[off[i]:off[i + 1]] @ \
            x[prob.indices[off[i]:off[i + 1]]]
    return s
