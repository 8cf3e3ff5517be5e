"""MIP presolve: trivial presolve + iterated activity-based bound
propagation.

The port's own copy of cuopt_tpu/mip/presolve.py (host numpy, no JAX),
which mirrors the reference GPU presolve (cpp/src/mip/presolve/:
bounds_presolve.cuh `bound_presolve_t`, trivial_presolve.cuh). Presolve
runs once per solve (and per B&B node for propagation) over the CSR
arrays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF = np.inf


@dataclass
class PresolveResult:
    lv: np.ndarray
    uv: np.ndarray
    infeasible: bool
    n_rounds: int
    tightened: int


def propagate_bounds(
    offsets: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    lc: np.ndarray,
    uc: np.ndarray,
    lv: np.ndarray,
    uv: np.ndarray,
    is_integer: np.ndarray,
    max_rounds: int = 10,
    feas_tol: float = 1e-6,
    int_tol: float = 1e-5,
) -> PresolveResult:
    """Iterated activity-based bound propagation (reference
    bounds_presolve.cuh: min/max constraint activity from variable bounds,
    implied variable bounds from the residual activity, integer rounding).
    """
    n = len(lc)
    lv = lv.astype(float).copy()
    uv = uv.astype(float).copy()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    cols = indices
    vals = values
    pos = vals > 0
    tightened_total = 0
    INF_ = np.inf

    for rnd in range(max_rounds):
        # Per-entry activity contributions with the current bounds.
        # Infinite bounds are handled with EXPLICIT counters per row
        # (reference bounds_presolve.cuh does the same): summing ±BIG
        # sentinels instead loses the finite terms to floating-point
        # absorption (eps at 1e20 is ~1e4) and produced bogus implied
        # bounds for rows with free variables.
        lo_contrib = np.where(pos, vals * lv[cols], vals * uv[cols])
        hi_contrib = np.where(pos, vals * uv[cols], vals * lv[cols])
        flo = np.isfinite(lo_contrib)
        fhi = np.isfinite(hi_contrib)
        lo_fin = np.where(flo, lo_contrib, 0.0)
        hi_fin = np.where(fhi, hi_contrib, 0.0)
        min_fin = np.zeros(n)
        max_fin = np.zeros(n)
        np.add.at(min_fin, rows, lo_fin)
        np.add.at(max_fin, rows, hi_fin)
        n_inf_lo = np.zeros(n, np.int64)
        n_inf_hi = np.zeros(n, np.int64)
        np.add.at(n_inf_lo, rows, (~flo).astype(np.int64))
        np.add.at(n_inf_hi, rows, (~fhi).astype(np.int64))

        # row infeasibility: only provable when no infinite contribution
        if np.any((n_inf_lo == 0) & np.isfinite(uc)
                  & (min_fin > uc + feas_tol)):
            return PresolveResult(lv, uv, True, rnd + 1, tightened_total)
        if np.any((n_inf_hi == 0) & np.isfinite(lc)
                  & (max_fin < lc - feas_tol)):
            return PresolveResult(lv, uv, True, rnd + 1, tightened_total)

        # residual min/max activity of the row WITHOUT entry (i, j):
        # finite iff all other contributions are finite
        nl = n_inf_lo[rows]
        nh = n_inf_hi[rows]
        resid_min = np.where(
            nl == 0, min_fin[rows] - lo_fin,
            np.where((nl == 1) & ~flo, min_fin[rows], -INF_),
        )
        resid_max = np.where(
            nh == 0, max_fin[rows] - hi_fin,
            np.where((nh == 1) & ~fhi, max_fin[rows], INF_),
        )
        # implied bound for entry (i, j):
        #   a>0: x_j <= (uc_i - resid_min) / a ; x_j >= (lc_i - resid_max)/a
        #   a<0: mirrored
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            ub_from_uc = np.where(
                pos, (uc[rows] - resid_min) / vals,
                (lc[rows] - resid_max) / vals,
            )
            lb_from_lc = np.where(
                pos, (lc[rows] - resid_max) / vals,
                (uc[rows] - resid_min) / vals,
            )
        gov_ub_ok = np.where(
            pos,
            np.isfinite(uc[rows]) & np.isfinite(resid_min),
            np.isfinite(lc[rows]) & np.isfinite(resid_max),
        )
        gov_lb_ok = np.where(
            pos,
            np.isfinite(lc[rows]) & np.isfinite(resid_max),
            np.isfinite(uc[rows]) & np.isfinite(resid_min),
        )
        ub_from_uc = np.where(
            gov_ub_ok & np.isfinite(ub_from_uc), ub_from_uc, INF_
        )
        lb_from_lc = np.where(
            gov_lb_ok & np.isfinite(lb_from_lc), lb_from_lc, -INF_
        )

        new_uv = uv.copy()
        new_lv = lv.copy()
        np.minimum.at(new_uv, cols, ub_from_uc)
        np.maximum.at(new_lv, cols, lb_from_lc)
        # integer rounding
        new_uv = np.where(
            is_integer & np.isfinite(new_uv),
            np.floor(new_uv + int_tol), new_uv,
        )
        new_lv = np.where(
            is_integer & np.isfinite(new_lv),
            np.ceil(new_lv - int_tol), new_lv,
        )
        # keep only genuine tightenings (avoid loosening)
        new_uv = np.minimum(new_uv, uv)
        new_lv = np.maximum(new_lv, lv)
        if np.any(new_lv > new_uv + feas_tol):
            return PresolveResult(new_lv, new_uv, True, rnd + 1,
                                  tightened_total)
        with np.errstate(invalid="ignore"):
            changed = int(
                np.sum(np.where(np.isfinite(uv) | np.isfinite(new_uv),
                                new_uv < uv - 1e-12, False))
                + np.sum(np.where(np.isfinite(lv) | np.isfinite(new_lv),
                                  new_lv > lv + 1e-12, False))
            )
        tightened_total += changed
        lv, uv = new_lv, new_uv
        if changed == 0:
            break
    # clamp tiny inversions from rounding
    with np.errstate(invalid="ignore"):
        bad = lv > uv
    if bad.any():
        mid = (lv[bad] + uv[bad]) / 2
        lv[bad] = mid
        uv[bad] = mid
    return PresolveResult(lv, uv, False, rnd + 1, tightened_total)


def trivial_round_fixed(lv, uv, is_integer, int_tol=1e-5):
    """Variables with lv == uv are fixed (reference trivial_presolve.cuh
    fixes and compacts; we keep shapes and just report the mask)."""
    return np.isclose(lv, uv, atol=int_tol)


@dataclass
class ProbeResult:
    lv: np.ndarray
    uv: np.ndarray
    infeasible: bool
    n_probed: int
    n_fixed: int
    tightened: int
    # probing CACHE (reference probing_cache.cuh:88): per probed binary
    # and probe value, the SPARSE implied-bound deltas discovered by the
    # probe propagation — applied for free at B&B nodes that fix the
    # variable (cache[j][v] = (idx, lv_imp, uv_imp))
    cache: dict = None


def probe_variables(
    offsets: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    lc: np.ndarray,
    uc: np.ndarray,
    lv: np.ndarray,
    uv: np.ndarray,
    is_integer: np.ndarray,
    max_probes: int = 64,
    rounds_per_probe: int = 3,
    feas_tol: float = 1e-6,
    int_tol: float = 1e-5,
) -> ProbeResult:
    """Probing on binary/small-domain integer variables (reference
    cpp/src/mip/presolve/multi_probe.cuh `multi_probe_t` :33 +
    probing_cache.cuh): tentatively fix a variable at each of its two
    bound values, propagate, and

      - both branches infeasible -> the problem is infeasible,
      - one branch infeasible    -> fix the variable to the other value,
      - both feasible            -> tighten every variable's bounds to the
                                    union (hull) of the two branch domains.

    Probe candidates are binaries (and 2-value integers) ordered by how
    many constraints they touch — the reference orders by expected impact.
    """
    lv = lv.copy()
    uv = uv.copy()
    span = uv - lv
    binary = is_integer & np.isfinite(lv) & np.isfinite(uv) & \
        (span > int_tol) & (span < 1.0 + int_tol)
    cand = np.flatnonzero(binary)
    if len(cand) == 0:
        return ProbeResult(lv, uv, False, 0, 0, 0, {})
    # impact order: number of nonzeros in the variable's column
    col_counts = np.zeros(len(lv), np.int64)
    np.add.at(col_counts, indices, 1)
    cand = cand[np.argsort(-col_counts[cand])][:max_probes]

    n_fixed = 0
    tightened = 0
    cache: dict = {}
    for j in cand:
        if uv[j] - lv[j] <= int_tol:
            continue  # already fixed by an earlier probe
        branches = []
        infeas = []
        for val in (lv[j], uv[j]):
            lv_b = lv.copy()
            uv_b = uv.copy()
            lv_b[j] = uv_b[j] = val
            r = propagate_bounds(
                offsets, indices, values, lc, uc, lv_b, uv_b,
                is_integer, max_rounds=rounds_per_probe,
                feas_tol=feas_tol, int_tol=int_tol,
            )
            branches.append(r)
            infeas.append(r.infeasible)
        if infeas[0] and infeas[1]:
            return ProbeResult(lv, uv, True, int(np.sum(cand <= j)),
                               n_fixed, tightened, cache)
        if infeas[0] or infeas[1]:
            keep = branches[1] if infeas[0] else branches[0]
            lv, uv = keep.lv.copy(), keep.uv.copy()
            n_fixed += 1
            continue
        # probing cache: sparse implied-bound deltas of each branch
        for bi, val in enumerate((lv[j], uv[j])):
            br = branches[bi]
            idx = np.flatnonzero(
                (br.lv > lv + 1e-9) | (br.uv < uv - 1e-9)
            )
            idx = idx[idx != j]
            if len(idx):
                cache.setdefault(int(j), {})[int(round(val))] = (
                    idx.astype(np.int32), br.lv[idx].copy(),
                    br.uv[idx].copy(),
                )
        # hull of the two feasible branch domains
        hull_lv = np.minimum(branches[0].lv, branches[1].lv)
        hull_uv = np.maximum(branches[0].uv, branches[1].uv)
        t = int(np.sum(hull_lv > lv + 1e-12) +
                np.sum(hull_uv < uv - 1e-12))
        if t:
            tightened += t
            lv = np.maximum(lv, hull_lv)
            uv = np.minimum(uv, hull_uv)
    return ProbeResult(lv, uv, False, len(cand), n_fixed, tightened,
                       cache)


@dataclass
class TrivialReduction:
    """Variable-elimination presolve result (reference
    trivial_presolve.cuh: fix/eliminate variables, compact the CSR with
    remove_if). `keep` maps reduced -> original columns; `x_fixed` holds
    the eliminated variables' values."""

    problem: object
    keep: np.ndarray       # (m_red,) original column of each kept var
    x_fixed: np.ndarray    # (m,) values, valid where fixed mask True
    fixed: np.ndarray      # (m,) bool

    def postsolve(self, x_reduced):
        x = self.x_fixed.copy()
        x[self.keep] = np.asarray(x_reduced, float)
        return x

    def project(self, x_full):
        return np.asarray(x_full, float)[self.keep]


def eliminate_fixed(prob, lv, uv, int_tol=1e-6):
    """Eliminate variables whose propagated bounds coincide: their terms
    move into the constraint bounds and the CSR is compacted. Returns a
    TrivialReduction, or None when nothing is fixed (or everything is —
    the caller's all-fixed fast path handles that)."""
    lv = np.asarray(lv, float)
    uv = np.asarray(uv, float)
    fixed = np.isfinite(lv) & np.isfinite(uv) & (uv - lv <= int_tol)
    n_fixed = int(fixed.sum())
    if n_fixed == 0 or n_fixed == prob.n_variables:
        return None
    xf = np.zeros(prob.n_variables)
    xf[fixed] = 0.5 * (lv[fixed] + uv[fixed])
    is_int = prob.variable_types == "I"
    xf[fixed & is_int] = np.round(xf[fixed & is_int])

    # constant contribution of fixed vars to each row
    rows = np.repeat(np.arange(prob.n_constraints),
                     np.diff(prob.offsets))
    keep_entry = ~fixed[prob.indices]
    shift = np.zeros(prob.n_constraints)
    drop = ~keep_entry
    np.add.at(shift, rows[drop],
              prob.values[drop] * xf[prob.indices[drop]])

    # compact CSR over kept entries + remap columns
    keep_cols = np.flatnonzero(~fixed)
    new_col = np.full(prob.n_variables, -1, np.int64)
    new_col[keep_cols] = np.arange(len(keep_cols))
    new_vals = prob.values[keep_entry]
    new_idx = new_col[prob.indices[keep_entry]]
    counts = np.zeros(prob.n_constraints, np.int64)
    np.add.at(counts, rows[keep_entry], 1)
    new_off = np.concatenate([[0], np.cumsum(counts)])

    clb = prob.constraint_lower_bounds - np.where(
        np.isfinite(prob.constraint_lower_bounds), shift, 0.0
    )
    cub = prob.constraint_upper_bounds - np.where(
        np.isfinite(prob.constraint_upper_bounds), shift, 0.0
    )
    offset = prob.objective_offset + float(
        prob.objective_coefficients[fixed] @ xf[fixed]
    )
    reduced = type(prob)(
        offsets=new_off, indices=new_idx, values=new_vals,
        objective_coefficients=prob.objective_coefficients[keep_cols],
        objective_offset=offset,
        maximize=prob.maximize,
        constraint_lower_bounds=clb,
        constraint_upper_bounds=cub,
        row_types=prob.row_types, rhs=prob.rhs,
        variable_lower_bounds=lv[keep_cols],
        variable_upper_bounds=uv[keep_cols],
        variable_types=prob.variable_types[keep_cols],
        # a problem built field by field has no names ([]): keep none
        variable_names=[prob.variable_names[int(j)]
                        for j in keep_cols]
        if prob.variable_names else [],
        row_names=prob.row_names,
    )
    return TrivialReduction(
        problem=reduced, keep=keep_cols, x_fixed=xf, fixed=fixed
    )
