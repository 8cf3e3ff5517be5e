"""The plain reference: judge an LP answer by what it says, in float64.

An LP here is the benchmark's own arrays (`perfbench.lpgen`): CSR rows
(offsets, indices, values), objective c, row bounds lc <= A x <= uc and
column bounds lv <= x <= uv, minimised. An answer is a primal x, a dual y
(one entry per row, A^T y + rc = c) and the objective the solver reported.

`shares` works out again, from those arrays alone, the three quantities
that an optimality tolerance eps bounds (cuOpt's relative criteria, with
the absolute and the relative tolerance both eps):

  primal  ||violation of the row and column bounds by x||_2
          over  eps + eps * ||b||_2,  b_i = max(|lc_i|, |uc_i|) (finite)
  dual    ||signs of y and rc that no finite bound pays for||_2
          over  eps + eps * ||c||_2
  gap     |objective - dual objective|  over  eps + eps * (|obj| + |dual obj|)

where rc = c - A^T y and the dual objective is
sum(lc y+) - sum(uc y-) + sum(lv rc+) - sum(uv rc-) over finite bounds.
The gap is taken twice, once with c.x and once with the reported
objective, so an objective that disagrees with x fails too. Each share
is at most 1 for an answer that meets the tolerance.

Only NumPy: nothing of the program is imported or used.
"""

from __future__ import annotations

import numpy as np


def _rows(offsets) -> np.ndarray:
    offsets = np.asarray(offsets, np.int64)
    return np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))


def matvec(lp: dict, x) -> np.ndarray:
    """A x in float64."""
    n = len(lp["lc"])
    w = lp["values"] * np.asarray(x, np.float64)[lp["indices"]]
    return np.bincount(_rows(lp["offsets"]), weights=w, minlength=n)


def rmatvec(lp: dict, y) -> np.ndarray:
    """A^T y in float64."""
    m = len(lp["c"])
    w = lp["values"] * np.asarray(y, np.float64)[_rows(lp["offsets"])]
    return np.bincount(lp["indices"], weights=w, minlength=m)


def _finite(v):
    fin = np.isfinite(v)
    return fin, np.where(fin, v, 0.0)


def shares(lp: dict, x, y, objective: float, eps: float) -> dict:
    """The answer's primal, dual and gap shares of the tolerance `eps`
    (see the module's docstring); each is a float >= 0, or inf where the
    answer has the wrong length or a value that is not finite."""
    n, m = len(lp["lc"]), len(lp["c"])
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    bad = {"primal": np.inf, "dual": np.inf, "gap": np.inf}
    if x.shape != (m,) or y.shape != (n,) or not (
            np.all(np.isfinite(x)) and np.all(np.isfinite(y))
            and np.isfinite(objective)):
        return bad
    lc_fin, lc = _finite(lp["lc"])
    uc_fin, uc = _finite(lp["uc"])
    lv_fin, lv = _finite(lp["lv"])
    uv_fin, uv = _finite(lp["uv"])
    c = np.asarray(lp["c"], np.float64)

    act = matvec(lp, x)
    primal = np.concatenate([
        np.where(lc_fin, np.maximum(lc - act, 0.0), 0.0)
        + np.where(uc_fin, np.maximum(act - uc, 0.0), 0.0),
        np.where(lv_fin, np.maximum(lv - x, 0.0), 0.0)
        + np.where(uv_fin, np.maximum(x - uv, 0.0), 0.0),
    ])
    b_norm = np.linalg.norm(np.maximum(np.abs(lc), np.abs(uc)))

    rc = c - rmatvec(lp, y)
    rc_p, rc_m = np.maximum(rc, 0.0), np.maximum(-rc, 0.0)
    y_p, y_m = np.maximum(y, 0.0), np.maximum(-y, 0.0)
    dual = np.concatenate([
        np.where(lv_fin, 0.0, rc_p) + np.where(uv_fin, 0.0, rc_m),
        np.where(lc_fin, 0.0, y_p) + np.where(uc_fin, 0.0, y_m),
    ])

    cx = float(c @ x)
    dobj = float(lc @ y_p - uc @ y_m + lv @ rc_p - uv @ rc_m)

    def gap(pobj):
        return abs(pobj - dobj) / (eps + eps * (abs(pobj) + abs(dobj)))

    return {
        "primal": float(np.linalg.norm(primal) / (eps + eps * b_norm)),
        "dual": float(np.linalg.norm(dual)
                      / (eps + eps * np.linalg.norm(c))),
        "gap": max(gap(cx), gap(float(objective))),
    }


def worst(s: dict) -> float:
    """The largest of an answer's shares."""
    return max(s.values())
