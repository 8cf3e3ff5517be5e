#!/usr/bin/env python3
"""MIP benchmark and quality ratchet for cuopt_torch, on the card.

    python scripts/torch_mip_benchmark.py                   # generated set
    python scripts/torch_mip_benchmark.py --record    # fold into baseline
    python scripts/torch_mip_benchmark.py --dir DIR [--glob '*.mps']
    python scripts/torch_mip_benchmark.py --device cpu \\
        --instances knapsack,staircase-mip-500 --time-limit 10

cuopt_torch's counterpart of scripts/mip_benchmark.py. By default it
solves generated MIPs, built as chip_smoke.py builds them (copied here):
the knapsack, the twelve binaries, and the staircase MIP
(generate_lp(n, n, 8, seed=123, band=256), a seeded 30% of its columns
binary, rows A x_hat + U(0.1, 1.0) for a feasible x_hat) at n = 3,000
and 50,000; `staircase-mip-<n>` (or `<n>k`) names any n. With --dir it
solves the MPS files there instead, through torch_benchmark_lp.py's
solve_one; the reference's default directory is a dataset outside the
repo, so it is not ported.

Each instance is solved by solve_mip with --time-limit seconds, and its
objective, bound, gap, nodes and wall are recorded, with the seconds to
the first incumbent that reached a user's incumbent callback (the
heuristics' points: as in cuopt_tpu, the tree's own incumbents reach
none); a generated instance's incumbent is rechecked on
the host in float64 (rows, bounds, integrality), and a point that fails
the recheck exits 1. The results are compared with
scripts/torch_mip_baseline.json by compare_to_baseline (the reference's
rule and tolerances): --check exits 1 on a regression, --record folds
improvements into the baseline. The summary goes to --out
(MIP_TORCH_latest.json at the repo root by default) and, without the
results, to the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_PATH = os.path.join(ROOT, "scripts", "torch_mip_baseline.json")
GENERATED = ("knapsack", "twelve-binaries", "staircase-mip-3k",
             "staircase-mip-50k")

_OPTIMAL = 1  # the status a ratchet holds once reached


def compare_to_baseline(results, baseline, rel_tol=1e-6, gap_slack=0.02):
    """Return a list of regression strings (empty = pass).

    A regression is: a worse primal objective (the results hold
    objectives in the user's orientation, so the baseline carries the
    sense), a lost proven-optimal status, or a MIP gap more than
    `gap_slack` absolute above the frozen gap.
    """
    problems = []
    for r in results:
        name = r.get("instance")
        b = baseline.get(name)
        if not b or not r.get("mip"):
            continue
        sense = b.get("sense", "min")
        sgn = 1.0 if sense == "min" else -1.0
        if b.get("status") == _OPTIMAL and r.get("status") != _OPTIMAL:
            problems.append(
                f"{name}: proven-optimal status lost "
                f"(now {r.get('status')})"
            )
        bo, ro = b.get("objective"), r.get("objective")
        if bo is not None and ro is not None and not (
            isinstance(ro, str) or math.isnan(ro)
        ):
            tol = rel_tol * max(1.0, abs(bo))
            if sgn * ro > sgn * bo + tol:
                problems.append(
                    f"{name}: objective regressed {ro:.6g} vs frozen "
                    f"{bo:.6g} ({sense})"
                )
        bg, rg = b.get("mip_gap"), r.get("mip_gap")
        if bg is not None and rg is not None and math.isfinite(bg):
            if not math.isfinite(rg) or rg > bg + gap_slack:
                problems.append(
                    f"{name}: gap regressed {rg:.4g} vs frozen {bg:.4g}"
                )
    return problems


def updated_baseline(baseline, results):
    """The baseline with the results' improvements folded in: a better
    objective, a newly proven optimum, or a smaller gap."""
    new = dict(baseline)
    for r in results:
        if not r.get("mip"):
            continue
        name = r["instance"]
        b = new.get(name)
        sense = (b or {}).get("sense", "min")
        sgn = 1.0 if sense == "min" else -1.0
        obj = r.get("objective")
        better = (
            b is None
            or (obj is not None and b.get("objective") is not None
                and sgn * obj < sgn * b["objective"] - 1e-9)
        )
        if better or (b and r.get("status") == _OPTIMAL
                      and b.get("status") != _OPTIMAL):
            new[name] = {
                "sense": sense,
                "status": r.get("status"),
                "objective": obj,
                "mip_gap": r.get("mip_gap"),
            }
        elif b is not None and r.get("mip_gap") is not None and \
                b.get("mip_gap") is not None and \
                math.isfinite(r["mip_gap"]) and \
                r["mip_gap"] < b["mip_gap"] - 1e-12:
            nb = dict(b)
            nb["mip_gap"] = r["mip_gap"]
            new[name] = nb
    return new


# ---------------------------------------------- generated instances
def knapsack():
    """max 5x0+4x1+3x2 s.t. 2x0+3x1+x2 <= 5, 4x0+x1+2x2 <= 11, x in
    {0..3}, as a minimization."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    A = np.array([[2.0, 3.0, 1.0], [4.0, 1.0, 2.0]])
    return OptimizationProblem.from_dense(
        A, c=np.array([-5.0, -4.0, -3.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([5.0, 11.0]),
        variable_lower=np.zeros(3), variable_upper=np.full(3, 3.0),
        variable_types=np.array(["I", "I", "I"]))


def twelve_binaries():
    """Twelve binaries under three knapsack rows."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    rng = np.random.default_rng(5)
    A = rng.integers(1, 9, (3, 12)).astype(float)
    return OptimizationProblem.from_dense(
        A, c=-(rng.integers(3, 20, 12).astype(float)),
        constraint_lower=np.full(3, -np.inf),
        constraint_upper=A.sum(axis=1) * 0.4,
        variable_lower=np.zeros(12), variable_upper=np.ones(12),
        variable_types=np.array(["I"] * 12))


def staircase_mip(n, seed=0):
    """generate_lp(n, n, 8, seed=123, band=256) with a seeded 30% of its
    columns binary and row upper bounds A x_hat + U(0.1, 1.0) for a point
    x_hat with binary entries in {0, 1} and the others in U(0.2, 0.8):
    x_hat is feasible by construction and the instance mixed."""
    from cuopt_torch.problem.synthetic import generate_lp

    p = generate_lp(n, n, 8, seed=123, band=256)
    rng = np.random.default_rng(seed)
    is_int = np.zeros(n, bool)
    is_int[rng.choice(n, int(0.3 * n), replace=False)] = True
    x_hat = np.where(is_int, rng.integers(0, 2, n), rng.uniform(0.2, 0.8, n))
    rows = np.repeat(np.arange(n), np.diff(p.offsets))
    act = np.bincount(rows, weights=p.values * x_hat[p.indices], minlength=n)
    ub = act + rng.uniform(0.1, 1.0, n)
    return dataclasses.replace(
        p, variable_types=np.where(is_int, "I", "C").astype("U1"),
        constraint_upper_bounds=ub, rhs=ub.copy())


def generated(name):
    """The generated instance of that name."""
    if name == "knapsack":
        return knapsack()
    if name == "twelve-binaries":
        return twelve_binaries()
    if name.startswith("staircase-mip-"):
        size = name[len("staircase-mip-"):]
        n = int(size[:-1]) * 1000 if size.endswith("k") else int(size)
        return staircase_mip(n)
    raise ValueError(f"unknown generated instance {name!r}")


def host_mip_check(p, x):
    """(max row violation, max bound violation, integral) of x for p, in
    float64 on the host."""
    rows = np.repeat(np.arange(p.n_constraints), np.diff(p.offsets))
    act = np.bincount(rows, weights=p.values * x[p.indices],
                      minlength=p.n_constraints)
    lo, hi = p.constraint_lower_bounds, p.constraint_upper_bounds
    row = max(float(np.max(np.where(np.isfinite(lo), lo - act, 0.0))),
              float(np.max(np.where(np.isfinite(hi), act - hi, 0.0))), 0.0)
    bnd = max(float(np.max(p.variable_lower_bounds - x)),
              float(np.max(x - p.variable_upper_bounds)), 0.0)
    is_int = p.variable_types == "I"
    return row, bnd, bool(np.all(x[is_int] == np.round(x[is_int])))


def solve_generated(name, time_limit, device):
    """solve_mip on a generated instance; the result with its host
    recheck (`host_ok`) and the seconds to the first incumbent a user's
    callback saw."""
    from cuopt_torch.lp.internals import GetSolutionCallback
    from cuopt_torch.lp.settings import MIPSolverSettings
    from cuopt_torch.mip.solve import solve_mip

    p = generated(name)
    found = []

    class FirstIncumbent(GetSolutionCallback):
        def get_solution(self, solution, solution_cost):
            found.append(time.perf_counter())

    s = MIPSolverSettings()
    s.time_limit = time_limit
    s.log_to_console = False
    s.set_mip_callback(FirstIncumbent())
    t0 = time.perf_counter()
    sol = solve_mip(p, s, device=device)
    wall = time.perf_counter() - t0
    r = {
        "instance": name,
        "rows": p.n_constraints, "cols": p.n_variables, "nnz": p.nnz,
        "mip": True,
        "status": int(sol.get_termination_status()),
        "objective": float(sol.get_primal_objective()),
        "solution_bound": float(sol.get_solution_bound()),
        "mip_gap": float(sol.get_mip_gap()),
        "nodes": sol._raw.get("nodes"),
        "callback_first_incumbent_s": (round(found[0] - t0, 3) if found
                                       else None),
        "wall_s": round(wall, 2),
    }
    x = np.asarray(sol.get_primal_solution(), np.float64)
    if math.isfinite(r["objective"]) and x.size == p.n_variables:
        row, bnd, integral = host_mip_check(p, x)
        r["host_check"] = {"row_violation": row, "bound_violation": bnd,
                           "integral": integral}
        r["host_ok"] = row <= 1e-6 and bnd <= 1e-9 and integral
    else:
        r["host_ok"] = None  # no incumbent to recheck
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", default=",".join(GENERATED),
                    help="generated instances, comma-separated")
    ap.add_argument("--dir", default=None,
                    help="solve the MPS files here instead")
    ap.add_argument("--glob", default="*.mps")
    ap.add_argument("--time-limit", type=float, default=90.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "MIP_TORCH_latest.json"))
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any ratchet regression")
    ap.add_argument("--record", action="store_true",
                    help="fold improvements into the baseline")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    results = []
    if a.dir:
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        from torch_benchmark_lp import solve_one

        files = sorted(glob.glob(os.path.join(a.dir, a.glob)))
        files = [f for f in files if "infeas" not in os.path.basename(f)
                 or "minrep" in os.path.basename(f)]
        for f in files:
            t0 = time.time()
            r = solve_one(f, a.time_limit, 1e-4, None, a.device)
            r["wall_s"] = round(time.time() - t0, 2)
            results.append(r)
            print(json.dumps(r), flush=True)
    else:
        for name in a.instances.split(","):
            r = solve_generated(name, a.time_limit, a.device)
            results.append(r)
            print(json.dumps(r), flush=True)

    baseline = {}
    if os.path.exists(BASELINE_PATH):
        with open(BASELINE_PATH) as f:
            baseline = json.load(f)
    problems = compare_to_baseline(results, baseline)
    bad_points = [r["instance"] for r in results if r.get("host_ok") is False]
    summary = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "instances": len(results),
        "solved_optimal": sum(1 for r in results
                              if r.get("status") == _OPTIMAL),
        "time_limit_s": a.time_limit,
        "host_check_failed": bad_points,
        "ratchet_regressions": problems,
    }
    with open(a.out, "w") as f:
        json.dump({**summary, "results": results}, f, indent=1)
    if a.record:
        with open(BASELINE_PATH, "w") as f:
            json.dump(updated_baseline(baseline, results), f, indent=1)
        print(f"baseline updated: {BASELINE_PATH}", file=sys.stderr)
    print(json.dumps(summary), flush=True)
    if bad_points:
        print(f"host recheck failed: {bad_points}", file=sys.stderr)
        return 1
    if a.check and problems:
        for p in problems:
            print("RATCHET REGRESSION:", p, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
