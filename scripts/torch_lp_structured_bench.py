#!/usr/bin/env python3
"""Structured-LP benchmark of cuopt_torch: the generator families, on the card.

    python scripts/torch_lp_structured_bench.py            # scale 100,000
    python scripts/torch_lp_structured_bench.py --device cpu --scale 2000 \\
        --families set-cover

cuopt_torch's counterpart of scripts/lp_structured_bench.py: each of the
five Mittelmann-class GENERATORS families at --scale (seed 0) solved by
solve_lp with method Concurrent (the host dual simplex races PDLP), float32,
at --tol (1e-4). The generation, the device problem's build (timed apart:
the solve then finds it built) and the solve are timed apart; of the
solve, the first major ("compile_s") and the loop ("solve_loop_s") when
PDLP ran. Then the shrunken-copy cross-check of
tests/test_mittelmann_lp.py: each family at --check-scale (seed 3) by
the host dual simplex and by PDLP alone (float64, 1e-6) on the device,
whose objectives must agree within 1e-4 relative (exit 1 otherwise).
One JSON line per family, the summary last; --out writes the summary
with every result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def settings(tol, time_limit):
    """The reference script's settings: Concurrent, float32, `tol`."""
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_CONCURRENT
    s.set_optimality_tolerance(tol)
    s.time_limit = time_limit
    s.dtype = "float32"
    s.log_to_console = False
    return s


def solve_family(name, scale, tol, time_limit, device):
    import torch

    from cuopt_torch.lp.pdlp import PdlpSolver, build_device_problem
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.problem.mittelmann import GENERATORS

    t0 = time.perf_counter()
    prob = GENERATORS[name](scale, 0)
    gen_s = time.perf_counter() - t0
    s = settings(tol, time_limit)
    t0 = time.perf_counter()
    build_device_problem(prob, PdlpSolver(prob, s, device).hp,
                         torch.float32, s.operator_kind, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = solve_lp(prob, s, device=device)
    wall = time.perf_counter() - t0
    raw = sol._raw
    return {
        "family": name,
        "rows": prob.n_constraints,
        "cols": prob.n_variables,
        "nnz": prob.nnz,
        "generate_s": round(gen_s, 3),
        "build_s": round(build_s, 3),
        "status": int(raw["status"]),
        "objective": float(raw["primal_objective"]),
        "iterations": int(raw["iterations"]),
        "wall_s": round(wall, 3),
        "solved_by": raw.get("solved_by", "pdlp"),
        "compile_s": raw.get("compile_s"),
        "solve_loop_s": raw.get("solve_loop_s"),
    }


def cross_check(name, scale, device):
    """PDLP alone at 1e-6 against the host dual simplex on a shrunken
    copy: (simplex objective, PDLP objective, agree)."""
    from cuopt_torch import constants as C
    from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
    from cuopt_torch.lp.pdlp import PdlpSolver
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.problem.mittelmann import GENERATORS
    from cuopt_torch.utils.timer import Timer

    prob = GENERATORS[name](scale, 3)
    s = PDLPSolverSettings()
    s.time_limit = 120
    s.log_to_console = False
    ds = solve_lp_simplex(prob, s, Timer(120))
    s2 = PDLPSolverSettings()
    s2.time_limit = 300
    s2.log_to_console = False
    s2.set_optimality_tolerance(1e-6)
    s2.iteration_limit = 200_000
    lp = PdlpSolver(prob, s2, device).run()
    a, b = ds["primal_objective"], lp["primal_objective"]
    ok = (ds["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
          and lp["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
          and abs(a - b) <= 1e-4 * max(1.0, abs(a)))
    return {"scale": scale, "simplex_objective": a, "pdlp_objective": b,
            "pdlp_iterations": int(lp["iterations"]), "agree": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=100_000)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--time-limit", type=float, default=600.0)
    ap.add_argument("--check-scale", type=int, default=800)
    ap.add_argument("--families", default=None,
                    help="comma-separated; default every family")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch import constants as C
    from cuopt_torch.problem.mittelmann import GENERATORS
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    names = (sorted(GENERATORS) if a.families is None
             else a.families.split(","))
    results = []
    for name in names:
        r = solve_family(name, a.scale, a.tol, a.time_limit, a.device)
        r["cross_check"] = cross_check(name, a.check_scale, a.device)
        results.append(r)
        print(json.dumps(r), flush=True)

    ok = [r for r in results
          if r["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL]
    solve_times = [max(r["solve_loop_s"] or r["wall_s"], 1e-3) for r in ok]
    summary = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "scale": a.scale,
        "families": len(results),
        "solved_optimal": len(ok),
        "winners": {r["family"]: r["solved_by"] for r in results},
        "geomean_solve_loop_s": round(math.exp(
            sum(math.log(t) for t in solve_times) / len(solve_times)
        ), 3) if solve_times else None,
        "geomean_iters_per_s": round(math.exp(sum(
            math.log(max(r["iterations"], 1)
                     / max(r["solve_loop_s"] or r["wall_s"], 1e-3))
            for r in ok) / len(ok)), 1) if ok else None,
        "cross_check_agree": sum(r["cross_check"]["agree"] for r in results),
    }
    if a.out:
        with open(a.out, "w") as f:
            json.dump({**summary, "results": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["cross_check_agree"] == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
