#!/usr/bin/env python3
"""Concurrent-LP race of cuopt_torch: who wins, and in what wall, on the card.

    python scripts/torch_concurrent_lp_bench.py            # four instances
    python scripts/torch_concurrent_lp_bench.py --device cpu \\
        --cases staircase-500 --time-limit 30

cuopt_torch's counterpart of scripts/concurrent_lp_bench.py: solve_lp
with method Concurrent (the host dual simplex races PDLP on the device,
both legs started at once) at tolerance 1e-4 and the settings' default
float64, on instances chosen to have a winner on each side:
  - degen-transport-50k: degenerate_transport(25_000, 25_000, seed=0);
  - staircase-50k: generate_lp(50_000, 50_000, 8, seed=123, band=384);
  - staircase-500 and staircase-2k: generate_lp(n, n, 8, seed=123,
    band=256), the small races of chip_smoke.py's phase 7. They stand in
    for the reference's afiro, which is read from a dataset outside the
    repo and not ported.
Each case's status, objective, winner and wall; the win counts as the
last JSON line; --out writes them with every result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("degen-transport-50k", "staircase-50k", "staircase-500",
         "staircase-2k")


def instance(name):
    from cuopt_torch.problem.mittelmann import degenerate_transport
    from cuopt_torch.problem.synthetic import generate_lp

    if name == "degen-transport-50k":
        return degenerate_transport(25_000, 25_000, seed=0)
    if name == "staircase-50k":
        return generate_lp(50_000, 50_000, 8, seed=123, band=384)
    if name in ("staircase-500", "staircase-2k"):
        n = 500 if name == "staircase-500" else 2000
        return generate_lp(n, n, 8, seed=123, band=256)
    raise ValueError(f"unknown case {name!r}")


def settings(time_limit):
    """The reference script's settings: Concurrent, 1e-4."""
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_CONCURRENT
    s.time_limit = time_limit
    s.log_to_console = False
    s.set_optimality_tolerance(1e-4)
    return s


def race(name, time_limit, device):
    from cuopt_torch.lp.solve import solve_lp

    prob = instance(name)
    t0 = time.perf_counter()
    sol = solve_lp(prob, settings(time_limit), device=device)
    wall = time.perf_counter() - t0
    return {
        "instance": name,
        "rows": prob.n_constraints,
        "cols": prob.n_variables,
        "nnz": prob.nnz,
        "status": int(sol.get_termination_status()),
        "objective": float(sol.get_primal_objective()),
        "winner": sol._raw.get("solved_by"),
        "wall_s": round(wall, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--time-limit", type=float, default=120.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    results = []
    for name in a.cases.split(","):
        r = race(name, a.time_limit, a.device)
        results.append(r)
        print(json.dumps(r), flush=True)
    summary = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "simplex_wins": sum(1 for r in results
                            if r["winner"] == "dual_simplex"),
        "pdlp_wins": sum(1 for r in results if r["winner"] == "pdlp"),
        "winners": {r["instance"]: r["winner"] for r in results},
        "walls_s": {r["instance"]: r["wall_s"] for r in results},
    }
    if a.out:
        with open(a.out, "w") as f:
            json.dump({**summary, "results": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
