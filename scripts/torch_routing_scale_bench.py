#!/usr/bin/env python3
"""Routing scale benchmark of cuopt_torch: a 1,000-order CVRPTW, on the card.

    python scripts/torch_routing_scale_bench.py            # 1,000 orders, 60 s
    python scripts/torch_routing_scale_bench.py --device cpu --orders 60 \\
        --time-limit 3

cuopt_torch's counterpart of scripts/routing_scale_bench.py: on
synth_gh_instance(orders, "RC", seed=7), the batched construction's cost
and seconds, then Solve with --time-limit seconds (seed 0): its final
cost, vehicles, status and wall, and the improvement over the
construction. The solution's routes are rechecked on the host (every
order served once, time windows and capacity kept; exit 1 otherwise).
One JSON line last; --out writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=1000)
    ap.add_argument("--time-limit", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_bks_benchmark import check_solution

    from cuopt_torch.io.vrp import solution_cost, synth_gh_instance
    from cuopt_torch.routing import Solve, SolverSettings
    from cuopt_torch.routing.construction import batched_construction
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.local_search import build_ls_problem
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    inst = synth_gh_instance(a.orders, "RC", seed=7)
    dm = inst.to_data_model()
    prob = build_problem(dm)
    prob._lsp_cache = build_ls_problem(prob, device=a.device)

    t0 = time.perf_counter()
    base_routes, base_un = batched_construction(prob, prob._lsp_cache)
    t_constr = time.perf_counter() - t0
    base_cost = sum(prob.route_cost(v, r) for v, r in base_routes.items()
                    if r)

    s = SolverSettings()
    s.time_limit = a.time_limit
    s.seed = 0
    t0 = time.perf_counter()
    sol = Solve(dm, s, device=a.device)
    t_solve = time.perf_counter() - t0
    status = int(sol.get_status())
    art = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "orders": a.orders,
        "fleet": inst.n_vehicles,
        "construction_cost": round(float(base_cost), 2),
        "construction_s": round(t_constr, 3),
        "unassigned_after_construction": len(base_un),
        "time_limit_s": a.time_limit,
        "solve_s": round(t_solve, 2),
        "status": status,
    }
    if status == 0:
        cost, used = solution_cost(inst, sol)
        art.update(
            final_cost=round(float(cost), 2),
            vehicles_used=used,
            improvement_pct=round(100 * (base_cost - cost) / base_cost, 2),
            host_check=check_solution(inst, sol))
    line = json.dumps(art)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if status == 0 and art["host_check"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
