#!/usr/bin/env python3
"""Routing quality against the recorded best costs, cuopt_torch on the card.

    python scripts/torch_bks_benchmark.py                  # six instances
    python scripts/torch_bks_benchmark.py --instances GHC_200_1 --time-limit 10
    python scripts/torch_bks_benchmark.py --device cpu --instances GHC_30_1 \\
        --time-limit 2

cuopt_torch's counterpart of scripts/bks_benchmark.py, synthetic mode
only: the six Gehring-Homberger-class instances of SYNTH_SET
(synth_gh_instance: C, R and RC at 200 and 400 customers), each solved
by cuopt_torch.routing.Solve with --time-limit seconds (30 by default)
and seed 0. --instances picks some by name (GH<class>_<customers>_<seed>,
any size). The reference's --dataset-root mode and its published-class
context read datasets outside the repo, so neither is ported.

Each solve's routes are rechecked on the host in float64: every order
served exactly once, time windows and capacity kept. Its cost and
vehicles stand beside scripts/bks_synth_baseline.json (the reference's
recorded best costs, read, never written): gap % and vehicle delta.
--record folds better costs into scripts/torch_bks_synth_baseline.json.
One JSON line per instance, then the summary as the last line; --out
writes the summary with every result. A solve that fails (status not 0)
or breaks the host recheck exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_BASELINE = os.path.join(ROOT, "scripts", "bks_synth_baseline.json")
BASELINE_PATH = os.path.join(ROOT, "scripts", "torch_bks_synth_baseline.json")

SYNTH_SET = [
    ("C", 200, 1), ("R", 200, 2), ("RC", 200, 3),
    ("C", 400, 4), ("R", 400, 5), ("RC", 400, 6),
]


def parse_name(name):
    """(class, customers, seed) of a name GH<class>_<customers>_<seed>."""
    m = re.fullmatch(r"GH(C|R|RC)_(\d+)_(\d+)", name)
    if not m:
        raise ValueError(f"{name!r}: expected GH<C|R|RC>_<n>_<seed>")
    return m.group(1), int(m.group(2)), int(m.group(3))


def host_route_check(inst, routes):
    """(max time-window violation, max capacity excess) of the routes, an
    order list per vehicle in serve-order ids, recomputed in float64 on
    the host from the instance's own data (depot 0, customer o at node
    o + 1, travel time = distance)."""
    dist = inst.cost_matrix()
    tw_e = inst.tw_early if inst.tw_early is not None else \
        np.zeros(len(inst.xy))
    tw_l = inst.tw_late if inst.tw_late is not None else \
        np.full(len(inst.xy), np.inf)
    svc = inst.service if inst.service is not None else np.zeros(len(inst.xy))
    tw_viol = cap_viol = 0.0
    for r in routes:
        if not r:
            continue
        t, at = float(tw_e[0]), 0
        for o in r:
            node = o + 1
            t = max(t + dist[at, node], tw_e[node])
            tw_viol = max(tw_viol, t - tw_l[node])
            t += svc[node]
            at = node
        tw_viol = max(tw_viol, t + dist[at, 0] - tw_l[0])
        cap_viol = max(cap_viol, float(inst.demand[np.asarray(r) + 1].sum())
                       - inst.capacity)
    return tw_viol, cap_viol


def check_solution(inst, sol):
    """The host recheck of a solve's route table: whether every order is
    served exactly once, and the largest time-window violation and
    capacity excess."""
    table = sol.get_route()
    served = table[np.isin(table["type"], ["Delivery", "Pickup"])]
    n = len(inst.xy) - 1
    once = bool(np.array_equal(np.sort(served["route"]), np.arange(n)))
    routes = []
    for v in np.unique(served["truck_id"]):
        sub = served[served["truck_id"] == v]
        order = np.argsort(sub["arrival_stamp"], kind="stable")
        routes.append(sub["route"][order].tolist())
    tw_viol, cap_viol = host_route_check(inst, routes)
    return {"served_once": once, "tw_violation": float(tw_viol),
            "capacity_excess": float(cap_viol),
            "ok": once and tw_viol <= 1e-6 and cap_viol <= 1e-9}


def solve_instance(inst, time_limit, device):
    from cuopt_torch.io.vrp import solution_cost
    from cuopt_torch.routing import Solve, SolverSettings

    s = SolverSettings()
    s.time_limit = time_limit
    s.seed = 0
    t0 = time.time()
    sol = Solve(inst.to_data_model(), s, device=device)
    elapsed = time.time() - t0
    if sol.get_status() != 0:
        return dict(instance=inst.name, status=int(sol.get_status()),
                    message=sol.get_message(), solve_s=round(elapsed, 1))
    cost, used = solution_cost(inst, sol)
    return dict(instance=inst.name, status=0, cost=round(cost, 2),
                vehicles=used, solve_s=round(elapsed, 1),
                host_check=check_solution(inst, sol))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--instances", default=None,
                    help="comma-separated names; default the six of "
                         "SYNTH_SET")
    ap.add_argument("--time-limit", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", action="store_true",
                    help="fold better costs into " + BASELINE_PATH)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    cases = (SYNTH_SET if a.instances is None else
             [parse_name(n) for n in a.instances.split(",")])
    with open(REFERENCE_BASELINE) as f:
        reference = json.load(f)
    results = []
    for kind, n, seed in cases:
        inst = synth_gh_instance(n, kind, seed)
        r = solve_instance(inst, a.time_limit, a.device)
        if r["status"] == 0 and inst.name in reference:
            best = reference[inst.name]
            r["baseline_cost"] = best["cost"]
            r["baseline_vehicles"] = best["vehicles"]
            r["gap_pct"] = round(100 * (r["cost"] - best["cost"])
                                 / best["cost"], 2)
            r["extra_vehicles"] = r["vehicles"] - best["vehicles"]
        results.append(r)
        print(json.dumps(r), flush=True)
    if a.record:
        new = {}
        if os.path.exists(BASELINE_PATH):
            with open(BASELINE_PATH) as f:
                new = json.load(f)
        for r in results:
            if r["status"] != 0 or not r["host_check"]["ok"]:
                continue
            cur = new.get(r["instance"], {}).get("cost")
            if cur is None or r["cost"] < cur:
                new[r["instance"]] = {"cost": r["cost"],
                                      "vehicles": r["vehicles"]}
        with open(BASELINE_PATH, "w") as f:
            json.dump(new, f, indent=1)
        print(f"baseline updated: {BASELINE_PATH}", file=sys.stderr)
    ok = [r for r in results if r["status"] == 0 and r["host_check"]["ok"]]
    gaps = [r["gap_pct"] for r in ok if "gap_pct" in r]
    summary = {
        "mode": "synthetic-gh",
        "device": card["name"],
        "power_limit": card["power_limit"],
        "time_limit_s": a.time_limit,
        "solved": len(ok),
        "total": len(results),
        "mean_gap_pct": round(sum(gaps) / len(gaps), 2) if gaps else None,
        "extra_vehicles": sum(r["extra_vehicles"] for r in ok
                              if "extra_vehicles" in r),
    }
    if a.out:
        with open(a.out, "w") as f:
            json.dump({**summary, "results": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if len(ok) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
