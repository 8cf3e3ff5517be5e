#!/usr/bin/env python3
"""Routing device-path benchmark of cuopt_torch, run on the card.

    python scripts/torch_routing_tpu_bench.py              # 1,000 orders
    python scripts/torch_routing_tpu_bench.py --device cpu --orders 60 \\
        --ls-rounds 3

cuopt_torch's counterpart of scripts/routing_tpu_bench.py (the name
mirrors it; nothing here runs on a TPU). On synth_gh_instance(orders,
"RC", seed=7): build_problem, build_ls_problem on the device, the
batched construction (one insertion-scoring program per round), then
the local search round by round, each round a _local_search call of one
round from the routes the last one left, up to --ls-rounds rounds or
until a round changes nothing. The first round is timed on its own (the
card's first launches); each further round's wall and, on the card, its
move evaluation's CUDA-event milliseconds (round_stats, as chip_smoke.py
reads them) are listed. A one-op launch-and-sync probe on the device
gives the floor of one round trip, the denominator of a round's time.

The final routes are rechecked on the host: every order at most once,
none lost, every route feasible (exit 1 otherwise). One JSON line last;
--out writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sync_floor(device, n=5):
    """Median seconds of one tiny op launched on `device` and read back."""
    import torch

    z = torch.zeros(8, device=device)
    (z + 1.0).cpu()
    floors = []
    for _ in range(n):
        t0 = time.perf_counter()
        (z + 1.0).cpu()
        floors.append(time.perf_counter() - t0)
    return statistics.median(floors)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=1000)
    ap.add_argument("--ls-rounds", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.construction import batched_construction
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.solver import _local_search
    from cuopt_torch.utils.device import describe_device
    from cuopt_torch.utils.timer import Timer

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    inst = synth_gh_instance(a.orders, "RC", seed=7)
    prob = build_problem(inst.to_data_model())

    def total_cost(routes):
        return sum(prob.route_cost(v, r) for v, r in routes.items() if r)

    t0 = time.perf_counter()
    lsp = ls.build_ls_problem(prob, device=a.device)
    prob._lsp_cache = lsp
    build_s = time.perf_counter() - t0

    r0 = ls.readbacks
    t0 = time.perf_counter()
    routes, unassigned = batched_construction(prob, lsp)
    cons_s = time.perf_counter() - t0
    cons_rounds = ls.readbacks - r0  # one readback a construction round
    cost0 = total_cost(routes)
    n_routes = sum(1 for r in routes.values() if r)
    print(f"construction: {cons_s:.2f} s in {cons_rounds} rounds, cost "
          f"{cost0:.1f}, routes {n_routes}, unassigned {len(unassigned)}",
          flush=True)

    def one_round(routes):
        stats = {}
        t0 = time.perf_counter()
        new = _local_search(prob, lsp, routes, Timer(3600.0), max_rounds=1,
                            round_stats=stats)
        return new, time.perf_counter() - t0, stats

    routes, first_s, _ = one_round(routes)
    rounds = []
    for _ in range(a.ls_rounds):
        new, wall, stats = one_round(routes)
        rounds.append({"wall_ms": round(1e3 * wall, 3),
                       "eval_ms": round(1e3 * stats.get("eval_s", 0.0), 3),
                       "eval_device_ms": (round(stats["eval_device_ms"], 3)
                                          if "eval_device_ms" in stats
                                          else None)})
        changed = new != routes
        routes = new
        if not changed:
            break
    cost1 = total_cost(routes)
    walls = [r["wall_ms"] for r in rounds]
    print(f"LS: first round {first_s:.2f} s, {len(rounds)} rounds, median "
          f"{statistics.median(walls) if walls else 0:.1f} ms a round, cost "
          f"{cost0:.1f} -> {cost1:.1f}", flush=True)

    seen = [o for r in routes.values() for o in r]
    host_ok = (len(seen) == len(set(seen))
               and len(seen) + len(unassigned) == prob.n_serve
               and all(prob.route_feasible(v, r)
                       for v, r in routes.items() if r))
    dev_ms = [r["eval_device_ms"] for r in rounds
              if r["eval_device_ms"] is not None]
    out = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "per_call_sync_floor_s": round(sync_floor(a.device), 6),
        "orders": a.orders,
        "fleet": int(prob.n_fleet),
        "ls_problem_build_s": round(build_s, 3),
        "construction_s": round(cons_s, 3),
        "construction_rounds": cons_rounds,
        "construction_cost": round(cost0, 2),
        "routes_used": n_routes,
        "unassigned": len(unassigned),
        "ls_first_round_s": round(first_s, 3),
        "ls_rounds_timed": len(rounds),
        "ls_ms_per_round": (round(statistics.median(walls), 3)
                            if walls else None),
        "ls_device_ms_per_round": (round(statistics.median(dev_ms), 3)
                                   if dev_ms else None),
        "rounds": rounds,
        "cost_after_ls": round(cost1, 2),
        "improvement_pct": round(100 * (cost0 - cost1) / max(cost0, 1e-9),
                                 2),
        "host_ok": host_ok,
    }
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if host_ok else 1


if __name__ == "__main__":
    sys.exit(main())
