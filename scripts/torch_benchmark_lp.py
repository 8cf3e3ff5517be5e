#!/usr/bin/env python3
"""MPS-file LP/MIP benchmark runner for cuopt_torch, on the card.

    python scripts/torch_benchmark_lp.py --dir DIR [--glob '*.mps']
    python scripts/torch_benchmark_lp.py --dir DIR --device cpu

cuopt_torch's counterpart of scripts/benchmark_lp.py: every .mps under
--dir (files named bad-* or *infeas* are skipped) is read by the port's
parser (the native C++ one) and solved by solve_lp (LPs, at --tolerance,
method Concurrent unless --method says otherwise) or solve_mip (MIPs), each
with --time-limit seconds. One JSON line per instance, then the summary
(solved, geomean solve seconds of the OPTIMAL ones) as the last line;
--out writes the summary with every result. There is no default
directory: the Mittelmann set is a download and the reference's default
datasets are not part of the repo, so the reference's dataset default is
not ported.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def solve_one(path, time_limit, tol, method, device):
    """Parse and solve one MPS file; a dict of what came out."""
    from cuopt_torch.io.mps_parser import parse_mps
    from cuopt_torch.lp.settings import MIPSolverSettings, PDLPSolverSettings
    from cuopt_torch.utils.errors import MpsParseError

    t0 = time.time()
    try:
        prob = parse_mps(path)
    except MpsParseError as exc:
        return {"instance": os.path.basename(path),
                "status": "parse_error", "error": str(exc)}
    is_mip = bool((prob.variable_types == "I").any())
    if is_mip:
        from cuopt_torch.mip.solve import solve_mip

        s = MIPSolverSettings()
        s.time_limit = time_limit
        s.log_to_console = False
        sol = solve_mip(prob, s, device=device)
    else:
        from cuopt_torch.lp.solve import solve_lp

        s = PDLPSolverSettings()
        s.time_limit = time_limit
        s.log_to_console = False
        s.set_optimality_tolerance(tol)
        if method is not None:
            s.method = method
        sol = solve_lp(prob, s, device=device)
    out = {
        "instance": os.path.basename(path),
        "rows": prob.n_constraints, "cols": prob.n_variables,
        "nnz": prob.nnz, "mip": is_mip,
        "status": int(sol.get_termination_status()),
        "objective": float(sol.get_primal_objective()),
        "solve_s": round(time.time() - t0, 2),
    }
    raw = sol._raw
    if raw.get("compile_s") is not None:
        # build and first major apart from the loop
        out["compile_s"] = raw["compile_s"]
        out["solve_loop_s"] = raw.get("solve_loop_s")
    if raw.get("solved_by") is not None:
        out["solved_by"] = raw["solved_by"]
    if is_mip:
        out["solution_bound"] = float(sol.get_solution_bound())
        out["mip_gap"] = float(sol.get_mip_gap())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--glob", default="*.mps")
    ap.add_argument("--time-limit", type=float, default=3600.0,
                    help="per instance (reference protocol: 3600 s)")
    ap.add_argument("--tolerance", type=float, default=1e-4)
    ap.add_argument("--method", type=int, default=None,
                    help="CUOPT_METHOD_* override")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuopt_torch import constants as C
    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    if card["smi"]:
        print(card["smi"], flush=True)
    files = [f for f in sorted(glob.glob(os.path.join(a.dir, a.glob)))
             if "bad-" not in os.path.basename(f)
             and "infeas" not in os.path.basename(f)]
    results = []
    for f in files:
        r = solve_one(f, a.time_limit, a.tolerance, a.method, a.device)
        results.append(r)
        print(json.dumps(r), flush=True)
    ok = [r for r in results
          if r.get("status") == C.CUOPT_TERIMINATION_STATUS_OPTIMAL]
    times = [max(r["solve_s"], 1e-3) for r in ok]
    summary = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "instances": len(results),
        "solved_optimal": len(ok),
        "geomean_solve_s": round(
            math.exp(sum(math.log(t) for t in times) / len(times)), 3
        ) if times else None,
    }
    if a.out:
        with open(a.out, "w") as f:
            json.dump({**summary, "results": results}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
