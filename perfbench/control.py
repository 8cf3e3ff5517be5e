#!/usr/bin/env python3
"""Readings for the correctness limit: the program against its control.

    python3 perfbench/control.py --workload stair50k.ordered \
        --seeds 11,12,13 --requests 3

For each seed, the cell's first `requests` LPs (the very LPs a run with
that seed sends) are solved through the cell's driver on the card, and
each answer's worst share of the tolerance is read by the reference
(`perfbench.reference.kkt`):

  program   the answer as the program gives it (a lower reading)
  own       the program's own float32 reading of the same criteria
  matrix    the control: the program solving the LP with every nonzero
            rounded to bfloat16, judged against the LP as it is
  answer    the control: the program's x and y rounded to bfloat16

Prints one JSON line per LP and a summary line last. Needs the card;
tests/test_perfbench_control.py runs `readings` on the CPU at a small
size.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(v):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(v, np.float64)).to(
        torch.bfloat16).to(torch.float64).numpy()


def own_share(lp, raw, eps):
    """The program's own float32 reading, from its reported residuals."""
    import numpy as np

    b = np.maximum(np.abs(np.where(np.isfinite(lp["lc"]), lp["lc"], 0.0)),
                   np.abs(np.where(np.isfinite(lp["uc"]), lp["uc"], 0.0)))
    p, d = abs(raw["primal_objective"]), abs(raw["dual_objective"])
    return max(
        raw["l2_primal_residual"] / (eps + eps * np.linalg.norm(b)),
        raw["l2_dual_residual"] / (eps + eps * np.linalg.norm(lp["c"])),
        raw["gap"] / (eps + eps * (p + d)))


def readings(drv, seed, requests):
    from perfbench.reference import kkt

    for i in range(requests):
        req = drv.make(seed, i)
        lp = req["lp"]
        t = time.perf_counter()
        a = drv.call(req)
        wall = time.perf_counter() - t
        row = {"seed": seed, "request": i, "status": a["status"],
               "steps": a["raw"].get("iterations"), "wall": wall,
               "program": drv.share(lp, a),
               "own": own_share(lp, a["raw"], drv.eps)}
        m = drv.call(drv.request(dict(lp, values=bf16(lp["values"]))))
        row["matrix_status"] = m["status"]
        row["matrix"] = kkt.worst(kkt.shares(lp, m["x"], m["y"],
                                             m["objective"], drv.eps))
        row["answer"] = kkt.worst(kkt.shares(lp, bf16(a["x"]), bf16(a["y"]),
                                             a["objective"], drv.eps))
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=3)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_json(ROOT, "BENCHMARK.json"), a.workload)
    drv = harness.driver(c)
    drv.setup(0)
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        for row in readings(drv, seed, a.requests):
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": a.workload, "lps": len(rows),
        "program_max": max(r["program"] for r in rows),
        "own_gap_max": max(r["program"] - r["own"] for r in rows),
        "matrix_min": min(r["matrix"] for r in rows),
        "answer_min": min(r["answer"] for r in rows),
        "limit": drv.kkt_limit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
