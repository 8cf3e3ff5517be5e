#!/usr/bin/env python3
"""The float32 control of a float64 cell: the check at the cell's
tolerance tells the configuration's precision from float32.

    python3 perfbench/control_f32.py --workload stair50k.f64 \
        --seeds 11,12 --requests 3

For each seed, the cell's first `requests` LPs (the very LPs a run with
that seed sends) are solved twice through the cell's driver class on the
card: as the configuration states (float64), and with the solver's
dtype set to float32 here, everything else the same. The reference
(`perfbench.reference.kkt`) reads each answer's worst share of the
tolerance:

  f64   the configuration's answer: within the limit
  f32   the float32 control: over the limit, or not Optimal

Prints one JSON line per LP and a summary line last. A run's check
takes the worst share over its window's answers, so the summary gives,
for each seed, the worst of its float64 and of its float32 answers: what
`kkt_worst` reads in a window of those requests. Needs the card;
tests/test_torch_f64_pair.py runs `readings` on the CPU at a small size.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def float32_config(config: dict) -> dict:
    """The configuration with its solver in float32, nothing else
    changed."""
    c = copy.deepcopy(config)
    c["solver"]["dtype"] = "float32"
    return c


def readings(drv64, drv32, seed, requests, first=0):
    """One row per LP, requests `first` to `first + requests - 1`: each
    answer's status, steps, wall and the reference's share, for the
    float64 driver and the float32 one."""
    for i in range(first, first + requests):
        lp = drv64.lp(seed, i)
        row = {"seed": seed, "request": i}
        for tag, drv in (("f64", drv64), ("f32", drv32)):
            t = time.perf_counter()
            a = drv.call(drv.request(lp))
            row[f"{tag}_wall"] = time.perf_counter() - t
            row[f"{tag}_status"] = a["status"]
            row[f"{tag}_steps"] = a["raw"].get("iterations")
            row[tag] = drv.share(lp, a)
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
        print("control_f32: no CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_json(ROOT, "BENCHMARK.json"), a.workload)
    drv64 = harness.driver(c)
    drv32 = harness.driver(dict(c, config=float32_config(c["config"])))
    drv64.setup(0)
    drv32.setup(0)
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        for row in readings(drv64, drv32, seed, a.requests):
            rows.append(row)
            print(json.dumps(row), flush=True)
    limit = drv64.kkt_limit
    seeds = sorted({r["seed"] for r in rows})
    print(json.dumps({
        "workload": a.workload, "lps": len(rows), "limit": limit,
        "f64_max": max(r["f64"] for r in rows),
        "f64_all_optimal": all(r["f64_status"] == "Optimal" for r in rows),
        "f32_min": min(r["f32"] for r in rows),
        "f32_caught": sum(r["f32"] > limit or r["f32_status"] != "Optimal"
                          for r in rows),
        "worst_by_seed": {s: {tag: max(r[tag] for r in rows
                                       if r["seed"] == s)
                              for tag in ("f64", "f32")} for s in seeds}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
