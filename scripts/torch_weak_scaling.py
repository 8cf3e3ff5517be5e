#!/usr/bin/env python3
"""Weak-scaling harness for cuopt_torch's sharded PDLP.

    python scripts/torch_weak_scaling.py                # one shard per card
    python scripts/torch_weak_scaling.py --virtual 4    # 4 shards on cuda:0
    python scripts/torch_weak_scaling.py --device cpu --virtual 4 \\
        --rows-per-dev 1024 --majors 2

cuopt_torch's counterpart of scripts/weak_scaling.py: PDLP majors in
float32 on generate_lp(D * rows-per-dev, same, 8, seed=123, band) on the
block-band operator, sharded over D = 1, 2, 4, ... shards (constant work
per shard), after one warm major; steps/s and the efficiency against
D = 1. Without --virtual the shards are the cards, one each (D up to the
card count); --virtual N puts up to N shards on --device (cuda:0 by
default), which checks the sharded path, not scaling: the shards share
one card's bandwidth and one interpreter lock. The mesh takes its devices
explicitly, so nothing is re-executed. The sharded step runs the plain
products (no row-pass kernel), as cuopt_tpu's does under a mesh.

For each D the timed majors' collectives per shard and bytes sent by
all shards, as their ShardComm counts them, per step attempt (the
reference's HLO collective model is JAX's alone and is not ported). One
JSON line per D, the table last; --out writes it to a file.
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
    ap.add_argument("--virtual", type=int, default=0,
                    help="N shards on --device (validation only)")
    ap.add_argument("--rows-per-dev", type=int, default=8192)
    ap.add_argument("--band", type=int, default=256)
    ap.add_argument("--majors", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from cuopt_torch.lp.hyper_params import PRESETS
    from cuopt_torch.lp.pdlp import (
        StaticCfg,
        build_device_problem,
        initial_state,
        make_major_fn,
    )
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.parallel import make_mesh, shard_problem_and_state
    from cuopt_torch.problem.synthetic import generate_lp
    from cuopt_torch.utils.device import describe_device

    home = torch.device(a.device)
    cuda = home.type == "cuda"
    if cuda and home.index is None:
        home = torch.device("cuda:0")
    card = describe_device(home)
    if card["smi"]:
        print(card["smi"], flush=True)
    if a.virtual:
        n_avail = a.virtual
    elif cuda:
        n_avail = torch.cuda.device_count()
    else:
        n_avail = 1
    settings = PDLPSolverSettings()
    hp = PRESETS[settings.pdlp_solver_mode]
    t = settings.tolerances
    cfg = StaticCfg(
        hp=hp,
        abs_primal=t.absolute_primal_tolerance,
        rel_primal=t.relative_primal_tolerance,
        abs_dual=t.absolute_dual_tolerance,
        rel_dual=t.relative_dual_tolerance,
        abs_gap=t.absolute_gap_tolerance,
        rel_gap=t.relative_gap_tolerance,
        fused_kernel="off",
    )
    fn = make_major_fn(cfg)

    counts = []
    nd = 1
    while nd <= n_avail:
        counts.append(nd)
        nd *= 2
    table = []
    for nd in counts:
        n_rows = a.rows_per_dev * nd
        prob = generate_lp(n_rows, n_rows, 8, seed=123, band=a.band)
        dev = build_device_problem(prob, hp, torch.float32, "blockband",
                                   home)
        state = initial_state(dev, hp, torch.float32)
        mesh = (make_mesh(devices=[home] * nd) if a.virtual or not cuda
                else make_mesh(nd))
        dev, state = shard_problem_and_state(dev, state, mesh)
        state, report = fn(dev, state)  # warm
        steps0 = int(report["total_steps"])
        attempts0 = int(report["total_attempts"])
        collectives = bytes_sent = 0
        t0 = time.perf_counter()
        for _ in range(a.majors):
            state, report = fn(dev, state)
            collectives += report["collectives"]
            bytes_sent += report["bytes_sent"]
        steps = int(report["total_steps"]) - steps0  # waits for the shards
        dt = time.perf_counter() - t0
        attempts = int(report["total_attempts"]) - attempts0
        rate = steps / dt
        row = {
            "devices": nd,
            "mesh": [str(d) for d in mesh.devices],
            "rows": n_rows,
            "iters_per_s": round(rate, 2),
            "weak_scaling_efficiency": round(
                rate / table[0]["iters_per_s"] if table else 1.0, 4),
            "steps": steps,
            "attempts": attempts,
            "collectives_per_attempt_per_shard": round(
                collectives / attempts / nd, 3),
            "bytes_per_attempt": round(bytes_sent / attempts, 1),
        }
        table.append(row)
        print(json.dumps(row), flush=True)
    art = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "virtual": bool(a.virtual),
        "kind": "validation" if a.virtual else "scaling",
        "rows_per_device": a.rows_per_dev,
        "majors": a.majors,
        "table": table,
    }
    line = json.dumps(art)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
